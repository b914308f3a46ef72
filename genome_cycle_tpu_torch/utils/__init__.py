"""Utilities: logging, splines."""
