"""Runs of several systems at once (the ensemble of replicas on one device)."""
