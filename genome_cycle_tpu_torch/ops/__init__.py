"""Compute primitives: potentials, forces, pair-force kernel, integrator, contacts."""
