"""Bonded/topological force terms: chain bonds, loops, nucleolar bonds.

These act on O(N) index arrays, not the O(N*nbr) neighbor loop, so they are
cheap; clarity over micro-optimization.  Bending triples, point sources and
kinetochore fibres belong to the mitotic stages and are not ported yet.

Force convention: each helper returns ``(forces, energy)`` where ``forces``
has shape (N, 3) and accumulates -grad(U).
"""

from __future__ import annotations

import numpy as np
import torch


def pair_bond_forces(positions, pairs, energy_fn, coeff_fn):
    """Generic bonded-pairwise force over (B, 2) index pairs.

    ``energy_fn(r2) -> (B,)`` and ``coeff_fn(r2) -> (B,)`` may close over
    per-bond parameters (the reference mixes spring constants per bonded pair,
    simulation_driver_forcefield.cpp:61-96).
    """
    forces = torch.zeros_like(positions)
    if pairs.shape[0] == 0:
        return forces, positions.new_zeros(())
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    dx = positions[i] - positions[j]
    r2 = torch.sum(dx * dx, dim=-1)
    energy = torch.sum(energy_fn(r2))
    f = coeff_fn(r2)[:, None] * dx
    forces.index_add_(0, i, f)
    forces.index_add_(0, j, -f)
    return forces, energy


def shift_bond_forces(positions, offset, mask, energy_fn, coeff_fn):
    """Bonded-pairwise force for UNIFORM-OFFSET bonds (i, i + offset).

    Chain bonds are (i, i+1) and intra-TAD loops (i, i+2) by construction,
    so the gather/scatter of :func:`pair_bond_forces` collapses into two
    rolls — coalesced vector passes with no atomics.

    ``mask`` is (N,) bool: True where row i owns a bond to i + offset
    (False at chain tails, which also kills the rows whose roll wraps
    around); ``energy_fn``/``coeff_fn`` close over (N,)-row-aligned per-bond
    parameters.
    """
    dx = positions - torch.roll(positions, -offset, dims=0)
    r2 = torch.sum(dx * dx, dim=-1)
    u = energy_fn(r2)
    energy = torch.sum(torch.where(mask, u, torch.zeros_like(u)))
    c = coeff_fn(r2)
    c = torch.where(mask, c, torch.zeros_like(c))
    f = c[:, None] * dx
    forces = f - torch.roll(f, offset, dims=0)
    return forces, energy


def chain_bond_pairs(chains) -> np.ndarray:
    """(B, 2) consecutive-bead pairs for a list of ChainAssignment ranges
    (md::make_bonded_pairwise_forcefield().add_bonded_range)."""
    pairs = []
    for chain in chains:
        idx = np.arange(chain.start, chain.end - 1)
        pairs.append(np.stack([idx, idx + 1], axis=1))
    if not pairs:
        return np.zeros((0, 2), dtype=np.int32)
    return np.concatenate(pairs).astype(np.int32)


def loop_bond_pairs(chains) -> np.ndarray:
    """(B, 2) second-neighbor (i, i+2) pairs within each chain — the mean-field
    intra-TAD loops (simulation_driver_forcefield.cpp:131-135)."""
    pairs = []
    for chain in chains:
        idx = np.arange(chain.start, max(chain.end - 2, chain.start))
        pairs.append(np.stack([idx, idx + 2], axis=1))
    if not pairs:
        return np.zeros((0, 2), dtype=np.int32)
    return np.concatenate(pairs).astype(np.int32)
