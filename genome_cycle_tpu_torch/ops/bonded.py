"""Bonded/topological force terms: chain bonds, loops, nucleolar bonds,
bending triples, point sources, kinetochore fibers.

These act on O(N) index arrays, not the O(N*nbr) neighbor loop, so they are
cheap; clarity over micro-optimization.  The mitotic stages take hundreds of
thousands of steps on a few hundred beads, where every small launch counts:
their helpers skip the energy unless it is asked for and build no autograd
graph.

Force convention: each helper returns ``(forces, energy)`` where ``forces``
has shape (N, 3) and accumulates -grad(U).  The interphase helpers
(:func:`pair_bond_forces`, :func:`shift_bond_forces`) also take positions
(R, N, 3) of R replicas of one topology: bonds index within a replica, and
the energy is summed over all of them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import potentials


def pair_bond_forces(positions, pairs, energy_fn, coeff_fn):
    """Generic bonded-pairwise force over (B, 2) index pairs.

    ``energy_fn(r2) -> (B,)`` and ``coeff_fn(r2) -> (B,)`` may close over
    per-bond parameters (the reference mixes spring constants per bonded pair,
    simulation_driver_forcefield.cpp:61-96).  With ``energy_fn=None`` the
    energy is not evaluated and comes back as 0.
    """
    forces = torch.zeros_like(positions)
    if pairs.shape[0] == 0:
        return forces, positions.new_zeros(())
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    dx = positions[..., i, :] - positions[..., j, :]
    r2 = torch.sum(dx * dx, dim=-1)
    energy = positions.new_zeros(()) if energy_fn is None else torch.sum(energy_fn(r2))
    f = coeff_fn(r2)[..., None] * dx
    forces.index_add_(-2, i, f)
    forces.index_add_(-2, j, -f)
    return forces, energy


def shift_bond_forces(positions, offset, mask, energy_fn, coeff_fn):
    """Bonded-pairwise force for UNIFORM-OFFSET bonds (i, i + offset).

    Chain bonds are (i, i+1) and intra-TAD loops (i, i+2) by construction,
    so the gather/scatter of :func:`pair_bond_forces` collapses into two
    rolls — coalesced vector passes with no atomics.

    ``mask`` is (N,) bool: True where row i owns a bond to i + offset
    (False at chain tails, which also kills the rows whose roll wraps
    around); ``energy_fn``/``coeff_fn`` close over (N,)-row-aligned per-bond
    parameters.  The rolls run along the bead axis, so replicas of (R, N, 3)
    positions never exchange a bond.
    """
    dx = positions - torch.roll(positions, -offset, dims=-2)
    r2 = torch.sum(dx * dx, dim=-1)
    u = energy_fn(r2)
    energy = torch.sum(torch.where(mask, u, torch.zeros_like(u)))
    c = coeff_fn(r2)
    c = torch.where(mask, c, torch.zeros_like(c))
    f = c[..., None] * dx
    forces = f - torch.roll(f, offset, dims=-2)
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


def bending_triples(chains, penalize_centromere: bool = False) -> np.ndarray:
    """(T, 3) consecutive triples per chain.  Unless ``penalize_centromere``,
    ranges are split at the kinetochore bead so no triple crosses it
    (stage_anatelophase/simulation_driver.cpp:125-132)."""
    triples = []

    def add_range(start, end):
        if end - start >= 3:
            idx = np.arange(start, end - 2)
            triples.append(np.stack([idx, idx + 1, idx + 2], axis=1))

    for chain in chains:
        if penalize_centromere or chain.kinetochore is None:
            add_range(chain.start, chain.end)
        else:
            add_range(chain.start, chain.kinetochore)
            add_range(chain.kinetochore + 1, chain.end)
    if not triples:
        return np.zeros((0, 3), dtype=np.int32)
    return np.concatenate(triples).astype(np.int32)


def _triple_bonds(positions, triples):
    i, j, k = (triples[:, c].long() for c in range(3))
    return i, j, k, positions[j] - positions[i], positions[k] - positions[j]


def bending_forces(positions, triples, bending_energy, with_energy=True):
    """Cosine bending over (T, 3) triples, u = e (1 - a.b / |a||b|) with
    a = x[j] - x[i], b = x[k] - x[j]; the force in closed form.

    The norm product is clamped as in :func:`potentials.cosine_bending_energy`,
    |a||b| = sqrt(max(|a|^2 |b|^2, 1e-30)).  Under the clamp the norm is a
    constant, so its derivative drops out; a triple with two coincident beads
    thus gets the same finite force as differentiating the clamped energy
    gives (:func:`bending_forces_autograd`).
    """
    forces = torch.zeros_like(positions)
    if triples.shape[0] == 0:
        return forces, positions.new_zeros(())
    i, j, k, a, b = _triple_bonds(positions, triples)
    a2 = torch.sum(a * a, dim=-1)
    b2 = torch.sum(b * b, dim=-1)
    dot = torch.sum(a * b, dim=-1)
    product = a2 * b2
    clamped = torch.clamp(product, min=1e-30)
    scale = bending_energy * torch.rsqrt(clamped)           # e / (|a||b|)
    # d(|a||b|)/da = |b|^2 a / (|a||b|) where the clamp is not active, else 0.
    q = torch.where(product > 1e-30, dot / clamped, torch.zeros_like(dot))
    # -dU/da and -dU/db.
    ga = scale[:, None] * (b - (q * b2)[:, None] * a)
    gb = scale[:, None] * (a - (q * a2)[:, None] * b)
    forces.index_add_(0, i, -ga)
    forces.index_add_(0, j, ga - gb)
    forces.index_add_(0, k, gb)
    if not with_energy:
        return forces, positions.new_zeros(())
    return forces, torch.sum(bending_energy - scale * dot)


def bending_forces_autograd(positions, triples, bending_energy):
    """:func:`bending_forces` by differentiating the energy: exactly
    F = -grad U.  The yardstick of the closed form in the tests; the stages do
    not call it (a graph built and torn down every step)."""
    if triples.shape[0] == 0:
        return torch.zeros_like(positions), positions.new_zeros(())
    with torch.enable_grad():
        pos = positions.detach().requires_grad_(True)
        _, _, _, a, b = _triple_bonds(pos, triples)
        energy = torch.sum(potentials.cosine_bending_energy(a, b, bending_energy))
        (grad,) = torch.autograd.grad(energy, pos)
    return -grad, energy.detach()


def point_source_forces(positions, source, energy_fn, coeff_fn, targets=None):
    """md::make_point_source_forcefield: radial interaction of every particle
    (or ``targets`` subset) with a fixed point.  ``source`` is (3,), or (S, 3)
    for S sources of one potential, whose forces and energies add up.  With
    ``energy_fn=None`` the energy is not evaluated and comes back as 0."""
    pos = positions if targets is None else positions[targets.long()]
    source = torch.as_tensor(source, dtype=positions.dtype, device=positions.device)
    several = source.dim() == 2
    dx = pos[None, :, :] - source[:, None, :] if several else pos - source
    r2 = torch.sum(dx * dx, dim=-1)
    energy = positions.new_zeros(()) if energy_fn is None else torch.sum(energy_fn(r2))
    f = coeff_fn(r2)[..., None] * dx
    if several:
        f = torch.sum(f, dim=0)
    if targets is not None:
        return torch.zeros_like(positions).index_add_(0, targets.long(), f), energy
    return f, energy


def kfiber_forces(positions, kinetochores, pole, spring_constants, lengths,
                  with_energy=True):
    """Kinetochore-fiber dragging: effective spring of each kinetochore bead
    toward a spindle pole, K = decay_rate / mobility, b = stationary_length
    (common/forcefield/kinetochore_fiber_forcefield.cpp:23-53).  ``pole`` is
    (3,), or (C, 3) with a pole for each kinetochore (two fields in one call).
    Kinetochore indices must not repeat."""
    kinetochores = kinetochores.long()
    dx = positions[kinetochores] - torch.as_tensor(
        pole, dtype=positions.dtype, device=positions.device
    )
    r2 = torch.sum(dx * dx, dim=-1)
    coeff = potentials.spring_force_coeff(r2, spring_constants, lengths)
    forces = torch.zeros_like(positions).index_add_(0, kinetochores, coeff[:, None] * dx)
    if not with_energy:
        return forces, positions.new_zeros(())
    return forces, torch.sum(potentials.spring_energy(r2, spring_constants, lengths))
