"""Replicated positions, sharded pair work: the simpler of the two spatial
decompositions, one process per rank.

Counterpart of the JAX package's ``parallel/sharded.py``.  Every rank of a
replica's ``beads`` group holds all N positions.  Each step every rank builds
the same cell layout of all of them and owns a *home range* of its sorted
order, an equal share of the rows: the pair kernel computes the force of
those beads only (``ops/pair_kernels.ab_pair_forces(begin=, end=)``), the
rank adds their bonded terms (computed for all beads, redundantly: O(N)) and
wall forces, moves them, and the ranks all-gather ``(ids, positions)`` in
chunks of equal size (N padded to a multiple of the shard count).  The wall
reaction is summed over the ranks; noise is the single run's, every rank
drawing the full (N, 3) normal from the replica's generator and taking its
rows, so the result follows the unsharded run.

Ownership by a range of the sorted order, not by a block of bead ids, is what
lets the cell-range kernel skip the other ranks' beads: a home range is a run
of whole cells.  The carry holds the rank's contact window: at a tick every
rank lists the pairs whose lower sorted index lies in its home range
(``ops/contact.contact_events(begin=, end=)``), so each pair is counted once
over the ranks.  (The JAX carry holds (N, C) contact lists instead.)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.contact import contact_events
from ..ops.integrator import BDParams, bd_update
from ..ops.pair_kernels import ab_pair_forces
from ..ops.wall import wall_forces
from . import mesh as mesh_ops


class ShardedCarry(NamedTuple):
    positions: torch.Tensor     # (N, 3), the same on every rank of the replica
    generator: torch.Generator  # the replica's, in the same state on every rank
    semiaxes: torch.Tensor      # (3,)
    window: object              # this rank's WindowAccumulator


def home_range(n: int, mesh) -> tuple:
    """``[begin, end)`` of this rank's share of a sorted order of ``n`` rows
    padded to a multiple of the shard count."""
    rows = -(-n // mesh.n_bead_shards)
    begin = mesh.shard * rows
    return begin, min(begin + rows, n), rows


def init_sharded_carry(model, mesh, positions, seeds, semiaxes, acc_capacity=None) -> ShardedCarry:
    """The carry of this rank's replica from the host arrays of all
    replicas: ``positions`` (R, N, 3), ``seeds`` (R,), ``semiaxes`` (R, 3);
    the replica's generator is seeded as its single run's."""
    from ..models.interphase import WindowAccumulator

    r = mesh.replica
    device = mesh.device
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seeds[r]))
    return ShardedCarry(
        positions=torch.as_tensor(np.asarray(positions)[r], dtype=model.dtype, device=device),
        generator=generator,
        semiaxes=torch.as_tensor(np.asarray(semiaxes)[r], dtype=model.dtype, device=device),
        window=WindowAccumulator(model.n, acc_capacity, device, lambda m: None),
    )


def sharded_step_forces(model, mesh, x: torch.Tensor, semiaxes: torch.Tensor, step: int):
    """The forces of G1 step ``step`` on this rank's home beads at positions
    ``x`` (N, 3), as the single run's ``_assemble_forces`` at the step's
    lagged scales: (home bead ids in sorted order, pair + bonded + wall
    force on them, the wall reaction summed over the replica's ranks)."""
    begin, end, _ = home_range(model.n, mesh)
    core, bond = model.scales((step - 1) * model.config.timestep)
    layout = model.cell_layout(x)
    home = layout.order[begin:end]
    pair = ab_pair_forces(layout, model.pair_kernel_params(core), begin=begin, end=end)[0]
    bonded = model.bonded_forces(x, bond)[0]
    wall, reaction, _ = wall_forces(x[home], semiaxes, model.wall_a[home], model.wall_b[home],
                                    model._wall_params(core))
    return home, pair[home] + bonded[home] + wall, mesh_ops.all_reduce(reaction, mesh)


def make_sharded_interphase_step(model, mesh):
    """(carry, step) -> carry: one G1 step of the replica (the single run's
    ``_bd_step4``, then its tick at the tick steps)."""
    c = model.config
    dt = c.timestep
    n = model.n
    begin, end, rows = home_range(n, mesh)
    params = BDParams(c.temperature, dt)

    def step_fn(carry: ShardedCarry, step: int) -> ShardedCarry:
        x, generator, semiaxes, window = carry
        home, force, reaction = sharded_step_forces(model, mesh, x, semiaxes, step)
        noise = torch.randn((n, 3), dtype=x.dtype, device=x.device, generator=generator)[home]
        moved = bd_update(x[home], force, model.mobility[home], None, params, noise=noise)
        # Equal chunks: the last rank's is padded with rows of id -1.
        mine = x.new_full((rows, 4), -1.0)
        mine[: home.shape[0], :3] = moved
        mine[: home.shape[0], 3] = home.to(x.dtype)
        new_x = x.new_empty((n + 1, 3))           # row n takes the padding
        for part in mesh_ops.all_gather(mine, mesh):
            ids = part[:, 3].to(torch.int64)
            new_x[torch.where(ids >= 0, ids, n)] = part[:, :3]
        new_x = new_x[:n]
        semiaxes = semiaxes + dt * c.wall_mobility * (reaction - model.wall_spring * semiaxes)
        if step % c.contactmap_update_interval == 0:
            core_now, _ = model.scales(step * dt)
            window.add(contact_events(model.cell_layout(new_x), c.contactmap_distance * core_now,
                                      begin, end))
        return ShardedCarry(new_x, generator, semiaxes, window)

    return step_fn


def make_sharded_chunk(model, mesh, chunk_steps: int):
    """(carry, start) -> carry: steps ``start + 1`` to ``start + chunk_steps``."""
    single = make_sharded_interphase_step(model, mesh)

    def chunk(carry: ShardedCarry, start: int) -> ShardedCarry:
        for step in range(start + 1, start + chunk_steps + 1):
            carry = single(carry, step)
        return carry

    return chunk
