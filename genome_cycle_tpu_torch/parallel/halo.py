"""Spatial decomposition of one nucleus: x-slab ownership with a one-band
halo exchange, one process per rank.

Counterpart of the JAX package's ``parallel/halo.py``.  Each rank of a
replica's ``beads`` group owns the beads inside its x-slab of
[-bound, bound].  Every step it sends the owned beads within ``halo_width``
of its slab faces to its two neighbours (``mesh.exchange_bands``), so a step's
traffic is O(surface), and works on its own beads plus the two bands it
received (the local set):

- pair force: the hand-written kernel ``csrc/ab_pair_forces.cu`` on a cell
  layout of the local set (``ops/pair_kernels.build_cell_layout(valid=)``: the
  band buffers have a fixed capacity, their padded rows take part in
  nothing); the forces of the own rows are kept;
- bonded terms: the local set is scattered into an (N, 3) scratch that holds
  the chunk's starting positions elsewhere, the port's own
  ``InterphaseModel.bonded_forces`` runs on it and the own rows are kept.  An
  owned bead whose chain, loop or nucleolar partner is not in the local set
  is a *bond miss*: its force is wrong (never huge, since the partner's stale
  position is a real one), and the chunk is run again with a wider halo;
- nucleolar droplet: the positions of the nucleolar targets are assembled
  with one ``all_reduce`` (each is owned by one rank), in the same message as
  the rank's share of the wall reaction;
- wall on the own rows, its reaction summed over the ranks; then the BD
  update and the wall ODE, identical on every rank;
- noise: every rank draws the full (N, 3) standard normal from its replica's
  generator, seeded as the single run seeds it, and takes the rows of its own
  beads.  Every rank holds the same generator state (a chunk's retry restores
  it everywhere), and a sharded run draws the very numbers of the unsharded
  one: its trajectory depends neither on the shard count nor, beyond float32
  rounding of sums taken in another order, on being sharded at all;
- contacts: the port's fresh search at every tick, on the local layout; a
  rank keeps the pairs whose lower global id it owns, so each pair is counted
  once over all ranks, into the rank's own device-resident window.  At a
  dump only the deduplicated rank windows travel, to the replica's first
  rank, which merges them.

Ownership is static within a chunk (``sampling_interval`` steps) and is
re-binned from the gathered positions before every chunk.  A chunk is valid
while every partner of an owned bead lies in the local set, which holds when
``excursion + model.cell <= halo_width`` (``excursion``: how far an owned bead
strays past its slab's faces) and no band overflows its buffer.  The
statistics of a chunk are all-reduced, so every rank of a replica takes the
same decision: band overflow doubles the band capacity; a bond miss or a
breached excursion bound widens the halo; both run the chunk again from its
saved state (positions, semiaxes, generator, window).

Only the replica's first rank touches the store: it runs the relaxation and
frame 0 (``models/interphase.run_interphase``), then sends the start of G1 to
the others, and writes every frame, window and checkpoint.
"""

from __future__ import annotations

import math
import time as _time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.contact import contact_events, merge_window
from ..ops.integrator import BDParams, bd_update
from ..ops.pair_kernels import ab_pair_forces, build_cell_layout
from ..ops.wall import wall_forces
from ..utils.logging import progress_line
from . import mesh as mesh_ops


class HaloGeometry(NamedTuple):
    """Slab and halo layout along x.  The own set of a rank is sized exactly
    at each re-binning, so only the band buffers have a fixed capacity."""

    n_shards: int
    bound: float          # slabs tile [-bound, bound]
    slab_width: float
    halo_width: float
    edge_capacity: int    # rows of a halo band buffer


class HaloStats(NamedTuple):
    """A chunk's validity statistics, reduced over the replica's ranks."""

    band_overflow: int    # beads that did not fit a band buffer (max over steps)
    bond_misses: int      # owned bond ends whose partner was not local (summed)
    excursion: float      # how far an owned bead strayed past its slab's faces


def default_halo_width(model) -> float:
    """The reach of every interaction (one grid cell, ``model.cell``) plus
    how far a bead may stray past its slab between two re-binnings: four
    standard deviations of the most mobile bead's free diffusion over a
    chunk, sqrt(2 mu T dt S) with S = ``sampling_interval`` steps, and at
    least one more cell, for the drift, which moves beads at any
    temperature.  On the production nucleus (mu = T = 1, dt = 1e-5,
    S = 1,000) that is 0.3 + 0.566."""
    c = model.config
    sigma = math.sqrt(2.0 * float(model.mobility.max()) * c.temperature * c.timestep
                      * c.sampling_interval)
    return model.cell + max(model.cell, 4.0 * sigma)


def plan_halo(model, n_shards: int, positions, imbalance: float = 1.6,
              halo_width: Optional[float] = None, edge_capacity: Optional[int] = None) -> HaloGeometry:
    """Slab and band sizes from a structure (N, 3).

    The halo is ``halo_width`` wide, by default :func:`default_halo_width`.
    The band buffers hold ``edge_capacity`` rows, by default the most beads
    found within the halo of an inner slab face, times ``imbalance``,
    rounded up to 32.
    """
    x = np.asarray(positions, dtype=np.float64).reshape(-1, 3)
    bound = float(model.bound)
    slab_w = 2.0 * bound / n_shards
    halo_w = float(halo_width) if halo_width is not None else default_halo_width(model)
    xs = np.clip(x[:, 0], -bound, bound - 1e-6)
    band = 0
    for face in np.arange(1, n_shards) * slab_w - bound:
        band = max(band, int(((xs >= face - halo_w) & (xs < face)).sum()),
                   int(((xs >= face) & (xs < face + halo_w)).sum()))
    if edge_capacity is None:
        edge_capacity = int(math.ceil(max(band, 32) * imbalance / 32) * 32)
    return HaloGeometry(n_shards, bound, slab_w, halo_w, int(edge_capacity))


def bin_to_slabs(geo: HaloGeometry, positions: torch.Tensor) -> torch.Tensor:
    """The slab of every bead (N,) from its x coordinate; beads beyond the
    bound belong to the edge slabs."""
    xs = positions[:, 0].clamp(-geo.bound, geo.bound - 1e-6)
    slab = torch.floor((xs + geo.bound) / geo.slab_width).to(torch.int64)
    return slab.clamp_(0, geo.n_shards - 1)


def _pack_band(rows: torch.Tensor, mask: torch.Tensor, capacity: int):
    """The masked rows packed into a fixed buffer of ``capacity`` rows (the
    rest filled with -1, an id of -1 marking padding), by a cumulative sum of
    the mask and a scatter: no host synchronisation.  Returns the buffer and
    the count of rows that did not fit (a 0-d tensor)."""
    slot = torch.cumsum(mask, 0) - 1
    target = torch.where(mask & (slot < capacity), slot, capacity)
    band = rows.new_full((capacity + 1, rows.shape[1]), -1.0)
    band[target] = rows                     # the rows left out all go to the dropped last row
    overflow = (mask.sum() - capacity).clamp(min=0)
    return band[:capacity], overflow


class HaloRank:
    """One rank's part of a replica between two re-binnings: its own beads,
    the local set (own rows first, then the band from the left, then the one
    from the right), their cell layout, and the chunk's statistics."""

    def __init__(self, model, mesh, geo: HaloGeometry):
        if model.n >= 2 ** 24:
            raise ValueError("bead ids travel as float32 beside the positions: N must be below 2^24")
        self.model, self.mesh, self.geo = model, mesh, geo
        self.slab_lo = -geo.bound + mesh.shard * geo.slab_width
        self.slab_hi = self.slab_lo + geo.slab_width

    # -- ownership ---------------------------------------------------------

    def rebin(self, x: torch.Tensor):
        """Own the beads of this rank's slab in ``x`` (N, 3), the same on
        every rank of the replica, and exchange the first bands."""
        model = self.model
        n = model.n
        self.owned = bin_to_slabs(self.geo, x) == self.mesh.shard
        self.own_ids = torch.nonzero(self.owned).squeeze(1)
        self.own_pos = x[self.own_ids]
        self.mobility = model.mobility[self.own_ids]
        self.wall_a = model.wall_a[self.own_ids]
        self.wall_b = model.wall_b[self.own_ids]
        rows = torch.full((n,), -1, dtype=torch.int64, device=x.device)
        rows[self.own_ids] = torch.arange(self.own_ids.shape[0], device=x.device)
        self.target_rows = rows[model.nuc_targets]
        # Row n is a sink for the local set's padded rows.
        self.scratch = torch.cat([x, x.new_zeros((1, 3))])
        zero = torch.zeros((), device=x.device)
        self.band_overflow = zero.to(torch.int64)
        self.bond_misses = zero.to(torch.int64)
        self.excursion = zero.to(x.dtype)
        self._exchange()

    def _exchange(self):
        """The bands of the current own positions out, the neighbours' in."""
        geo, shard, last = self.geo, self.mesh.shard, self.mesh.n_bead_shards - 1
        own = torch.cat([self.own_pos, self.own_ids[:, None].to(self.own_pos.dtype)], dim=1)
        xs = self.own_pos[:, 0]
        to_left, left_over = _pack_band(own, xs < self.slab_lo + geo.halo_width, geo.edge_capacity)
        to_right, right_over = _pack_band(own, xs >= self.slab_hi - geo.halo_width, geo.edge_capacity)
        from_left, from_right = mesh_ops.exchange_bands(to_left, to_right, self.mesh)
        local = torch.cat([own, from_left, from_right])
        self.local_pos = local[:, :3]
        self.local_ids = local[:, 3].to(torch.int64)
        self.local_valid = self.local_ids >= 0
        self._layout = None
        # Only the bands that are sent, and only the faces that have a
        # neighbour, count.
        over, stray = [self.band_overflow], [self.excursion.reshape(1)]
        if shard > 0:
            over.append(left_over)
            stray.append(torch.clamp(self.slab_lo - xs, min=0))
        if shard < last:
            over.append(right_over)
            stray.append(torch.clamp(xs - self.slab_hi, min=0))
        self.band_overflow = torch.stack(over).max()
        self.excursion = torch.cat(stray).max()

    def layout(self):
        """Cell layout of the local set, built once per exchange."""
        if self._layout is None:
            model = self.model
            ids = self.local_ids.clamp(min=0)
            self._layout = build_cell_layout(
                self.local_pos, model.af[ids], model.bf[ids], model.bound, model.cell,
                valid=self.local_valid,
            )
        return self._layout

    # -- the step ----------------------------------------------------------

    def _bond_misses(self):
        """Owned beads whose chain, loop or nucleolar partner is not in the
        scratch's current rows (a 0-d tensor)."""
        model = self.model
        n = model.n
        present = torch.zeros(n + 1, dtype=torch.bool, device=self.owned.device)
        present[torch.where(self.local_valid, self.local_ids, n)] = True
        present = present[:n]
        present[model.nuc_targets] = True
        miss = torch.zeros_like(self.owned)
        shifts = [(model.bond_mask, 1)]
        if model.use_loops:
            shifts.append((model.loop_mask, 2))
        for mask, k in shifts:
            miss |= mask & ~torch.roll(present, -k)            # partner i + k
            miss |= torch.roll(mask, k) & ~torch.roll(present, k)   # partner i - k
        count = (miss & self.owned).sum()
        if model.nuc_bonds.shape[0]:
            chromatin, target = model.nuc_bonds[:, 0], model.nuc_bonds[:, 1]
            count = count + (self.owned[target] & ~present[chromatin]).sum()
        return count

    def forces(self, semiaxes: torch.Tensor, step: int):
        """The assembled force on the own beads at step ``step``'s lagged
        scales (pair + bonded + wall, as ``_assemble_forces``) and the wall
        reaction summed over the replica's ranks."""
        model = self.model
        n = model.n
        core, bond = model.scales((step - 1) * model.config.timestep)
        b = self.own_ids.shape[0]
        pair = ab_pair_forces(self.layout(), model.pair_kernel_params(core))[0][:b]
        wall, reaction, _ = wall_forces(self.own_pos, semiaxes, self.wall_a, self.wall_b,
                                        model._wall_params(core))
        # The scratch: the local set over the chunk's starting positions, the
        # nucleolar targets from their owners (one all_reduce, the reaction
        # in the same message).
        self.scratch[torch.where(self.local_valid, self.local_ids, n)] = self.local_pos
        targets = model.nuc_targets
        t = targets.shape[0]
        owned = (self.target_rows >= 0)[:, None]
        mine = torch.where(owned, self.own_pos[self.target_rows.clamp(min=0)], 0.0) if b \
            else self.own_pos.new_zeros((t, 3))
        summed = mesh_ops.all_reduce(torch.cat([mine.reshape(-1), reaction.reshape(-1)]), self.mesh)
        self.scratch[targets] = summed[: 3 * t].reshape(t, 3)
        bonded = model.bonded_forces(self.scratch[:n], bond)[0][self.own_ids]
        self.bond_misses = self.bond_misses + self._bond_misses()
        return pair + bonded + wall, summed[3 * t:]

    def step(self, semiaxes: torch.Tensor, generator, step: int) -> torch.Tensor:
        """One G1 step of the own beads (``run_interphase``'s ``_bd_step4``
        on this rank's share); returns the new semiaxes, the same on every
        rank, and exchanges the bands of the new positions."""
        model = self.model
        c = model.config
        dt = c.timestep
        force, reaction = self.forces(semiaxes, step)
        noise = torch.randn((model.n, 3), dtype=self.own_pos.dtype, device=self.own_pos.device,
                            generator=generator)[self.own_ids]
        self.own_pos = bd_update(self.own_pos, force, self.mobility, None,
                                 BDParams(c.temperature, dt), noise=noise)
        self._exchange()
        return semiaxes + dt * c.wall_mobility * (reaction - model.wall_spring * semiaxes)

    def tick(self, step: int, window):
        """Contact events at the current positions: a fresh search on the
        local layout, the pairs whose lower global id this rank owns, folded
        into its window."""
        model = self.model
        core_now, _ = model.scales(step * model.config.timestep)
        events = contact_events(self.layout(), model.config.contactmap_distance * core_now)
        pair = self.local_ids[events[:, :2].to(torch.int64)]
        lo, hi = pair.min(dim=1).values, pair.max(dim=1).values
        keep = self.owned[lo]
        window.add(torch.stack([lo[keep], hi[keep], torch.ones_like(lo[keep])], 1).to(torch.int32))

    def pair_energy(self, core_scale: float) -> torch.Tensor:
        """The pair energy of the own beads at the current positions (their
        halves of each pair), summed over the replica's ranks."""
        _, energies = ab_pair_forces(self.layout(), self.model.pair_kernel_params(core_scale),
                                     per_bead=True)
        return mesh_ops.all_reduce(energies[: self.own_ids.shape[0]].sum().reshape(1), self.mesh)[0]

    def stats(self) -> HaloStats:
        """The chunk's statistics reduced over the replica (one host sync)."""
        local = torch.stack([self.band_overflow.double(), self.bond_misses.double(),
                             self.excursion.double()])
        worst = mesh_ops.all_reduce(local, self.mesh, "max").tolist()
        return HaloStats(int(worst[0]), int(worst[1]), float(worst[2]))


def gather_positions(rank: HaloRank) -> torch.Tensor:
    """The replica's positions (N, 3) from the ranks' own beads, on every
    rank of the replica."""
    rows = torch.cat([rank.own_pos, rank.own_ids[:, None].to(rank.own_pos.dtype)], dim=1)
    x = rank.own_pos.new_empty((rank.model.n, 3))
    for part in mesh_ops.all_gather(rows, rank.mesh):
        x[part[:, 3].to(torch.int64)] = part[:, :3]
    return x


def run_halo_chunk(rank: HaloRank, state, start: int, steps: int, window):
    """G1 steps ``start + 1`` to ``start + steps`` from ``state`` = (x (N, 3),
    generator, semiaxes (3,)), every tick's events into ``window``; the
    counterpart of the JAX ``make_halo_segment``.  Returns the new state with
    the gathered positions, and the chunk's :class:`HaloStats`."""
    x, generator, semiaxes = state
    tick = rank.model.config.contactmap_update_interval
    rank.rebin(x)
    for step in range(start + 1, start + steps + 1):
        semiaxes = rank.step(semiaxes, generator, step)
        if step % tick == 0:
            rank.tick(step, window)
    stats = rank.stats()
    return (gather_positions(rank), generator, semiaxes), stats


def _widened(geo: HaloGeometry, stats: HaloStats, reach: float):
    """The geometry a violated chunk runs again with, and why; None when the
    chunk is valid."""
    if stats.band_overflow > 0:
        return (geo._replace(edge_capacity=2 * geo.edge_capacity),
                f"band overflow of {stats.band_overflow}; band capacity -> {2 * geo.edge_capacity}")
    if stats.bond_misses > 0 or stats.excursion + reach > geo.halo_width:
        width = max(1.5 * geo.halo_width, stats.excursion + reach)
        if width > geo.slab_width:
            raise RuntimeError(
                f"the halo would be wider than a slab ({width:.3g} > {geo.slab_width:.3g}): "
                "run with fewer shards"
            )
        return (geo._replace(halo_width=width, edge_capacity=2 * geo.edge_capacity),
                f"{stats.bond_misses} bond misses, excursion {stats.excursion:.3g}; "
                f"halo width -> {width:.3g}")
    return None


def run_halo_chunk_checked(model, mesh, geo, state, start, steps, window, log=print):
    """:func:`run_halo_chunk` run again from its saved state (positions,
    semiaxes, generator, window) until its statistics hold, with the
    geometry widened as :func:`_widened` says; every rank of the replica
    decides alike.  Returns (state, geometry, the rank's last HaloRank, the
    count of steps that ran again)."""
    saved_generator = state[1].get_state()
    saved_window = (window.acc, window.rows)
    again = 0
    while True:
        rank = HaloRank(model, mesh, geo)
        new_state, stats = run_halo_chunk(rank, state, start, steps, window)
        change = _widened(geo, stats, model.cell)
        if change is None:
            return new_state, geo, rank, again
        geo, why = change
        again += steps
        if mesh.shard == 0:
            log(f"halo: steps {start + 1}-{start + steps} again: {why}")
        state[1].set_state(saved_generator)
        window.acc, window.rows = saved_window


def _gather_windows(window, mesh) -> list:
    """Every rank's window of the replica (sorted, deduplicated rows), taken
    and sent whole, as the (i, j, count) triples ``merge_window`` takes."""
    mine = torch.as_tensor(window.take(), dtype=torch.int64, device=mesh.device)
    parts = [part.cpu().numpy() for part in mesh_ops.all_gather(mine, mesh)]
    return [(p[:, 0], p[:, 1], p[:, 2]) for p in parts]


def run_halo_g1(store, mesh, start: Optional[dict], settings=None, log=print,
                timings: Optional[dict] = None, halo_width: Optional[float] = None,
                edge_capacity: Optional[int] = None):
    """The G1 phase of ``run_interphase`` spatially decomposed over the
    ranks of ``mesh``'s replica; called on every one of them.

    The replica's first rank passes its store, whose current stage takes the
    frames, windows and checkpoints (a file or a ``MemoryStore``), and
    ``start``: model, config, design, positions ``x``, generator, semiaxes
    and resume step, what its relaxation and frame 0 left; the others pass
    None for both.  The cadences are ``run_interphase``'s: a frame every
    ``sampling_interval`` steps (one chunk), a window every
    ``contactmap_output_window`` frames, a checkpoint at window boundaries,
    a progress line with the shard count.  ``halo_width`` and
    ``edge_capacity`` set the starting geometry (default
    :func:`plan_halo`'s), which widens on demand.  ``timings``, on every
    rank, receives the host-clock seconds and steps of the phase, the steps
    that ran again (``g1_steps_run_again``) and the final geometry
    (``halo``).  Returns the final positions (N, 3) on every rank.
    """
    from ..models.interphase import (
        EngineSettings, InterphaseModel, WindowAccumulator, save_g1_frame,
    )

    settings = settings or EngineSettings()
    first = mesh.shard == 0
    payload = None
    if first:
        payload = dict(
            config=start["config"], design=start["design"],
            x=start["x"].cpu().numpy(), semiaxes=start["semiaxes"].cpu().numpy(),
            generator=start["generator"].get_state().numpy(),
            resume_step=start["resume_step"], bound=start["model"].bound,
        )
    payload = mesh_ops.broadcast_object(payload, mesh)
    device = mesh.device
    if first:
        model, generator = start["model"], start["generator"]
    else:
        model = InterphaseModel.from_design(payload["design"], payload["config"], settings, device)
        model.bound = payload["bound"]
        generator = torch.Generator(device=device)
        generator.set_state(torch.from_numpy(payload["generator"]))
    c = model.config
    n = model.n
    x = torch.as_tensor(payload["x"], dtype=model.dtype, device=device)
    semiaxes = torch.as_tensor(payload["semiaxes"], dtype=model.dtype, device=device)
    resume_step = payload["resume_step"]
    sampling = c.sampling_interval
    window_steps = sampling * c.contactmap_output_window
    shards = mesh.n_bead_shards

    geo = plan_halo(model, shards, x.cpu().numpy(), halo_width=halo_width,
                    edge_capacity=edge_capacity)
    window = WindowAccumulator(n, settings.acc_capacity, device, log if first else (lambda m: None))
    state = (x, generator, semiaxes)

    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return _time.perf_counter()

    t_g1 = clock()
    steps_done = steps_again = 0
    for chunk in range(resume_step // sampling, c.steps // sampling):
        begin = chunk * sampling
        state, geo, rank, again = run_halo_chunk_checked(model, mesh, geo, state, begin,
                                                         sampling, window, log)
        steps_again += again
        x, _, semiaxes = state
        step = begin + sampling
        t = step * c.timestep
        core, bond = model.scales(t)
        pair_energy = rank.pair_energy(core)
        dump = step % window_steps == 0
        parts = None
        if dump:
            parts = _gather_windows(window, mesh)
        steps_done += sampling
        if first:
            _, bonded_energy = model.bonded_forces(x, bond, with_energy=True)
            _, _, wall_energy = model.wall_forces_rows(x, semiaxes, core)
            energy = float(pair_energy + bonded_energy + wall_energy) / n
            coo = None
            if dump:
                coo = merge_window(parts)
            save_g1_frame(store, model, step, x, semiaxes, coo, energy)
            if step % c.logging_interval == 0:
                rate = steps_done / max(clock() - t_g1, 1e-9)
                log(progress_line("interphase", step, t=t, energy=energy,
                                  radius=float(np.cbrt(np.prod(semiaxes.cpu().numpy()))))
                    + f"\t{rate:.1f} steps/s ({rate * n:.3g} bead-steps/s, {shards} shards)")
            if dump:
                store.save_checkpoint(step, {
                    "positions": x.cpu().numpy(), "semiaxes": semiaxes.cpu().numpy(),
                    "key": generator.get_state().numpy(),
                })
        if model.update_bound(float(x.abs().max())):
            if first:
                log(f"engine: grid bound -> {model.bound:g}")
            geo = plan_halo(model, shards, x.cpu().numpy(), halo_width=geo.halo_width,
                            edge_capacity=geo.edge_capacity)
    if timings is not None:
        timings["g1_seconds"] = clock() - t_g1
        timings["g1_steps"] = steps_done
        timings["g1_steps_run_again"] = steps_again
        timings["halo"] = geo._asdict()
    if first:
        store.clear_checkpoint()
    return state[0].cpu().numpy()
