"""Ensemble replica axis: many independent interphase runs at once.

Counterpart of the JAX package's ``parallel/ensemble.py``.  The reference runs
ensemble replicas as separate shell jobs over separate trajectory files and
merges their contact maps downstream (src/cool.py:80-110; SURVEY.md §2.11).
Here R replicas of one topology integrate in lock-step on one device, each
still writing its own reference-schema trajectory file, so the downstream
analysis is unchanged.

Where the JAX package vmaps the step over the replica axis, the port writes
the axis out: the step state holds positions (R, N, 3), R generators and
semiaxes (R, 3), and the steps of ``models/interphase.py`` take it as they
take one system.  The replicas share one cell layout, their cubes side by side
with a column of empty cells between (``ops/pair_kernels.CellLayout``), so
every step makes one launch of the pair-force kernel for all of them, and one
contact search a tick.  They share nothing else: each has its own wall and
reaction, its own displacement limit in the relaxation, and its own noise —
replica r's generator is seeded with its store's stage seed, as
``run_interphase`` seeds its one generator, so it draws the numbers a single
run of that store draws.

Contact windows accumulate on the device in one accumulator keyed on the
replicas' bead ids ``r * N + i``; at a dump it is split into the replicas'
windows (``ops/contact.split_window``).  Every tick of every chunk is merged.

No counterpart here, as in ``run_interphase``: capacity probing and the
``_AdaptiveEngine`` retries (the layout has no capacity).

The ``mesh`` argument spreads the replica axis over ranks, one process each
(``parallel/mesh.py``): each rank runs its share of the stores stacked, as
above, and writes only those.  Replicas share nothing, so the ranks never
communicate, and each replica is the same run as in one process.
"""

from __future__ import annotations

import time as _time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..models.anatelophase import seeded_generator
from ..models.interphase import (
    EngineSettings,
    InterphaseModel,
    WindowAccumulator,
    design_arrays,
)
from ..ops.contact import events_to_host, merge_window, split_window
from ..store import InterphaseContext
from ..utils.logging import progress_line
from .mesh import mesh_device


def _check_topology(designs, config):
    """Raise unless every design has the first one's particles and per-bead
    arrays: the replicas share one model."""
    first = design_arrays(designs[0], config.interphase)
    for design in designs[1:]:
        if design.particle_count != designs[0].particle_count:
            raise ValueError("ensemble stores disagree on topology")
        arrays = design_arrays(design, config.interphase)
        for name, value in first.items():
            if not np.array_equal(value, arrays[name]):
                raise ValueError(f"ensemble stores disagree on topology ({name})")


def replica_share(replicas: int, mesh) -> list:
    """The replicas (indices into the stores) that this rank runs: a
    contiguous block for each replica row of the mesh."""
    return [int(k) for k in np.array_split(np.arange(replicas), mesh.n_replicas)[mesh.replica]]


def run_ensemble_interphase(
    stores: Sequence,
    settings: Optional[EngineSettings] = None,
    log=print,
    device=None,
    timings: Optional[dict] = None,
    mesh=None,
):
    """Run the interphase stage, relaxation and G1, for R replicas in
    lock-step.

    All stores must come from the same ``prepare`` inputs (identical
    topology); each keeps its own stage seed, so trajectories are independent
    samples.  Relaxation initial structures must already be in place
    (``transition interphase`` per store).  Runs on the first CUDA card unless
    ``device`` says otherwise; with no card and no such request it raises.
    ``timings``, when given, receives the host-clock seconds and step counts
    of the two phases, as from ``run_interphase``.  Returns the final
    positions (R, N, 3).

    With ``mesh`` (R' replicas x 1 shard, one rank each) every rank calls
    this with the list of all R stores and runs, on the mesh's device (a
    ``device`` that names another raises), the block of them
    :func:`replica_share` gives it; the others' entries may be
    None, as they are never touched.  Returns the final positions of its
    own replicas.
    """
    if mesh is not None:
        if mesh.n_bead_shards != 1:
            raise ValueError("the ensemble spreads replicas only: use a mesh of (R, 1) ranks")
        stores = [stores[k] for k in replica_share(len(stores), mesh)]
        device = mesh_device(mesh, device)
    r = len(stores)
    if r == 0:
        return None
    device = resolve_device(device)
    config = stores[0].load_config()
    designs = [s.load_interphase_design() for s in stores]
    _check_topology(designs, config)
    settings = settings or EngineSettings()
    model = InterphaseModel.from_design(designs[0], config, settings, device)
    c = config.interphase
    n = model.n
    dtype = model.dtype
    generators = [seeded_generator(d.seed, device) for d in designs]

    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return _time.perf_counter()

    def to_host(tensor):
        return tensor.detach().cpu().numpy()

    def refresh_bound(x):
        # One grid for all replicas: it spans the widest of them.
        if model.update_bound(float(x.abs().max())):
            log(f"engine: grid bound -> {model.bound:g}")

    def save_frames(step, x, semiaxes, t, core, bond, windows=None):
        positions, axes = to_host(x), to_host(semiaxes)
        for k, store in enumerate(stores):
            store.save_positions(step, positions[k])
            store.save_interphase_context(step, InterphaseContext(
                time=t,
                wall_semiaxes=tuple(float(v) for v in axes[k]),
                core_scale=float(core),
                bond_scale=float(bond),
            ))
            if windows is not None:
                store.save_contacts(step, windows[k])
            store.append_frame(step)

    # ---- relaxation phase --------------------------------------------------
    for store in stores:
        store.set_stage("relaxation")
        store.clear_frames()
    x = torch.stack([
        torch.as_tensor(store.load_positions(0), dtype=dtype, device=device)
        for store in stores
    ])
    if x.shape[1] != n:
        raise ValueError("initial structure size mismatch")
    refresh_bound(x)
    semiaxes0 = torch.as_tensor(c.wall_semiaxes_init, dtype=dtype, device=device).repeat(r, 1)
    save_frames(0, x, semiaxes0, 0.0, c.core_scale_init, c.bond_scale_init)

    t_relax = clock()
    state = (x, generators, semiaxes0)
    n_chunks = c.relaxation_steps // c.relaxation_sampling_interval
    for chunk in range(n_chunks):
        for s in range(c.relaxation_sampling_interval):
            state = model.relaxation_step(state, s)
        step = (chunk + 1) * c.relaxation_sampling_interval
        refresh_bound(state[0])
        save_frames(step, state[0], semiaxes0, 0.0, c.core_scale_init, c.bond_scale_init)
        log(progress_line("relaxation", step, t=0.0))
    if timings is not None:
        timings["relaxation_seconds"] = clock() - t_relax
        timings["relaxation_steps"] = n_chunks * c.relaxation_sampling_interval
    x = state[0]

    # ---- interphase (G1) phase ---------------------------------------------
    for store in stores:
        store.set_stage("interphase")
    sampling = c.sampling_interval
    window_steps = sampling * c.contactmap_output_window

    # Resume only when every store holds a checkpoint at the same window
    # boundary (windows flush there, so no contact is double-counted).
    checkpoints = [s.load_checkpoint() for s in stores]
    resume_step = 0
    if all(cp is not None for cp in checkpoints):
        steps_at = {int(cp["step"]) for cp in checkpoints}
        if len(steps_at) == 1 and 0 < next(iter(steps_at)) < c.steps:
            resume_step = next(iter(steps_at))
            log(f"resuming ensemble interphase from step {resume_step}")

    if resume_step:
        x = torch.stack([
            torch.as_tensor(cp["positions"], dtype=dtype, device=device) for cp in checkpoints
        ])
        semiaxes = torch.stack([
            torch.as_tensor(cp["semiaxes"], dtype=dtype, device=device) for cp in checkpoints
        ])
        for generator, cp in zip(generators, checkpoints):
            generator.set_state(torch.from_numpy(np.ascontiguousarray(cp["key"], np.uint8)))
        for store in stores:
            store.truncate_frames(resume_step)
        refresh_bound(x)
    else:
        for store in stores:
            store.clear_frames()
        # callback(0) semantics of the reference and the single-store
        # driver: sample frame 0, one contact update, dump-and-clear the
        # step-0 window, then a reaction-free wall update before step 1.
        events = events_to_host(model.contact_events_tick(x, 0))
        core0, bond0 = model.scales(0.0)
        save_frames(0, x, semiaxes0, 0.0, core0, bond0,
                    split_window(merge_window([events]), n, r))
        semiaxes = semiaxes0 + c.timestep * c.wall_mobility * (
            0.0 - model.wall_spring * semiaxes0
        )

    window = WindowAccumulator(r * n, settings.acc_capacity, device, log)
    state = (x, generators, semiaxes)
    t_g1 = clock()
    wall_t0 = _time.perf_counter()
    steps_done = 0
    for chunk in range(resume_step // sampling, c.steps // sampling):
        start = chunk * sampling
        state = model.g1_chunk(state, start, sampling, window)
        x, _, semiaxes = state
        refresh_bound(x)
        step = start + sampling
        t = step * c.timestep
        core, bond = model.scales(t)
        dump = step % window_steps == 0
        windows = split_window(window.take(), n, r) if dump else None
        save_frames(step, x, semiaxes, t, core, bond, windows)
        steps_done += sampling

        if dump:
            positions, axes = to_host(x), to_host(semiaxes)
            for k, store in enumerate(stores):
                store.save_checkpoint(step, {
                    "positions": positions[k],
                    "semiaxes": axes[k],
                    "key": generators[k].get_state().numpy(),
                })
        if step % c.logging_interval == 0:
            rate = steps_done / max(_time.perf_counter() - wall_t0, 1e-9)
            log(progress_line("interphase", step, t=t)
                + f"\t{r} replicas\t{rate:.1f} steps/s ({rate * r * n:.3g} bead-steps/s)")
    if timings is not None:
        timings["g1_seconds"] = clock() - t_g1
        timings["g1_steps"] = steps_done

    for store in stores:
        store.clear_checkpoint()
    return to_host(state[0])
