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
take one system.  So does the stage around the steps there
(``run_relaxation``, ``start_g1``, ``run_g1_frames``): this module adds the
check that the stores share one topology and a rank's share of a mesh.  An
ensemble's frames carry a mean energy of 0.0 (no energy pass).  The replicas
share one cell layout, their cubes side by side with a column of empty cells
between (``ops/pair_kernels.CellLayout``), so
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

from typing import Optional, Sequence

import numpy as np

from .. import resolve_device
from ..models.anatelophase import seeded_generator
from ..models.interphase import (
    EngineSettings,
    InterphaseModel,
    design_arrays,
    run_g1_frames,
    run_relaxation,
    start_g1,
)
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
    ``timings``, when given, receives what ``run_interphase`` gives it, the
    windows' records counting the rows of all replicas.  A resume needs a
    checkpoint at the same step in every store.  Returns the final
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
    if not stores:
        return None
    device = resolve_device(device)
    config = stores[0].load_config()
    designs = [s.load_interphase_design() for s in stores]
    _check_topology(designs, config)
    settings = settings or EngineSettings()
    model = InterphaseModel.from_design(designs[0], config, settings, device)
    generators = [seeded_generator(d.seed, device) for d in designs]
    state = run_relaxation(stores, model, generators, device, log, timings)
    state, resume = start_g1(stores, model, state, log, timings)
    return run_g1_frames(stores, model, state, resume, settings, log, timings)
