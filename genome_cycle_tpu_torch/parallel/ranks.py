"""Entry functions of spawned ranks.

Each is called in every rank of a group that ``parallel/mesh.spawn`` started:
it builds its mesh and model from picklable arguments, drives one of the
multi-device paths and returns plain host values, which ``spawn`` hands back
to the parent by rank.  They live in the package so that a rank imports only
the package (``spawn`` pickles a function by its module and name).  Every
result says which rank made it, how many times that rank launched the pair
kernel while it drove the path (the ``launch.ab_pair_forces`` counter's
increase from just before), and whether JAX or the JAX package were loaded
in it.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from ..models.interphase import InterphaseModel, run_interphase
from ..utils import tracing
from . import halo, mesh as mesh_ops, sharded
from .ensemble import replica_share, run_ensemble_interphase


def _foreign_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "genome_cycle_tpu"))


def _pair_launches() -> int:
    return tracing.counters().get("launch.ab_pair_forces", 0)


def _result(mesh, launched_from: int = 0, **values) -> dict:
    """The rank's result; ``launches`` counts the pair kernel's launches
    since the count ``launched_from``."""
    return dict(rank=mesh.rank, replica=mesh.replica, shard=mesh.shard, device=str(mesh.device),
                backend=mesh.backend, launches=_pair_launches() - launched_from,
                foreign_modules=_foreign_modules(), **values)


def _model(mesh, config, arrays, settings, bound=None) -> InterphaseModel:
    model = InterphaseModel(config, arrays, settings, mesh.device)
    if bound is not None:
        model.bound = float(bound)
    return model


def _assembled(ids: torch.Tensor, force: torch.Tensor, mesh, n: int) -> np.ndarray:
    """The (N, 3) forces of the replica from every rank's rows ``ids``."""
    rows = torch.cat([force, ids[:, None].to(force.dtype)], dim=1)
    out = force.new_empty((n, 3))
    for part in mesh_ops.all_gather(rows, mesh):
        out[part[:, 3].to(torch.int64)] = part[:, :3]
    return out.cpu().numpy()


def halo_g1(n_replicas, config, design, x, semiaxes, seeds, settings=None, bound=None,
            halo_width=None, edge_capacity=None) -> dict:
    """``halo.run_halo_g1`` of replica r from positions ``x`` (N, 3) and
    ``semiaxes`` with no relaxation, its generator seeded ``seeds[r]``, on a
    mesh of ``n_replicas`` replicas over the group; the replica's first rank
    writes the frames into a ``MemoryStore`` and hands it back."""
    from ..store import MemoryStore

    mesh = mesh_ops.make_mesh(n_replicas, dist.get_world_size() // n_replicas)
    start = store = None
    if mesh.shard == 0:
        model = InterphaseModel.from_design(design, config, settings, mesh.device)
        if bound is not None:
            model.bound = float(bound)
        generator = torch.Generator(device=mesh.device)
        generator.manual_seed(int(seeds[mesh.replica]))
        start = dict(model=model, config=config, design=design, generator=generator, resume_step=0,
                     x=torch.as_tensor(x, dtype=model.dtype, device=mesh.device),
                     semiaxes=torch.as_tensor(semiaxes, dtype=model.dtype, device=mesh.device))
        store = MemoryStore()
        store.set_stage("interphase")
    log, timings = [], {}
    launched_from = _pair_launches()
    final = halo.run_halo_g1(store, mesh, start, settings, log.append, timings,
                             halo_width, edge_capacity)
    return _result(mesh, launched_from, final=final, log=log, timings=timings, store=store)


def halo_forces(config, arrays, settings, x, semiaxes, step, bound=None) -> dict:
    """One halo step's assembled forces (N, 3) and wall reaction at
    positions ``x``, and this rank's local layout (host arrays, padded rows
    and all) with the pair kernel's parameters of that step."""
    mesh = mesh_ops.make_mesh(1, dist.get_world_size())
    model = _model(mesh, config, arrays, settings, bound)
    x = torch.as_tensor(x, dtype=model.dtype, device=mesh.device)
    semiaxes = torch.as_tensor(semiaxes, dtype=model.dtype, device=mesh.device)
    rank = halo.HaloRank(model, mesh, halo.plan_halo(model, mesh.n_bead_shards, x.cpu().numpy()))
    rank.rebin(x)
    force, reaction = rank.forces(semiaxes, step)
    layout = rank.layout()
    return _result(mesh, forces=_assembled(rank.own_ids, force, mesh, model.n),
                   reaction=reaction.cpu().numpy(), own=int(rank.own_ids.shape[0]),
                   params=model.pair_kernel_params(model.scales((step - 1) * model.config.timestep)[0]),
                   layout={k: v.cpu().numpy() if torch.is_tensor(v) else v
                           for k, v in layout._asdict().items()})


def sharded_forces(config, arrays, settings, x, semiaxes, step, bound=None) -> dict:
    """The replicated engine's forces of one step (N, 3, assembled from the
    home ranges) and wall reaction at positions ``x``."""
    mesh = mesh_ops.make_mesh(1, dist.get_world_size())
    model = _model(mesh, config, arrays, settings, bound)
    x = torch.as_tensor(x, dtype=model.dtype, device=mesh.device)
    semiaxes = torch.as_tensor(semiaxes, dtype=model.dtype, device=mesh.device)
    home, force, reaction = sharded.sharded_step_forces(model, mesh, x, semiaxes, step)
    return _result(mesh, forces=_assembled(home, force, mesh, model.n),
                   reaction=reaction.cpu().numpy(), home=sharded.home_range(model.n, mesh)[:2])


def interphase(target, settings=None, n_shards=None) -> dict:
    """``run_interphase`` on every rank: the first rank with the store
    (``target`` is the path of a store, which only it opens, or a
    ``MemoryStore``, which it hands back), the others with None.  With
    ``n_shards`` the call names the shard count; without, it is given the
    mesh of one replica over the group."""
    mesh = mesh_ops.make_mesh(1, dist.get_world_size())
    log, timings = [], {}
    store = None
    if mesh.shard == 0:
        if isinstance(target, str):
            from ..store import open_store

            store = open_store(target)
        else:
            store = target
    launched_from = _pair_launches()
    try:
        if n_shards is None:
            final = run_interphase(store, settings, log.append, timings=timings, mesh=mesh)
        else:
            final = run_interphase(store, settings, log.append, timings=timings, n_shards=n_shards)
    finally:
        if isinstance(target, str) and store is not None:
            store.close()
    kept = target if mesh.shard == 0 and not isinstance(target, str) else None
    return _result(mesh, launched_from, final=final, log=log, timings=timings, store=kept)


def sharded_steps(config, arrays, settings, x, semiaxes, seed, steps, bound=None) -> dict:
    """The replicated-position engine (``parallel/sharded.py``) over
    ``steps`` G1 steps from ``x`` (N, 3), as one chunk; the windows of all
    ranks merged."""
    from ..ops.contact import merge_window

    mesh = mesh_ops.make_mesh(1, dist.get_world_size())
    model = _model(mesh, config, arrays, settings, bound)
    carry = sharded.init_sharded_carry(model, mesh, np.asarray(x)[None], [seed],
                                       np.asarray(semiaxes)[None], model.settings.acc_capacity)
    launched_from = _pair_launches()
    carry = sharded.make_sharded_chunk(model, mesh, steps)(carry, 0)
    mine = torch.as_tensor(carry.window.take(), dtype=torch.int64, device=mesh.device)
    parts = [p.cpu().numpy() for p in mesh_ops.all_gather(mine, mesh)]
    window = merge_window([(p[:, 0], p[:, 1], p[:, 2]) for p in parts])
    return _result(mesh, launched_from, positions=carry.positions.cpu().numpy(),
                   semiaxes=carry.semiaxes.cpu().numpy(), window=window,
                   home=sharded.home_range(model.n, mesh)[:2])


def ensemble(targets, settings=None) -> dict:
    """``run_ensemble_interphase`` with the replica axis over the group, one
    rank a replica row: each rank opens only its own stores (paths of HDF5
    files) or takes its own of the ``MemoryStore``s given, and hands those
    back."""
    mesh = mesh_ops.make_mesh(dist.get_world_size(), 1)
    mine = replica_share(len(targets), mesh)
    stores = [None] * len(targets)
    for k in mine:
        if isinstance(targets[k], str):
            from ..store import open_store

            stores[k] = open_store(targets[k])
        else:
            stores[k] = targets[k]
    log, timings = [], {}
    launched_from = _pair_launches()
    try:
        final = run_ensemble_interphase(stores, settings, log.append, timings=timings, mesh=mesh)
    finally:
        for k in mine:
            if isinstance(targets[k], str):
                stores[k].close()
    kept = {k: stores[k] for k in mine if not isinstance(targets[k], str)}
    return _result(mesh, launched_from, replicas=mine, final=final, log=log, timings=timings,
                   stores=kept)


def run_tasks(tasks) -> dict:
    """Several of the functions above one after another in one group of
    ranks (each builds its own mesh), so that the ranks start once:
    ``tasks`` is a list of ``(name, function, args)``; returns ``{name:
    result}``."""
    return {name: function(*args) for name, function, args in tasks}
