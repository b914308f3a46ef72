"""The process group, the mesh of ranks and the collectives of the
multi-device drivers.

Counterpart of the JAX package's ``parallel/mesh.py``.  Where the JAX package
runs one program over a mesh of devices (``shard_map``), the port runs one
process per rank (``torch.distributed``), each on one device.  The two axes
are the same:

- ``replica``: independent cells of an ensemble; they never communicate;
- ``beads``: the spatial decomposition of one nucleus
  (``parallel/halo.py``, ``parallel/sharded.py``); the ranks of one replica
  form its ``beads`` group, and every collective here runs within it.

Backend rule, explicit, never a silent fallback (:func:`backend_for`):

- ``nccl`` when every rank has a card of its own;
- ``gloo`` on the CPU, and when ranks share one card.  Under ``gloo`` a CUDA
  tensor is staged through host memory for every collective; the compute
  stays on the card.

:func:`spawn` starts the ranks of one host as processes (the ``spawn`` start
method, never ``fork``) that meet through a ``file://`` rendezvous;
:func:`initialize_distributed` also joins a group that ``torchrun`` set up
(``env://``).  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import sys
import tempfile
import uuid
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.logging import log_stderr

# The device this process's rank runs on, set when it joins the group.
_rank_device: Optional[torch.device] = None

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _indexed(device) -> torch.device:
    """``device`` with its card named: ``cuda`` is ``cuda:0``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", 0)
    return device


def backend_for(devices) -> str:
    """The backend for ranks on ``devices`` (one entry per rank of a host):
    ``nccl`` when every rank has a CUDA card of its own, ``gloo`` on the CPU
    or when ranks share a card."""
    devices = [_indexed(d) for d in devices]
    if all(d.type == "cuda" for d in devices):
        cards = [d.index for d in devices]
        return "nccl" if len(set(cards)) == len(cards) else "gloo"
    if all(d.type == "cpu" for d in devices):
        return "gloo"
    raise ValueError(f"ranks on {', '.join(map(str, devices))}: CPU and CUDA ranks do not mix")


def rank_devices(world: int, device=None) -> list:
    """The devices of ``world`` ranks on this host: by default one CUDA card
    each (``cuda:0`` ... ``cuda:world-1``), which raises when there are fewer
    cards than ranks; ``device`` puts every rank on that one device (``cpu``,
    or one card that the ranks share)."""
    if device is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < world:
            raise RuntimeError(
                f"{world} ranks need {world} CUDA cards, found {count}; pass "
                "device='cpu' (CLI: --device cpu) to run the ranks on the CPU"
            )
        return [torch.device("cuda", k) for k in range(world)]
    return [_indexed(device)] * world


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout: Optional[datetime.timedelta] = None,
    log=log_stderr,
) -> None:
    """Join the process group; a second call in a process that has joined
    one does nothing, so drivers may call it unconditionally.

    ``init_method`` is ``env://`` (the default: ``torchrun`` sets ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and the master's
    address) or ``file://PATH``, where ``world_size`` and ``rank`` must be
    given.  ``device`` defaults to the card of the local rank; ``backend``
    to ``nccl`` on a card and ``gloo`` on the CPU, which assumes a card of
    its own (:func:`spawn` passes the backend of :func:`backend_for`).  Rank
    0 logs the backend and every rank's device.
    """
    global _rank_device
    if dist.is_initialized():
        return
    init_method = init_method or "env://"
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        device = rank_devices(local_world)[local]
    device = _indexed(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("backend nccl is not available in this build of torch")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=timeout or datetime.timedelta(minutes=30),
    )
    _rank_device = device
    devices = [None] * world_size
    dist.all_gather_object(devices, str(device))
    if rank == 0:
        log(f"torch.distributed: backend {backend}, {world_size} ranks on "
            + ", ".join(f"{r}:{d}" for r, d in enumerate(devices)))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (replica, beads) grid of ranks.

    ``grid[r][s]`` is the global rank of shard s of replica r; this rank is
    shard ``shard`` of replica ``replica``, on ``device``.  ``beads_group``
    holds the ranks of its replica, ``grid[replica]``.
    """

    grid: tuple
    rank: int
    replica: int
    shard: int
    device: torch.device
    backend: str
    beads_group: object

    @property
    def n_replicas(self) -> int:
        return len(self.grid)

    @property
    def n_bead_shards(self) -> int:
        return len(self.grid[0])

    @property
    def shape(self) -> dict:
        return {"replica": self.n_replicas, "beads": self.n_bead_shards}

    def peer(self, shard: int) -> int:
        """Global rank of shard ``shard`` of this rank's replica."""
        return self.grid[self.replica][shard]


def _group_device() -> torch.device:
    """This rank's device: the one it joined the group with
    (:func:`initialize_distributed`), else, for a group joined directly with
    ``dist.init_process_group``, the card of its local rank (``LOCAL_RANK``
    of ``LOCAL_WORLD_SIZE``, as ``torchrun`` sets them).  Never the CPU
    unasked: raises when the host has fewer cards than ranks."""
    if _rank_device is not None:
        return _rank_device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < local_world:
        raise RuntimeError(
            f"this rank joined the process group without a device, and the host has "
            f"{count} CUDA cards for {local_world} ranks: join it with "
            "initialize_distributed(device=...) to name the device (e.g. 'cpu')"
        )
    return torch.device("cuda", local)


def mesh_device(mesh: "Mesh", device=None) -> torch.device:
    """The device a run on ``mesh`` uses: the mesh's.  A ``device`` the
    caller names must be that one (``cuda`` with no index names any card);
    a run never moves to another device than the one asked for."""
    if device is not None:
        asked = torch.device(device)
        if asked.type != mesh.device.type or asked.index not in (None, mesh.device.index):
            raise ValueError(f"device {asked} asked for, but this rank's mesh is on {mesh.device}")
    return mesh.device


def _mesh_of(grid: np.ndarray) -> Mesh:
    """The mesh of a rank grid; every rank of the group must call it."""
    rank = dist.get_rank()
    groups = [dist.new_group(ranks=[int(r) for r in row]) for row in grid]
    replica, shard = (int(v) for v in np.argwhere(grid == rank)[0])
    return Mesh(
        grid=tuple(tuple(int(r) for r in row) for row in grid), rank=rank,
        replica=replica, shard=shard,
        device=_group_device(), backend=dist.get_backend(),
        beads_group=groups[replica],
    )


def make_mesh(n_replicas: int, n_bead_shards: int, world: Optional[int] = None) -> Mesh:
    """Replica r, shard s on rank ``r * n_bead_shards + s``.  Raises unless
    the group has exactly one rank for each place (a process cannot sit out
    the collectives).  ``world`` defaults to the group's size."""
    if world is None:
        if not dist.is_initialized():
            raise RuntimeError(
                "a mesh needs a process group: start the ranks with "
                "parallel.mesh.spawn or torchrun (initialize_distributed)"
            )
        world = dist.get_world_size()
    need = n_replicas * n_bead_shards
    if world < need:
        raise ValueError(
            f"need {need} ranks for mesh ({n_replicas} replicas x "
            f"{n_bead_shards} bead shards), have {world}"
        )
    if world > need:
        raise ValueError(f"{world} ranks for a mesh of {need} places: every rank needs one")
    return _mesh_of(np.arange(need).reshape(n_replicas, n_bead_shards))


def hybrid_grid(n_replicas: int, n_bead_shards: int, hosts: Sequence) -> np.ndarray:
    """Host-major rank grid: ``hosts[k]`` names the host of rank k.  Each
    host's ranks fill whole replica rows, so no ``beads`` group crosses a
    host (its per-step traffic stays on the host's links) and only the
    independent replicas are spread over hosts."""
    hosts = list(hosts)
    names = sorted(set(hosts))
    if n_replicas % len(names):
        raise ValueError(
            f"replica axis ({n_replicas}) must divide over {len(names)} hosts "
            "so the beads axis stays inside one host"
        )
    per_host = n_replicas // len(names)
    need = per_host * n_bead_shards
    rows = []
    for name in names:
        local = [rank for rank, host in enumerate(hosts) if host == name]
        if len(local) != need:
            raise ValueError(
                f"host {name} has {len(local)} ranks, needs {need} "
                f"({per_host} replicas x {n_bead_shards} shards)"
            )
        rows.append(np.asarray(local).reshape(per_host, n_bead_shards))
    return np.concatenate(rows)


def make_hybrid_mesh(n_replicas: int, n_bead_shards: int, hosts: Optional[Sequence] = None) -> Mesh:
    """The mesh of :func:`hybrid_grid`.  Host membership comes from
    ``hosts`` or, by default, from ``LOCAL_WORLD_SIZE`` (ranks numbered host
    by host, as ``torchrun`` numbers them); with one host it is
    :func:`make_mesh`'s."""
    world = dist.get_world_size()
    if hosts is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        hosts = [rank // local for rank in range(world)]
    return _mesh_of(hybrid_grid(n_replicas, n_bead_shards, hosts))


# -- collectives within a replica's beads group ------------------------------

def _staged(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """The tensor a collective works on: a host copy of a CUDA tensor under
    gloo, else a copy in place."""
    if mesh.backend == "gloo" and tensor.is_cuda:
        return tensor.cpu()
    return tensor.clone()


def all_reduce(tensor: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """Sum or max of ``tensor`` over the beads group, as a new tensor on the
    tensor's device."""
    work = _staged(mesh, tensor)
    dist.all_reduce(work, op=_OPS[op], group=mesh.beads_group)
    return work.to(tensor.device)


def all_gather(tensor: torch.Tensor, mesh: Mesh) -> list:
    """Every shard's ``tensor`` in shard order, on every rank of the beads
    group; the leading sizes may differ (padded to the largest in transit)."""
    work = _staged(mesh, tensor)
    size = torch.tensor([work.shape[0]], dtype=torch.int64, device=work.device)
    sizes = [torch.zeros_like(size) for _ in range(mesh.n_bead_shards)]
    dist.all_gather(sizes, size, group=mesh.beads_group)
    sizes = [int(s) for s in sizes]
    padded = work.new_zeros((max(sizes), *work.shape[1:]))
    padded[: work.shape[0]] = work
    parts = [torch.empty_like(padded) for _ in sizes]
    dist.all_gather(parts, padded, group=mesh.beads_group)
    return [part[:size].to(tensor.device) for part, size in zip(parts, sizes)]


def exchange_bands(to_left: torch.Tensor, to_right: torch.Tensor, mesh: Mesh, fill=-1.0):
    """Send ``to_left`` to the shard on the left and ``to_right`` to the one
    on the right; returns ``(from_left, from_right)``, what they sent this
    way, shaped like ``to_right`` and ``to_left``.  An edge shard has no
    neighbour on one side: that buffer is filled with ``fill``.  One
    ``batch_isend_irecv`` of up to two sends and two receives."""
    send_left, send_right = _staged(mesh, to_left), _staged(mesh, to_right)
    from_left = torch.full_like(send_right, fill)
    from_right = torch.full_like(send_left, fill)
    ops = []
    group = mesh.beads_group
    if mesh.shard > 0:
        left = mesh.peer(mesh.shard - 1)
        ops += [dist.P2POp(dist.isend, send_left, left, group),
                dist.P2POp(dist.irecv, from_left, left, group)]
    if mesh.shard < mesh.n_bead_shards - 1:
        right = mesh.peer(mesh.shard + 1)
        ops += [dist.P2POp(dist.isend, send_right, right, group),
                dist.P2POp(dist.irecv, from_right, right, group)]
    if ops:
        for request in dist.batch_isend_irecv(ops):
            request.wait()
    return from_left.to(to_right.device), from_right.to(to_left.device)


def broadcast_object(obj, mesh: Mesh, shard: int = 0):
    """``obj`` of shard ``shard`` of the replica, on every rank of its beads
    group (pickled)."""
    box = [obj]
    device = mesh.device if mesh.backend == "nccl" else None
    dist.broadcast_object_list(box, src=mesh.peer(shard), group=mesh.beads_group, device=device)
    return box[0]


# -- starting the ranks --------------------------------------------------------

def _rank_main(rank, world, devices, backend, init_method, results, fn, args, threads):
    """Body of a spawned rank: join the group, run ``fn(*args)``, keep what
    it returns for the parent, leave the group."""
    device = torch.device(devices[rank])
    if device.type == "cpu":
        torch.set_num_threads(threads or max(1, (os.cpu_count() or 1) // world))
    initialize_distributed(init_method, world, rank, backend, device)
    try:
        result = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(results, f"rank-{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn, world: int, devices=None, backend: Optional[str] = None, *args,
          rendezvous=None, threads: Optional[int] = None) -> list:
    """Run ``fn(*args)`` in ``world`` new processes, one rank each, and
    return what each returned, by rank.

    ``devices`` (one per rank; default :func:`rank_devices`) and ``backend``
    (default :func:`backend_for` of them) follow the backend rule.  The ranks
    start by the ``spawn`` method, so ``fn`` must be importable by its module
    and name; they meet through a ``file://`` rendezvous in the directory
    ``rendezvous`` (default: a fresh temporary one).  ``threads`` sets the
    torch threads of a CPU rank.  Raises in the parent when any rank raises
    (the others are stopped).
    """
    import torch.multiprocessing as mp

    devices = rank_devices(world) if devices is None else [_indexed(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    backend = backend or backend_for(devices)
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("backend nccl is not available in this build of torch")
    directory = tempfile.mkdtemp(prefix="ranks-", dir=rendezvous)
    try:
        init_method = "file://" + os.path.join(directory, f"rendezvous-{uuid.uuid4().hex}")
        mp.start_processes(
            _rank_main, nprocs=world, join=True, start_method="spawn",
            args=(world, [str(d) for d in devices], backend, init_method, directory,
                  fn, args, threads),
        )
        results = []
        for rank in range(world):
            with open(os.path.join(directory, f"rank-{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def mesh_report(n_replicas: int, n_bead_shards: int, hosts: Optional[Sequence] = None) -> dict:
    """Build the mesh on this rank (host-major when ``hosts`` is given) and
    run each collective once within its beads group: what a rank sees, for
    checking a launch.  Call it in every rank, e.g. through :func:`spawn`."""
    if hosts is None:
        mesh = make_mesh(n_replicas, n_bead_shards)
    else:
        mesh = make_hybrid_mesh(n_replicas, n_bead_shards, hosts)
    mine = torch.tensor([float(mesh.rank)], device=mesh.device)
    from_left, from_right = exchange_bands(mine + 0.25, mine + 0.5, mesh)
    return dict(
        rank=mesh.rank, replica=mesh.replica, shard=mesh.shard, grid=mesh.grid,
        device=str(mesh.device), backend=mesh.backend,
        beads_ranks=mesh.grid[mesh.replica],
        sum=float(all_reduce(mine, mesh)), max=float(all_reduce(mine, mesh, "max")),
        gathered=[t.tolist() for t in all_gather(torch.arange(mesh.shard + 1, device=mesh.device), mesh)],
        from_left=float(from_left), from_right=float(from_right),
        broadcast=broadcast_object(("from shard 0", mesh.rank), mesh),
        jax_loaded="jax" in sys.modules or any(m.startswith("genome_cycle_tpu.") for m in sys.modules),
    )
