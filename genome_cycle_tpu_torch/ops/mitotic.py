"""The mitotic stages' steps a chunk at a time: ``csrc/mitotic_chunk.cu``.

The anaphase, the telophase and the prometaphase run hundreds of thousands
of steps on a few hundred to a thousand coarse beads.  :func:`run_chunk`
advances such a system by K steps (a phase's ``sampling_interval``): on a
CUDA tensor one launch of ``mitotic_chunk_kernel`` (:func:`launch_chunk`),
which keeps the whole system in one thread-block cluster's shared memory for
all K steps, or the call raises; on a CPU tensor the plain version
:func:`run_chunk_reference`, K calls of the model's own eager force field and
``ops/integrator.py::bd_update_reference``, one noise slab a step.

The kernel reads each bead's terms from a table built once on the host
(:func:`term_table`): its bond partners, the bending triples it belongs to
in each of its roles, its kinetochore fiber.  :class:`MitoticTerms` holds
that table with the phase's parameters (:func:`terms_from_anatelophase`,
:func:`terms_from_prometaphase`), and :func:`forces_from_terms_reference` is
the kernel's per-bead arithmetic in plain torch, the oracle of the tables.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import _build
from .integrator import BDParams, bd_update_reference
from .pair_kernels import _check_tensor
from ..utils import tracing

# Slot kinds of the term table (the source's kBond ... kFiber): {kind, a, b, c}.
BOND, TRIPLE_I, TRIPLE_J, TRIPLE_K, FIBER = 1, 2, 3, 4, 5
SOURCE_SEMISPRING, SOURCE_FORCE_FLUX = 0, 1
# Blocks in the one thread-block cluster that runs a system (the source's
# kCluster, non-portable): on the H100 a cluster of 16 ran a step 1.7 to 1.9
# times as fast as one of 8, the portable size (PERF.md).
CLUSTER = 16
_LANE_CHOICES = (1, 2, 4, 8, 16, 32)


class MitoticTerms(NamedTuple):
    """What a mitotic phase's force field needs beside the positions: the
    softcore<2,3> repulsion (energy, diameter), the term table (N, W, 4)
    int32 (:func:`term_table`), two bond sets (0: chain bonds, 1: sister
    cohesion) as semispring constants and lengths, the cosine bending
    energy, the kinetochore fibers (a spring (C,) and a pole (C, 3) a slot,
    one spring length), the point sources every bead feels (at most two
    positions on the host, all semisprings K, l or all force fluxes f b^2,
    b^2), and ``forces``, the model's own eager force field x -> (N, 3),
    the plain version's."""

    table: torch.Tensor
    repulsion: float
    diameter: float
    bond_spring: tuple
    bond_length: tuple
    bending_energy: float
    fiber_spring: torch.Tensor
    fiber_pole: torch.Tensor
    fiber_length: float
    sources: tuple
    source_kind: int
    source_params: tuple
    forces: Callable


class _ChunkArgs(ctypes.Structure):
    """The source's ``ChunkArgs``, field for field."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("noise", ctypes.c_void_p), ("mobility", ctypes.c_void_p),
        ("terms", ctypes.c_void_p), ("fiber_spring", ctypes.c_void_p),
        ("fiber_pole", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("n", ctypes.c_int), ("steps", ctypes.c_int), ("width", ctypes.c_int),
        ("lanes", ctypes.c_int), ("sources", ctypes.c_int), ("source_kind", ctypes.c_int),
        ("rep_k6", ctypes.c_float), ("rep_inv_d2", ctypes.c_float),
        ("bond_k", ctypes.c_float * 2), ("bond_l", ctypes.c_float * 2),
        ("bend_e", ctypes.c_float), ("fiber_length", ctypes.c_float),
        ("source", (ctypes.c_float * 3) * 2),
        ("source_a", ctypes.c_float), ("source_b", ctypes.c_float),
        ("dt", ctypes.c_float), ("two_t", ctypes.c_float),
    ]


def term_table(n: int, bond_sets, triples, fibers, device) -> torch.Tensor:
    """Each bead's term slots, (N, W, 4) int32 on ``device``, W the most any
    bead has (at least 1), empty slots all zero:
    - [BOND, partner, set, 0] for each bond (i, j) of ``bond_sets[set]`` at
      both ends;
    - [TRIPLE_I | TRIPLE_J | TRIPLE_K, i, j, k] for each triple (i, j, k) at
      each of its three beads, the kind naming the bead's role;
    - [FIBER, c, 0, 0] at the kinetochore of fiber slot c.
    Slots come in that order: bonds by set and pair order, triples, fiber."""
    slots = [[] for _ in range(n)]
    for kind, pairs in enumerate(bond_sets):
        for i, j in np.asarray(pairs, np.int64).reshape(-1, 2).tolist():
            slots[i].append((BOND, j, kind, 0))
            slots[j].append((BOND, i, kind, 0))
    for i, j, k in np.asarray(triples, np.int64).reshape(-1, 3).tolist():
        for bead, role in ((i, TRIPLE_I), (j, TRIPLE_J), (k, TRIPLE_K)):
            slots[bead].append((role, i, j, k))
    for c, bead in enumerate(np.asarray(fibers, np.int64).reshape(-1).tolist()):
        slots[bead].append((FIBER, c, 0, 0))
    width = max([len(s) for s in slots] + [1])
    table = np.zeros((n, width, 4), np.int32)
    for bead, entries in enumerate(slots):
        if entries:
            table[bead, :len(entries)] = entries
    return torch.as_tensor(table, device=device)


def _host(tensor):
    return tensor.detach().cpu().numpy()


def terms_from_anatelophase(model, telophase: bool) -> MitoticTerms:
    """The terms of ``models/anatelophase.py::AnatelophaseModel.forces`` for
    the anaphase (``telophase`` False: chain bonds, bending, the kinetochore
    springs toward the shifted pole) or the telophase (the bond and bending
    multipliers, the packing well at the origin)."""
    m = model.config
    device = model.device
    bond_k = m.bond_spring * (m.telophase_bond_spring_multiplier if telophase else 1.0)
    bend_e = m.bending_energy * (m.telophase_bending_energy_multiplier if telophase else 1.0)
    kinetochores = np.zeros(0, np.int64) if telophase else _host(model.kinetochores)
    fibers = len(kinetochores)
    pole = model.pole.reshape(1, 3).expand(fibers, 3).contiguous()
    sources = ((0.0, 0.0, 0.0),) if telophase else ()
    source_params = (m.telophase_packing_spring, m.telophase_packing_radius)
    return MitoticTerms(
        table=term_table(model.n, [_host(model.bond_pairs)], _host(model.triples),
                         kinetochores, device),
        repulsion=m.core_repulsion, diameter=m.core_diameter,
        bond_spring=(bond_k, 0.0), bond_length=(m.bond_length, 0.0),
        bending_energy=bend_e,
        fiber_spring=model.kfiber_springs[:fibers].contiguous(), fiber_pole=pole,
        fiber_length=m.kfiber_length_anaphase,
        sources=sources, source_kind=SOURCE_SEMISPRING, source_params=source_params,
        forces=lambda x: model.forces(x, telophase)[0],
    )


def terms_from_prometaphase(model) -> MitoticTerms:
    """The terms of ``models/prometaphase.py::PrometaphaseModel.forces``:
    chain bonds and sister cohesion (both at ``bond_spring``), bending, the
    two fiber fields with a pole for each kinetochore, and, when
    ``polar_ejection_force`` is not 0, the force-flux ejection from both
    poles."""
    m = model.config
    device = model.device
    b2 = float(np.sqrt(m.polar_ejection_cross_section)) ** 2
    ejection = m.polar_ejection_force != 0
    sources = tuple(map(tuple, _host(model.poles).tolist())) if ejection else ()
    return MitoticTerms(
        table=term_table(model.n, [_host(model.bond_pairs), _host(model.sister_pairs)],
                         _host(model.triples), _host(model.kfiber_kinetochores), device),
        repulsion=m.core_repulsion, diameter=m.core_diameter,
        bond_spring=(m.bond_spring, m.bond_spring),
        bond_length=(m.bond_length, m.sister_separation),
        bending_energy=m.bending_energy,
        fiber_spring=model.kfiber_springs.contiguous(),
        fiber_pole=model.kfiber_poles.contiguous(),
        fiber_length=m.kfiber_length_prometaphase,
        sources=sources, source_kind=SOURCE_FORCE_FLUX,
        source_params=(m.polar_ejection_force * b2, b2),
        forces=lambda x: model.forces(x)[0],
    )


def _coefficient_semispring(r2, k, length):
    r = torch.sqrt(torch.clamp(r2, min=1e-30))
    return torch.where(r > length, -k * (1.0 - length / r), torch.zeros_like(r))


def forces_from_terms_reference(x, terms: MitoticTerms):
    """The kernel's forces at positions ``x`` (N, 3), bead by bead as it
    forms them, in plain torch: the repulsion 6 e / d^2 sum_j
    max(1 - r^2 / d^2, 0)^2 (x_i - x_j), then each bead's table slots one
    column at a time, then the point sources."""
    inv_d2 = 1.0 / (terms.diameter * terms.diameter)
    d = x[:, None, :] - x[None, :, :]
    core = torch.clamp(1.0 - torch.sum(d * d, dim=-1) * inv_d2, min=0.0)
    forces = 6.0 * terms.repulsion * inv_d2 * torch.sum((core * core)[..., None] * d, dim=1)
    table = terms.table.to(x.device).long()
    zero = torch.zeros_like(x)
    for w in range(table.shape[1]):
        kind, p, q, s = table[:, w].unbind(-1)
        # Bonds: semispring of the slot's set toward the partner p.
        dx = x - x[p]
        r2 = torch.sum(dx * dx, dim=-1)
        k = torch.where(q == 1, terms.bond_spring[1], terms.bond_spring[0]).to(x.dtype)
        length = torch.where(q == 1, terms.bond_length[1], terms.bond_length[0]).to(x.dtype)
        bond = _coefficient_semispring(r2, k, length)[:, None] * dx
        # Triples (p, q, s) in the bead's role.
        a, b = x[q] - x[p], x[s] - x[q]
        a2, b2 = torch.sum(a * a, dim=-1), torch.sum(b * b, dim=-1)
        product = a2 * b2
        clamped = torch.clamp(product, min=1e-30)
        scale = terms.bending_energy * torch.rsqrt(clamped)
        ratio = torch.where(product > 1e-30, torch.sum(a * b, dim=-1) / clamped,
                            torch.zeros_like(product))
        ga = scale[:, None] * (b - (ratio * b2)[:, None] * a)
        gb = scale[:, None] * (a - (ratio * a2)[:, None] * b)
        # Fiber slot p: spring toward its pole.
        if terms.fiber_spring.numel():
            slot = torch.clamp(p, max=terms.fiber_spring.numel() - 1)
            df = x - terms.fiber_pole.to(x)[slot]
            rf = torch.sqrt(torch.clamp(torch.sum(df * df, dim=-1), min=1e-30))
            k_fiber = terms.fiber_spring.to(x)[slot]
            fiber = (-k_fiber * (1.0 - terms.fiber_length / rf))[:, None] * df
        else:
            fiber = zero
        kind = kind[:, None]
        forces = forces + torch.where(kind == BOND, bond, torch.where(
            kind == TRIPLE_I, -ga, torch.where(
                kind == TRIPLE_J, ga - gb, torch.where(
                    kind == TRIPLE_K, gb, torch.where(kind == FIBER, fiber, zero)))))
    coeff_a, coeff_b = terms.source_params
    for source in terms.sources:
        dx = x - torch.tensor(source, dtype=x.dtype, device=x.device)
        r2 = torch.sum(dx * dx, dim=-1)
        if terms.source_kind == SOURCE_SEMISPRING:
            c = _coefficient_semispring(r2, coeff_a, coeff_b)
        else:
            r = torch.sqrt(torch.clamp(r2, min=1e-30))
            c = coeff_a / (coeff_b * r + r * r2)
        forces = forces + c[:, None] * dx
    return forces


def run_chunk_reference(x, forces, mobility, noise, temperature: float, timestep: float):
    """Plain version of :func:`run_chunk`: for k in 0 .. K - 1,
    x <- ``bd_update_reference``(x, ``forces``(x), ...) with ``noise[k]``."""
    params = BDParams(temperature, timestep)
    for k in range(noise.shape[0]):
        x = bd_update_reference(x, forces(x), mobility, None, params, noise=noise[k])
    return x


def _check_chunk_inputs(x, mobility, noise):
    device = x.device
    if x.dim() != 2 or x.shape[-1] != 3:
        raise ValueError(f"positions of shape {tuple(x.shape)}: expected (N, 3)")
    n = x.shape[0]
    _check_tensor("positions", x, torch.float32, (n, 3), device, 4)
    _check_tensor("mobility", mobility, torch.float32, (n,), device, 4)
    if noise.dim() != 3:
        raise ValueError(f"noise of shape {tuple(noise.shape)}: expected (K, {n}, 3)")
    _check_tensor("noise", noise, torch.float32, (noise.shape[0], n, 3), device, 4)


@tracing.traced("mitotic.chunk")
def run_chunk(x, terms: MitoticTerms, mobility, noise, temperature: float, timestep: float):
    """K = ``noise.shape[0]`` Brownian steps of the system at ``x`` (N, 3)
    float32 under ``terms``, step k with the standard normals ``noise[k]``;
    returns the new positions.  On a CUDA tensor one launch of the chunk
    kernel, or the call raises; on a CPU tensor the plain version
    :func:`run_chunk_reference`."""
    _check_chunk_inputs(x, mobility, noise)
    if x.device.type != "cuda":
        return run_chunk_reference(x, terms.forces, mobility, noise, temperature, timestep)
    return launch_chunk(x, terms, mobility, noise, temperature, timestep)


def _library():
    lib = _build.load_library("mitotic_chunk")
    if not lib.mitotic_chunk_launch.argtypes:
        lib.mitotic_chunk_launch.argtypes = [ctypes.POINTER(_ChunkArgs), ctypes.c_void_p]
        lib.mitotic_chunk_launch.restype = ctypes.c_int
        lib.mitotic_chunk_shared_limit.argtypes = [ctypes.c_int]
        lib.mitotic_chunk_shared_limit.restype = ctypes.c_int
        lib.mitotic_chunk_cluster.argtypes = []
        lib.mitotic_chunk_cluster.restype = ctypes.c_int
        lib.mitotic_chunk_args_size.argtypes = []
        lib.mitotic_chunk_args_size.restype = ctypes.c_int
        lib.mitotic_chunk_threads.argtypes = []
        lib.mitotic_chunk_threads.restype = ctypes.c_int
        if lib.mitotic_chunk_args_size() != ctypes.sizeof(_ChunkArgs):
            raise RuntimeError("mitotic_chunk.cu's ChunkArgs and the wrapper's copy differ")
        if lib.mitotic_chunk_cluster() != CLUSTER:
            raise RuntimeError("mitotic_chunk.cu's cluster size and the wrapper's differ")
    return lib


def shared_bytes(n: int) -> int:
    """Shared memory a block takes for ``n`` beads: two float4 position
    buffers of the whole system and two buffers of its own noise rows (what
    the source's mitotic_chunk_shared_bytes asks for at launch)."""
    return 32 * n + 24 * (-(-n // CLUSTER))


def capacity(limit: int) -> int:
    """The most beads the cluster holds when a block may take ``limit``
    bytes of shared memory."""
    n = limit // 32
    while n > 0 and shared_bytes(n) > limit:
        n -= 1
    return n


def _shared_limit(device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    limit = _library().mitotic_chunk_shared_limit(index)
    if limit <= 0:
        raise RuntimeError("could not read the card's shared memory a block may take")
    return limit


def device_capacity(device) -> int:
    """The most beads the cluster holds on the CUDA card ``device``."""
    return capacity(_shared_limit(torch.device(device)))


def lanes_per_row(n: int, slots: int, threads: int = 512) -> int:
    """Threads that share a row's walk: the choice with the fewest serial
    steps a thread takes, counting a pass over the block's rows as its walk
    (N / lanes partners), its butterfly (2 log2 lanes) and its share of the
    row's term slots (4 partners' worth each)."""
    rows = -(-n // CLUSTER)

    def cost(lanes):
        passes = -(-rows * lanes // threads)
        return passes * (-(-n // lanes) + 2 * lanes.bit_length() + 4 * -(-slots // lanes))

    return min(_LANE_CHOICES, key=cost)


def launch_chunk(x, terms: MitoticTerms, mobility, noise, temperature: float, timestep: float):
    """One launch of ``mitotic_chunk_kernel`` on CUDA float32 tensors: the
    K = ``noise.shape[0]`` steps of :func:`run_chunk`, out of place, on the
    current stream without synchronising, by one cluster of :data:`CLUSTER`
    blocks.  Raises for a system larger than the cluster's shared memory
    holds, and on anything the kernel does not take."""
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"the mitotic chunk kernel runs on a CUDA tensor, not on {device}")
    _check_chunk_inputs(x, mobility, noise)
    n, steps = x.shape[0], noise.shape[0]
    width = terms.table.shape[1]
    _check_tensor("term table", terms.table, torch.int32, (n, width, 4), device, 16)
    fibers = terms.fiber_spring.shape[0]
    _check_tensor("fiber springs", terms.fiber_spring, torch.float32, (fibers,), device, 4)
    _check_tensor("fiber poles", terms.fiber_pole, torch.float32, (fibers, 3), device, 4)
    sources = len(terms.sources)
    if sources > 2:
        raise ValueError(f"{sources} point sources: the kernel takes at most 2")
    if steps * n * 3 >= 2 ** 62 or n * width >= 2 ** 31:
        raise ValueError("chunk too large for the kernel's indices")
    if steps == 0:
        return x.clone()
    lib = _library()
    limit = _shared_limit(device)
    if shared_bytes(n) > limit:
        raise ValueError(
            f"a system of {n} beads does not fit one cluster's shared memory: a cluster of "
            f"{CLUSTER} blocks holds at most {capacity(limit)} beads ({limit} bytes "
            f"of shared memory a block, {shared_bytes(n)} needed)")
    out = torch.empty_like(x)
    args = _ChunkArgs()
    args.x, args.noise, args.mobility = x.data_ptr(), noise.data_ptr(), mobility.data_ptr()
    args.terms = terms.table.data_ptr()
    args.fiber_spring = terms.fiber_spring.data_ptr() if fibers else None
    args.fiber_pole = terms.fiber_pole.data_ptr() if fibers else None
    args.out = out.data_ptr()
    args.n, args.steps, args.width = n, steps, width
    args.lanes = lanes_per_row(n, width + sources, lib.mitotic_chunk_threads())
    args.sources, args.source_kind = sources, int(terms.source_kind)
    inv_d2 = 1.0 / (terms.diameter * terms.diameter)
    args.rep_k6, args.rep_inv_d2 = terms.repulsion * 6.0 * inv_d2, inv_d2
    args.bond_k = (ctypes.c_float * 2)(*(float(v) for v in terms.bond_spring))
    args.bond_l = (ctypes.c_float * 2)(*(float(v) for v in terms.bond_length))
    args.bend_e, args.fiber_length = float(terms.bending_energy), float(terms.fiber_length)
    for s, position in enumerate(terms.sources):
        args.source[s] = (ctypes.c_float * 3)(*position)
    args.source_a, args.source_b = (float(v) for v in terms.source_params)
    args.dt, args.two_t = float(timestep), 2.0 * float(temperature)
    with torch.cuda.device(device):
        status = lib.mitotic_chunk_launch(ctypes.byref(args),
                                          torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"mitotic_chunk kernel launch failed: CUDA error {status}")
    tracing.count("launch.mitotic_chunk")
    return out
