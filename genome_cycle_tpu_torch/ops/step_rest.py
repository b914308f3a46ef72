"""Wrappers of ``csrc/step_rest.cu``: the O(N) rest of a step on the card.

:func:`rest` is what a step calls: ``forces`` plus the chain and loop bonds,
the nucleolar bonds and droplet, and the wall with its per-axis reaction, or,
given an :class:`UpdateRows`, the Brownian update of the G1 step with the
wall ODE as well.  A CUDA tensor takes one launch of the rest kernel
(:func:`launch_rest`) or raises; a CPU tensor takes the plain composition
:func:`rest_reference` (``ops/bonded.py::shift_bond_forces`` and
``pair_bond_forces``, ``ops/neighbor.py::pairwise_forces_dense`` for the
droplet, ``ops/wall.py::wall_forces_reference`` (autograd),
``ops/integrator.py::bd_update_reference``).

:func:`launch_update` is the update alone, with the relaxation's
displacement limit computed on the device; it sits behind
``ops/integrator.py::bd_update``.

Both kernels take float32 CUDA tensors only, raise on anything else, launch
on the current stream without synchronising, and count their launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build, integrator, potentials
from . import wall as wall_ops
from .bonded import pair_bond_forces, shift_bond_forces
from .neighbor import pairwise_forces_dense
from .pair_kernels import STEP_ROW, StepScalars, _check_tensor
from ..utils import tracing

_SUMS = 5   # reaction x, y, z; bonded energy; wall energy (the source's kSums)
_NUC_ROWS = 256      # the source's kNucRows and kNucTable: what a block stages
_NUC_TABLE = 1024
_DROPLET_EXPONENT = 6   # softwell<6>, as the reference's droplet


class NucleolarRows(NamedTuple):
    """The nucleolar bonds and droplet: NOR semisprings between the bonds'
    two beads (K / s^2 and l * s at the bond scale s of the :class:`BondRows`
    they ride with) and the droplet's softwell<6> attraction among
    ``targets`` (force cut at ``droplet_cutoff``, energy shifted to zero
    there; no targets: no droplet).  ``table`` holds both as the rest kernel
    reads them (:func:`nucleolar_table`), on the positions' device."""

    bonds: torch.Tensor       # (B, 2) int64
    targets: torch.Tensor     # (T,) int64
    spring: float
    length: float
    droplet_energy: float
    droplet_decay: float
    droplet_cutoff: float
    table: torch.Tensor       # int32, see nucleolar_table


class BondRows(NamedTuple):
    """Row-aligned chain bonds (i, i + 1) and loops (i, i + 2), as
    ``shift_bond_forces`` takes them: (N,) masks and per-row parameters; at
    bond scale s the springs are K / s^2 and the chain lengths l * s.  The
    nucleolar bonds and droplet, when there are any, ride along."""

    mask: torch.Tensor                   # (N,) bool
    spring: torch.Tensor                 # (N,) f32
    length: torch.Tensor                 # (N,) f32
    loop_mask: Optional[torch.Tensor]    # (N,) bool, or None: no loops
    loop_spring: Optional[torch.Tensor]  # (N,) f32
    scale: float
    nucleolar: Optional[NucleolarRows] = None


class WallRows(NamedTuple):
    """The wall of ``ops/wall.py``: semiaxes (3,) or (R, 3), the per-bead
    weights (N,) and the parameter dict (half diameters, core-scaled)."""

    semiaxes: torch.Tensor
    a_mix: torch.Tensor
    b_mix: torch.Tensor
    params: dict


class UpdateRows(NamedTuple):
    """The Brownian update fused into the rest kernel: mobility (N,), the
    standard normals of the positions' shape, kT and dt; the wall ODE's rate
    dt * wall mobility and its three springs."""

    mobility: torch.Tensor
    noise: torch.Tensor
    temperature: float
    timestep: float
    ode_rate: float
    spring: tuple


class RestResult(NamedTuple):
    out: torch.Tensor                    # forces, or the new positions
    reaction: Optional[torch.Tensor]     # (3,) or (R, 3); None without the wall
    bonded_energy: object                # summed over replicas; 0.0 unless asked for
    wall_energy: object
    semiaxes: Optional[torch.Tensor]     # after the wall ODE, with an update


class _RestArgs(ctypes.Structure):
    """The source's ``RestArgs``, field for field."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("f_in", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("replicas", ctypes.c_int), ("n", ctypes.c_int),
        ("bond_mask", ctypes.c_void_p), ("bond_k", ctypes.c_void_p),
        ("bond_l", ctypes.c_void_p), ("loop_mask", ctypes.c_void_p),
        ("loop_k", ctypes.c_void_p),
        ("bond_s2", ctypes.c_float), ("bond_s", ctypes.c_float),
        ("nuc_table", ctypes.c_void_p), ("nuc_rows", ctypes.c_int),
        ("nuc_partners", ctypes.c_int), ("nuc_targets", ctypes.c_int),
        ("nuc_k", ctypes.c_float), ("nuc_l", ctypes.c_float),
        ("drop_e", ctypes.c_float), ("drop_inv_d2", ctypes.c_float),
        ("drop_cut2", ctypes.c_float), ("drop_u_cut", ctypes.c_float),
        ("semiaxes", ctypes.c_void_p), ("wall_a", ctypes.c_void_p),
        ("wall_b", ctypes.c_void_p),
        ("e_a", ctypes.c_float), ("inv_da2", ctypes.c_float), ("e_b", ctypes.c_float),
        ("inv_db2", ctypes.c_float), ("packing_spring", ctypes.c_float),
        ("mobility", ctypes.c_void_p), ("noise", ctypes.c_void_p),
        ("dt", ctypes.c_float), ("two_t", ctypes.c_float),
        ("ode_rate", ctypes.c_float), ("spring", ctypes.c_float * 3),
        ("semiaxes_out", ctypes.c_void_p),
        ("partials", ctypes.c_void_p), ("tickets", ctypes.c_void_p),
        ("reaction", ctypes.c_void_p), ("energy", ctypes.c_void_p),
        ("step_rows", ctypes.c_void_p), ("step_index", ctypes.c_void_p),
    ]


# One ticket counter a replica and one for the launch (the replicas' last
# blocks) for each card and stream, zero between launches (the last block of
# a launch resets its replica's).  Launches on one stream run one after the
# other, so they never share a ticket at once.
_tickets: dict = {}


def _library():
    lib = _build.load_library("step_rest")
    if not lib.step_rest_launch.argtypes:
        lib.step_rest_launch.argtypes = [ctypes.POINTER(_RestArgs), ctypes.c_void_p]
        lib.step_rest_launch.restype = ctypes.c_int
        lib.step_rest_blocks.argtypes = [ctypes.c_int]
        lib.step_rest_blocks.restype = ctypes.c_int
        lib.step_rest_args_size.restype = ctypes.c_int
        lib.bd_update_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                                         + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 3)
        lib.bd_update_launch.restype = ctypes.c_int
        if lib.step_rest_args_size() != ctypes.sizeof(_RestArgs):
            raise RuntimeError("step_rest.cu's RestArgs and the wrapper's copy differ")
    return lib


def _tickets_for(device, stream, replicas):
    key = (device, stream)
    held = _tickets.get(key)
    if held is None or held.shape[0] < replicas + 1:
        held = torch.zeros(max(replicas + 1, 8), dtype=torch.int32, device=device)
        _tickets[key] = held
    return held


def release_tickets(device, stream):
    """Take the tickets of a card and stream out of the cache and return
    them (None if there are none): a CUDA graph captured on that stream
    keeps them for its replays."""
    return _tickets.pop((torch.device(device), stream), None)


def bond_scalars(scale: float):
    """(s^2, s) at bond scale s, in float64, as the rest kernel takes them."""
    s = float(scale)
    return s * s, s


def wall_scalars(params: dict):
    """(e_a, 1/d_a^2, e_b, 1/d_b^2) of the wall's parameter dict, in
    float64, as the rest kernel takes them."""
    return (float(params["a_energy"]), 1.0 / (float(params["a_diameter"]) ** 2),
            float(params["b_energy"]), 1.0 / (float(params["b_diameter"]) ** 2))


def _rows(name, tensor, dtype, n, device):
    _check_tensor(name, tensor, dtype, (n,), device, 4 if dtype == torch.float32 else 1)
    return tensor.data_ptr()


def nucleolar_table(bonds, targets) -> torch.Tensor:
    """The rest kernel's nucleolar table, int32 on the bonds' device:
    [rows (M) | start (M + 1) | target (M) | partner (P) | targets (T)].
    ``rows`` are the M beads with a nucleolar term (bond ends and droplet
    targets), sorted, and every other entry names a bead by its slot k in
    ``rows``: the partners of ``rows[k]`` are
    ``partner[start[k]:start[k + 1]]``, the slot of the bond's second bead at
    its first (which counts the bond's energy) and ~slot of the first at the
    second; ``targets`` are the droplet's targets and ``target[k]`` is the
    row's index among them, or -1."""
    pairs = bonds.detach().cpu().numpy().astype(np.int64).reshape(-1, 2)
    drop = targets.detach().cpu().numpy().astype(np.int64).reshape(-1)
    rows = np.unique(np.concatenate([pairs.reshape(-1), drop]))
    slot = {int(row): k for k, row in enumerate(rows)}
    partners = [[] for _ in rows]
    for i, j in pairs.tolist():
        partners[slot[i]].append(slot[j])
        partners[slot[j]].append(~slot[i])
    start = np.cumsum([0] + [len(p) for p in partners])
    target = np.full(len(rows), -1, np.int64)
    target[[slot[int(v)] for v in drop]] = np.arange(len(drop))
    flat = np.concatenate([rows, start, target,
                           np.asarray([v for p in partners for v in p], np.int64),
                           np.asarray([slot[int(v)] for v in drop], np.int64)])
    return torch.as_tensor(flat.astype(np.int32), device=bonds.device)


def _droplet_energy_at(r2, nucleolar: NucleolarRows):
    """softwell<6> energy of the droplet at r2 (a float), not shifted."""
    t = (r2 / (nucleolar.droplet_decay * nucleolar.droplet_decay)) ** (_DROPLET_EXPONENT // 2)
    return -nucleolar.droplet_energy / (1.0 + t)


def _nucleolar_args(args, nucleolar: NucleolarRows, device):
    partners, targets = 2 * nucleolar.bonds.shape[0], nucleolar.targets.shape[0]
    rows = (nucleolar.table.numel() - 1 - partners - targets) // 3
    if rows > _NUC_ROWS or nucleolar.table.numel() > _NUC_TABLE:
        raise ValueError(f"{rows} nucleolar rows, a table of {nucleolar.table.numel()}: the "
                         f"rest kernel takes at most {_NUC_ROWS} and {_NUC_TABLE}")
    _check_tensor("nucleolar table", nucleolar.table, torch.int32,
                  (3 * rows + 1 + partners + targets,), device, 4)
    args.nuc_table = nucleolar.table.data_ptr()
    args.nuc_rows, args.nuc_partners, args.nuc_targets = rows, partners, targets
    args.nuc_k, args.nuc_l = float(nucleolar.spring), float(nucleolar.length)
    cutoff2 = float(nucleolar.droplet_cutoff) ** 2
    args.drop_e = float(nucleolar.droplet_energy)
    args.drop_inv_d2 = 1.0 / float(nucleolar.droplet_decay) ** 2
    args.drop_cut2 = cutoff2
    args.drop_u_cut = _droplet_energy_at(cutoff2, nucleolar)


def _stacked(positions):
    """(R, N) of positions (N, 3) or (R, N, 3)."""
    if positions.dim() == 2:
        return 1, positions.shape[0]
    if positions.dim() == 3:
        return positions.shape[0], positions.shape[1]
    raise ValueError(f"positions of shape {tuple(positions.shape)}: expected (N, 3) or (R, N, 3)")


def launch_rest(positions, forces=None, bonds: Optional[BondRows] = None,
                wall: Optional[WallRows] = None, update: Optional[UpdateRows] = None,
                with_energy: bool = False, in_place: bool = False,
                scalars: Optional[StepScalars] = None, out=None,
                semiaxes_out=None) -> RestResult:
    """One launch of ``step_rest_kernel`` on CUDA float32 tensors.

    ``forces`` (of the positions' shape, or None for zeros) plus the chain
    and loop bonds, the nucleolar bonds and droplet, and the wall.  Without ``update`` the result's ``out``
    holds the forces (``forces`` itself with ``in_place``); with it, the new
    positions x + mu F dt + sqrt(2 mu kT dt) xi and the semiaxes moved by
    the wall ODE.  The reaction is per replica: (3,) for positions (N, 3),
    (R, 3) for (R, N, 3).  With ``with_energy`` the bonded (nucleolar terms
    included) and the wall energies, each summed over all beads.

    The reaction, the energies and the new semiaxes are written by the
    launch's last block, found by a ticket counter kept for the current
    stream: a launch must not run beside another launch on the same stream
    (as it cannot, unless the stream's work is reordered by hand).

    With ``scalars`` the kernel reads the bond scale's s^2, s and the wall's
    e_a, 1/d_a^2, e_b, 1/d_b^2 from the step's row on the card, not from
    ``bonds.scale`` and ``wall.params``, and advances the row's index: the
    form a CUDA graph of the G1 step replays (it needs the wall).  ``out``
    and ``semiaxes_out`` name the buffers the new positions and semiaxes go
    to, in place of new ones.
    """
    device = positions.device
    if device.type != "cuda":
        raise ValueError(f"the rest kernel runs on a CUDA tensor, not on {device}")
    replicas, n = _stacked(positions)
    shape = tuple(positions.shape)
    if shape[-1] != 3:
        raise ValueError(f"positions of shape {shape}: expected (N, 3) or (R, N, 3)")
    _check_tensor("positions", positions, torch.float32, shape, device, 4)
    if n * replicas >= 2 ** 31 // 3:
        raise ValueError("bead count does not fit 32-bit indices")
    args = _RestArgs()
    args.x = positions.data_ptr()
    args.replicas, args.n = replicas, n
    if forces is not None:
        _check_tensor("forces", forces, torch.float32, shape, device, 4)
        args.f_in = forces.data_ptr()
    if bonds is not None:
        s = float(bonds.scale)
        args.bond_mask = _rows("bond mask", bonds.mask, torch.bool, n, device)
        args.bond_k = _rows("bond springs", bonds.spring, torch.float32, n, device)
        args.bond_l = _rows("bond lengths", bonds.length, torch.float32, n, device)
        if bonds.loop_mask is not None:
            args.loop_mask = _rows("loop mask", bonds.loop_mask, torch.bool, n, device)
            args.loop_k = _rows("loop springs", bonds.loop_spring, torch.float32, n, device)
        args.bond_s2, args.bond_s = bond_scalars(s)
        if bonds.nucleolar is not None:
            _nucleolar_args(args, bonds.nucleolar, device)
    if semiaxes_out is not None and (update is None or wall is None):
        raise ValueError("new semiaxes come only from the update with the wall")
    reaction = None
    # No bead launches no block: the sums are zero (a rank may own no bead).
    alloc = torch.empty if n else torch.zeros
    if wall is not None:
        semi_shape = (3,) if positions.dim() == 2 else (replicas, 3)
        _check_tensor("semiaxes", wall.semiaxes, torch.float32, semi_shape, device, 4)
        args.semiaxes = wall.semiaxes.data_ptr()
        args.wall_a = _rows("wall weights a", wall.a_mix, torch.float32, n, device)
        args.wall_b = _rows("wall weights b", wall.b_mix, torch.float32, n, device)
        p = wall.params
        args.e_a, args.inv_da2, args.e_b, args.inv_db2 = wall_scalars(p)
        args.packing_spring = float(p["packing_spring"])
        reaction = alloc(semi_shape, dtype=torch.float32, device=device)
        args.reaction = reaction.data_ptr()
    if update is not None:
        if in_place:
            raise ValueError("the update writes new positions out of place")
        args.mobility = _rows("mobility", update.mobility, torch.float32, n, device)
        _check_tensor("noise", update.noise, torch.float32, shape, device, 4)
        args.noise = update.noise.data_ptr()
        args.dt, args.two_t = float(update.timestep), 2.0 * float(update.temperature)
        if wall is not None:
            args.ode_rate = float(update.ode_rate)
            args.spring = (ctypes.c_float * 3)(*(float(v) for v in update.spring))
            if semiaxes_out is not None:
                _check_tensor("semiaxes out", semiaxes_out, torch.float32, semi_shape, device, 4)
            elif n:
                semiaxes_out = torch.empty_like(reaction)
            else:
                springs = torch.tensor(update.spring, dtype=torch.float32, device=device)
                semiaxes_out = wall.semiaxes - update.ode_rate * springs * wall.semiaxes
            args.semiaxes_out = semiaxes_out.data_ptr()
    if in_place:
        if forces is None:
            raise ValueError("in place needs a force buffer")
        out = forces
    elif out is not None:
        _check_tensor("out", out, torch.float32, shape, device, 4)
    else:
        out = torch.empty_like(positions)
    args.out = out.data_ptr()
    if scalars is not None:
        if wall is None:
            raise ValueError("the step's scalars from the card need the wall")
        _check_tensor("step index", scalars.index, torch.int32, (1,), device, 4)
        _check_tensor("step rows", scalars.rows, torch.float32,
                      (scalars.rows.shape[0], STEP_ROW), device, 16)
        args.step_rows, args.step_index = scalars.rows.data_ptr(), scalars.index.data_ptr()
    energy = None
    if with_energy:
        energy = alloc((replicas, 2), dtype=torch.float32, device=device)
        args.energy = energy.data_ptr()
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    if wall is not None or with_energy:
        partials = torch.empty(replicas * lib.step_rest_blocks(n) * _SUMS,
                               dtype=torch.float32, device=device)
        args.partials = partials.data_ptr()
        args.tickets = _tickets_for(device, stream, replicas).data_ptr()
    with torch.cuda.device(device):
        status = lib.step_rest_launch(ctypes.byref(args), stream)
    if status != 0:
        raise RuntimeError(f"step_rest kernel launch failed: CUDA error {status}")
    tracing.count("launch.step_rest")
    if energy is None:
        bonded_energy = wall_energy = 0.0
    else:
        bonded_energy, wall_energy = energy.sum(dim=0).unbind()
    return RestResult(out, reaction, bonded_energy, wall_energy, semiaxes_out)



def chain_bonds_reference(positions, bonds: BondRows):
    """Plain chain bonds and loops: (forces, energy) by ``shift_bond_forces``.
    Chain bonds rescale fluctuation-preserving, K/s^2 and l*s
    (simulation_driver_forcefield.cpp:78-88); the uniform (i, i+1) and
    (i, i+2) offsets take the shift formulation (rolls, no gather/scatter)."""
    s2 = bonds.scale * bonds.scale
    k_bond = bonds.spring / s2
    l_bond = bonds.length * bonds.scale
    forces, energy = shift_bond_forces(
        positions, 1, bonds.mask,
        lambda r2: potentials.semispring_energy(r2, k_bond, l_bond),
        lambda r2: potentials.semispring_force_coeff(r2, k_bond, l_bond),
    )
    if bonds.loop_mask is not None:
        k_loop = bonds.loop_spring / s2
        f, e = shift_bond_forces(
            positions, 2, bonds.loop_mask,
            lambda r2: potentials.harmonic_energy(r2, k_loop),
            lambda r2: potentials.harmonic_force_coeff(r2, k_loop),
        )
        forces, energy = forces + f, energy + e
    return forces, energy


def nucleolar_reference(positions, nucleolar: NucleolarRows, scale: float):
    """Plain nucleolar bonds and droplet: (forces, energy), the NOR
    semisprings K / s^2, l * s by ``pair_bond_forces`` and the droplet by
    ``pairwise_forces_dense`` over its targets, as the JAX package's
    ``bonded_forces`` forms them."""
    s2 = scale * scale
    k_nuc = nucleolar.spring / s2
    l_nuc = nucleolar.length * scale
    forces, energy = pair_bond_forces(
        positions, nucleolar.bonds,
        lambda r2: potentials.semispring_energy(r2, k_nuc, l_nuc),
        lambda r2: potentials.semispring_force_coeff(r2, k_nuc, l_nuc),
    )
    if nucleolar.targets.shape[0]:
        e, decay, cutoff = (nucleolar.droplet_energy, nucleolar.droplet_decay,
                            nucleolar.droplet_cutoff)

        def drop_u(r2, i, j):
            return potentials.cutoff_shift(
                lambda q: potentials.softwell_energy(q, e, decay, _DROPLET_EXPONENT), r2, cutoff)

        def drop_c(r2, i, j):
            coeff = potentials.softwell_force_coeff(r2, e, decay, _DROPLET_EXPONENT)
            return torch.where(r2 < cutoff * cutoff, coeff, torch.zeros_like(coeff))

        f, u = pairwise_forces_dense(positions, drop_c, drop_u, targets=nucleolar.targets)
        forces, energy = forces + f, energy + u
    return forces, energy


def rest_reference(positions, forces=None, bonds: Optional[BondRows] = None,
                   wall: Optional[WallRows] = None, update: Optional[UpdateRows] = None,
                   with_energy: bool = False) -> RestResult:
    """Plain version of :func:`rest` (and so of the rest kernel), in the
    positions' dtype or wider: the bonds by :func:`chain_bonds_reference`
    and :func:`nucleolar_reference`, the wall by autograd, the update by
    ``bd_update_reference`` on the handed-in noise, then the wall ODE
    a + rate (reaction - spring a)."""
    out = torch.zeros_like(positions) if forces is None else forces
    bonded_energy = wall_energy = 0.0
    reaction = semiaxes = None
    if bonds is not None:
        f, bonded_energy = chain_bonds_reference(positions, bonds)
        if bonds.nucleolar is not None:
            f_nuc, e_nuc = nucleolar_reference(positions, bonds.nucleolar, bonds.scale)
            f, bonded_energy = f + f_nuc, bonded_energy + e_nuc
        out = out + f
    if wall is not None:
        f, reaction, wall_energy = wall_ops.wall_forces_reference(
            positions, wall.semiaxes, wall.a_mix, wall.b_mix, wall.params)
        out = out + f
    if not with_energy:
        bonded_energy = wall_energy = 0.0
    if update is not None:
        out = integrator.bd_update_reference(
            positions, out, update.mobility, None,
            integrator.BDParams(update.temperature, update.timestep), noise=update.noise)
        if wall is not None:
            spring = torch.as_tensor(update.spring, dtype=wall.semiaxes.dtype,
                                     device=wall.semiaxes.device)
            semiaxes = wall.semiaxes + update.ode_rate * (reaction - spring * wall.semiaxes)
    return RestResult(out, reaction, bonded_energy, wall_energy, semiaxes)


@tracing.traced("rest")
def rest(positions, forces=None, bonds: Optional[BondRows] = None,
         wall: Optional[WallRows] = None, update: Optional[UpdateRows] = None,
         with_energy: bool = False) -> RestResult:
    """``forces`` (None for zeros) plus the chain bonds and loops (and the
    nucleolar terms that ride with them) and the wall, each left out when
    None; with ``update``, the G1 step's new
    positions and semiaxes instead of the forces.

    On a CUDA tensor one launch of the rest kernel, or the call raises;
    without ``update`` it adds into ``forces`` in place.  On a CPU tensor the
    plain version :func:`rest_reference`."""
    if positions.device.type != "cuda":
        return rest_reference(positions, forces, bonds, wall, update, with_energy)
    return launch_rest(positions, forces, bonds, wall, update, with_energy,
                       in_place=forces is not None and update is None)


def launch_update(positions, forces, mobility, noise, temperature: float, timestep: float,
                  spacestep: Optional[float] = None):
    """x + mu F dt_eff + sqrt(2 mu kT dt_eff) xi on CUDA float32 tensors,
    positions (N, 3) or (R, N, 3), out of place; ``dt_eff`` is the timestep,
    or with ``spacestep`` each replica's timestep limited so that its largest
    |mu F| dt_eff does not exceed it (computed on the device)."""
    device = positions.device
    if device.type != "cuda":
        raise ValueError(f"the update kernel runs on a CUDA tensor, not on {device}")
    replicas, n = _stacked(positions)
    shape = tuple(positions.shape)
    for name, tensor in (("positions", positions), ("forces", forces), ("noise", noise)):
        _check_tensor(name, tensor, torch.float32, shape, device, 4)
    _rows("mobility", mobility, torch.float32, n, device)
    out = torch.empty_like(positions)
    dt_eff = None
    if spacestep is not None:
        dt_eff = torch.empty(replicas, dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        status = lib.bd_update_launch(
            positions.data_ptr(), forces.data_ptr(), mobility.data_ptr(), noise.data_ptr(),
            replicas, n, float(timestep), 2.0 * float(temperature),
            float(spacestep) if spacestep is not None else 0.0,
            dt_eff.data_ptr() if dt_eff is not None else None, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"bd_update kernel launch failed: CUDA error {status}")
    tracing.count("launch.bd_update")
    return out
