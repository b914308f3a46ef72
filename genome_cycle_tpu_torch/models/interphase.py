"""Interphase stage driver: relaxation + G1 expansion with moving wall.

PyTorch counterpart of the JAX package's ``models/interphase.py``, itself a
re-design of the reference interphase driver
(``stage_interphase/simulation_driver*.cpp``, SURVEY.md §2.7).  The hot loop —
cell layout, A/B copolymer forces, bonds, nucleolus, wall with axial-reaction
feedback, BD update, scheduled expansion, wall ODE and contact counting — is a
Python loop over steps whose tensors never leave the device; the host sees
the state only when a frame is sampled, and a tick sizes its event list.

Above ``brute_force_threshold`` the pair force and its energy are computed by
the hand-written CUDA kernel of ``ops/pair_kernels.py`` over sorted cell
ranges.  That layout has no per-cell capacity, so the capacity probing,
overflow retries and engine switches of the JAX ``run_interphase`` have no
counterpart here.  On the card the rest of a step is hand-written too: the
chain and loop bonds, the nucleolar bonds and droplet, the wall and (in G1)
the Brownian update with the wall ODE in one launch of
``csrc/step_rest.cu``, the relaxation's update in another, and the tick in
``csrc/contact_tick.cu`` (its event buffer's size kept on the model).  On
the CPU every one of these runs its plain version.

The stage around the steps is written once, for one store and for R stores
in lock-step: :func:`run_relaxation`, :func:`start_g1` (a fresh start or a
resume from the stores' checkpoints) and :func:`run_g1_frames`, which write
through one frame writer, :func:`save_g1_frame`.  :func:`run_interphase`
and ``parallel/ensemble.run_ensemble_interphase`` are thin wrappers around
them.

Known deliberate cadence deviation (documented, within stochastic tolerance):
the reference samples the frame context *before* the per-step scale/wall
update of the same callback; we record the post-update values, a half-step
phase shift of order dt in the logged (not simulated) context.
"""

from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..config import InterphaseConfig, SimulationConfig
from ..store import InterphaseContext, StageDesign
from ..ops import potentials as pot
from ..ops.bonded import chain_bond_pairs, loop_bond_pairs
from ..ops.contact import (
    EventCapacity,
    contact_events,
    empty_window_acc,
    events_to_host,
    merge_events_acc,
    merge_window,
    split_window,
)
from ..ops import step_rest
from ..ops.integrator import BDParams, bd_update, standard_normal
from ..ops.neighbor import pairwise_forces_dense
from ..ops.pair_kernels import ab_pair_forces, build_cell_layout
from ..ops.step_rest import BondRows, NucleolarRows, UpdateRows, WallRows
from ..ops.wall import wall_forces
from ..utils import tracing
from ..utils.logging import progress_line
from . import g1_graph


@dataclasses.dataclass(frozen=True)
class EngineSettings:
    """Engine knobs (not part of the reference JSON schema)."""

    # At or below this particle count the O(N^2) dense path computes the pair
    # force; above it the cell-range kernel does.
    brute_force_threshold: int = 16384
    # Initial half-width of the cell grid; run_interphase refreshes it from
    # the occupied extent once per sampling chunk.
    dense_bound: float = 4.0
    dtype: str = "float32"
    # Rows of the device-resident contact-window accumulator (unique (i, j)
    # pairs per output window).  None = auto; it grows on demand.
    acc_capacity: Optional[int] = None


# Per-bead arrays of the model, under the field names of the JAX dataclass.
ARRAY_FIELDS = (
    "af", "bf", "mobility",
    "bond_pairs", "bond_spring", "bond_length",
    "loop_pairs", "loop_spring",
    "bond_mask", "bond_k_row", "bond_l_row",
    "loop_mask", "loop_k_row",
    "nuc_bonds", "nuc_targets",
)
_INT_FIELDS = ("bond_pairs", "loop_pairs", "nuc_bonds", "nuc_targets")
_BOOL_FIELDS = ("bond_mask", "loop_mask")


def design_arrays(design: StageDesign, icfg: InterphaseConfig) -> dict:
    """The model's per-bead numpy arrays from a stage design."""
    n = design.particle_count
    ab = np.zeros((n, 2))
    ab[: design.ab_factors.shape[0]] = design.ab_factors
    af, bf = ab[:, 0], ab[:, 1]

    # Mobility: a >= b -> a_core_mobility else b_core_mobility; nucleolar
    # particles override (simulation_driver_particles.cpp:19-34).
    mobility = np.where(af >= bf, icfg.a_core_mobility, icfg.b_core_mobility)
    if design.nucleolar_bonds is not None and len(design.nucleolar_bonds):
        mobility[design.nucleolar_bonds[:, 1]] = icfg.nucleolus_mobility

    # Per-bond mixed parameters (simulation_driver_forcefield.cpp:61-96):
    # K = a_mix K_A + b_mix K_B, l = a_mix l_A + b_mix l_B.
    bond_pairs = np.asarray(chain_bond_pairs(design.chains))
    if len(bond_pairs):
        a_mix = 0.5 * (af[bond_pairs[:, 0]] + af[bond_pairs[:, 1]])
        b_mix = 0.5 * (bf[bond_pairs[:, 0]] + bf[bond_pairs[:, 1]])
        bond_spring = a_mix * icfg.a_core_bond_spring + b_mix * icfg.b_core_bond_spring
        bond_length = a_mix * icfg.a_core_bond_length + b_mix * icfg.b_core_bond_length
    else:
        bond_spring = np.zeros((0,))
        bond_length = np.zeros((0,))

    loop_pairs = np.asarray(loop_bond_pairs(design.chains))
    if len(loop_pairs):
        a_mix = 0.5 * (af[loop_pairs[:, 0]] + af[loop_pairs[:, 1]])
        b_mix = 0.5 * (bf[loop_pairs[:, 0]] + bf[loop_pairs[:, 1]])
        loop_spring = (
            a_mix * icfg.a_core_2nd_bond_spring + b_mix * icfg.b_core_2nd_bond_spring
        )
    else:
        loop_spring = np.zeros((0,))

    # Row-aligned shift-bond views: bond (i, i+1) / loop (i, i+2) params
    # land on row i; rows without a bond mask out.
    bond_mask = np.zeros((n,), bool)
    bond_k_row = np.zeros((n,))
    bond_l_row = np.zeros((n,))
    if len(bond_pairs):
        bond_mask[bond_pairs[:, 0]] = True
        bond_k_row[bond_pairs[:, 0]] = bond_spring
        bond_l_row[bond_pairs[:, 0]] = bond_length
    loop_mask = np.zeros((n,), bool)
    loop_k_row = np.zeros((n,))
    if len(loop_pairs):
        loop_mask[loop_pairs[:, 0]] = True
        loop_k_row[loop_pairs[:, 0]] = loop_spring

    nuc_bonds = (
        design.nucleolar_bonds
        if design.nucleolar_bonds is not None
        else np.zeros((0, 2), np.int64)
    )
    nuc_targets = np.unique(nuc_bonds[:, 1]) if len(nuc_bonds) else np.zeros(0, np.int64)

    return dict(
        af=af, bf=bf, mobility=mobility,
        bond_pairs=bond_pairs, bond_spring=bond_spring, bond_length=bond_length,
        loop_pairs=loop_pairs, loop_spring=loop_spring,
        bond_mask=bond_mask, bond_k_row=bond_k_row, bond_l_row=bond_l_row,
        loop_mask=loop_mask, loop_k_row=loop_k_row,
        nuc_bonds=nuc_bonds, nuc_targets=nuc_targets,
    )


class InterphaseModel(nn.Module):
    """Static system description (per-bead arrays as buffers) + step functions
    for the interphase run.

    The step state is a tuple ``(x, generator, semiaxes)``: positions (N, 3),
    a ``torch.Generator`` on the positions' device, wall semiaxes (3,).  The
    same steps take R replicas of the system in lock-step
    (``parallel/ensemble.py``): positions (R, N, 3), a sequence of R
    generators, semiaxes (R, 3).  The replicas share one cell layout, and so
    one launch of the pair kernel a step, and nothing else: each has its own
    wall, noise and displacement limit.
    """

    def __init__(
        self,
        config: InterphaseConfig,
        arrays: dict,
        settings: Optional[EngineSettings] = None,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        settings = settings or EngineSettings()
        self.config = config
        self.settings = settings
        f = torch.float32 if settings.dtype == "float32" else torch.float64
        self.dtype = f
        for name in ARRAY_FIELDS:
            value = np.asarray(arrays[name])
            if name in _INT_FIELDS:
                shape = (-1, 2) if name != "nuc_targets" else (-1,)
                tensor = torch.as_tensor(value.astype(np.int64)).reshape(shape)
            elif name in _BOOL_FIELDS:
                tensor = torch.as_tensor(value.astype(bool))
            else:
                tensor = torch.as_tensor(value.astype(np.float64)).to(f)
            self.register_buffer(name, tensor.to(device))
        self.n = int(self.af.shape[0])
        self.use_loops = bool(self.loop_pairs.shape[0]) and bool(
            np.any(np.asarray(arrays["loop_spring"]) != 0)
        )
        self.use_droplet = (
            config.nucleolus_droplet_energy != 0 and self.nuc_targets.shape[0] > 1
        )
        # The nucleolar bonds and droplet as the rest kernel reads them.
        self.register_buffer("nuc_table", step_rest.nucleolar_table(
            self.nuc_bonds, self.nuc_targets if self.use_droplet else self.nuc_targets[:0]),
            persistent=False)
        # Derived per-bead wall weights (a_i + wall_a)/2, (b_i + wall_b)/2.
        self.register_buffer(
            "wall_a", 0.5 * (self.af + config.wall_ab_factor.a), persistent=False
        )
        self.register_buffer(
            "wall_b", 0.5 * (self.bf + config.wall_ab_factor.b), persistent=False
        )
        self.register_buffer(
            "wall_spring",
            torch.as_tensor(config.wall_semiaxes_spring, dtype=f, device=device),
            persistent=False,
        )
        # One grid serves the pair force AND the contact tick: the cell
        # covers both the interaction diameter and the largest contact cutoff
        # the schedule can reach (monotonic between core_scale_init and 1).
        max_core = max(1.0, config.core_scale_init)
        self.cell = max_core * max(
            config.a_core_diameter, config.b_core_diameter,
            config.contactmap_distance,
        )
        self.bound = float(settings.dense_bound)
        # Rows of the tick kernel's event buffer, grown when a tick overflows.
        self.tick_capacity = EventCapacity()
        # The CUDA graphs of the G1 step on the card (models/g1_graph.py).
        self._step_graph = None

    @property
    def device(self):
        return self.af.device

    # -- construction --------------------------------------------------------

    @classmethod
    def from_design(
        cls,
        design: StageDesign,
        config: SimulationConfig,
        settings: Optional[EngineSettings] = None,
        device=None,
    ) -> "InterphaseModel":
        icfg = config.interphase
        return cls(icfg, design_arrays(design, icfg), settings, device)

    def update_bound(self, max_abs_coord: float):
        """Track the occupied extent; the grid stays tight around it (beads
        beyond it are clipped into edge cells: still right, but slower)."""
        needed = float(np.ceil(max_abs_coord + 0.5))
        if abs(needed - self.bound) >= 1.0 or needed > self.bound:
            self.bound = needed
            return True
        return False

    # -- scale schedule ------------------------------------------------------

    def scales(self, t: float):
        """Scheduled G1 decompaction (simulation_driver_interphase.cpp:67-76);
        host floats, so the schedule costs no device work."""
        c = self.config
        core = 1.0 - (1.0 - c.core_scale_init) * math.exp(-t / c.core_scale_tau)
        bond = 1.0 - (1.0 - c.bond_scale_init) * math.exp(-t / c.bond_scale_tau)
        return core, bond

    # -- force field ---------------------------------------------------------

    def _ab_params(self, core_scale):
        c = self.config
        return dict(
            a_energy=c.a_core_repulsion,
            a_diameter=c.a_core_diameter * core_scale,
            b_energy=c.b_core_repulsion,
            b_diameter=c.b_core_diameter * core_scale,
        )

    def _wall_params(self, core_scale):
        c = self.config
        return dict(
            a_energy=c.a_core_repulsion,
            a_diameter=c.a_core_diameter / 2 * core_scale,
            b_energy=c.b_core_repulsion,
            b_diameter=c.b_core_diameter / 2 * core_scale,
            packing_spring=c.wall_packing_spring,
        )

    def cell_layout(self, positions):
        """Cell-sorted layout of the current positions (of one system or of
        R replicas) on the model's grid."""
        return build_cell_layout(positions, self.af, self.bf, self.bound, self.cell)

    def nucleolar_rows(self) -> Optional[NucleolarRows]:
        """The nucleolar bonds and droplet, or None when the design has
        neither."""
        if not self.nuc_bonds.shape[0] and not self.use_droplet:
            return None
        c = self.config
        return NucleolarRows(
            self.nuc_bonds, self.nuc_targets if self.use_droplet else self.nuc_targets[:0],
            c.nucleolus_bond_spring, c.nucleolus_bond_length, c.nucleolus_droplet_energy,
            c.nucleolus_droplet_decay, c.nucleolus_droplet_cutoff, self.nuc_table,
        )

    def bond_rows(self, bond_scale) -> BondRows:
        """Every topology-indexed term at a bond scale, as the rest kernel
        takes them: chain bonds, loops, nucleolar bonds and droplet."""
        return BondRows(
            self.bond_mask, self.bond_k_row, self.bond_l_row,
            self.loop_mask if self.use_loops else None,
            self.loop_k_row if self.use_loops else None, bond_scale, self.nucleolar_rows(),
        )

    def bonded_forces(self, positions, bond_scale, with_energy=False):
        """All topology-indexed terms: chain bonds, loops, nucleolar bonds,
        nucleolar droplet (one launch of the rest kernel on the card).
        Cheap O(N).  Returns (forces, energy); the energy is 0.0 unless
        ``with_energy``."""
        bonded = step_rest.rest(positions, bonds=self.bond_rows(bond_scale),
                                with_energy=with_energy)
        return bonded.out, bonded.bonded_energy

    def pair_kernel_params(self, core_scale):
        """[e_a, 1/d_a^2, e_b, 1/d_b^2] of the pair kernel at a core scale."""
        params = self._ab_params(core_scale)
        return (
            params["a_energy"], 1.0 / (params["a_diameter"] * params["a_diameter"]),
            params["b_energy"], 1.0 / (params["b_diameter"] * params["b_diameter"]),
        )

    def pair_forces_full(self, positions, core_scale, with_energy=False):
        """A/B copolymer repulsion for the whole system: O(N^2) brute force
        at or below the threshold, the cell-range kernel above it.  Returns
        (forces of the positions' shape, energy)."""
        params = self._ab_params(core_scale)
        if self.n <= self.settings.brute_force_threshold:
            af, bf = self.af, self.bf

            def coeff(r2, i, j):
                return pot.ab_pair_force_coeff(
                    r2, 0.5 * (af[i] + af[j]), 0.5 * (bf[i] + bf[j]), params
                )

            def energy_fn(r2, i, j):
                return pot.ab_pair_energy(
                    r2, 0.5 * (af[i] + af[j]), 0.5 * (bf[i] + bf[j]), params
                )

            return pairwise_forces_dense(
                positions, coeff, energy_fn if with_energy else None
            )

        forces, energy = ab_pair_forces(
            self.cell_layout(positions), self.pair_kernel_params(core_scale), with_energy
        )
        return forces.reshape(positions.shape).to(positions.dtype), energy.to(positions.dtype)

    def wall_rows(self, semiaxes, core_scale) -> WallRows:
        """The wall at a core scale, as the rest kernel takes it."""
        return WallRows(semiaxes, self.wall_a, self.wall_b, self._wall_params(core_scale))

    def wall_forces_rows(self, positions, semiaxes, core_scale):
        """Nuclear envelope; returns (forces, reaction, energy)."""
        return wall_forces(
            positions, semiaxes, self.wall_a, self.wall_b,
            self._wall_params(core_scale),
        )

    def total_energy(self, positions, core_scale, bond_scale, semiaxes):
        _, _, energy = self._assemble_forces(
            positions, core_scale, bond_scale, semiaxes, with_energy=True
        )
        return energy

    # -- step functions ------------------------------------------------------

    def update_rows(self, noise) -> UpdateRows:
        """The G1 update as the rest kernel takes it: mobility, ``noise``,
        kT, dt and the wall ODE's rate and springs."""
        c = self.config
        return UpdateRows(self.mobility, noise, c.temperature, c.timestep,
                          c.timestep * c.wall_mobility, tuple(c.wall_semiaxes_spring))

    def _assemble_forces(self, x, core_scale, bond_scale, semiaxes,
                         with_energy=False):
        """Full force field.  Returns (forces, reaction, energy)."""
        forces, energy = self.pair_forces_full(x, core_scale, with_energy)
        rest = step_rest.rest(x, forces, self.bond_rows(bond_scale),
                              self.wall_rows(semiaxes, core_scale), with_energy=with_energy)
        if with_energy:
            energy = energy + rest.bonded_energy + rest.wall_energy
        return rest.out, rest.reaction, energy

    @torch.no_grad()
    def relaxation_step(self, carry, step, noise=None):
        """Displacement-limited BD at frozen init scales and wall
        (simulation_driver_relaxation.cpp:8-56)."""
        x, generator, semiaxes = carry
        c = self.config
        forces, _, _ = self._assemble_forces(
            x, c.core_scale_init, c.bond_scale_init, semiaxes
        )
        x = bd_update(
            x, forces, self.mobility, generator,
            BDParams(c.temperature, c.timestep, c.relaxation_spacestep),
            noise=noise,
        )
        return (x, generator, semiaxes)

    @tracing.traced("g1.step")
    @torch.no_grad()
    def _bd_step4(self, carry, step: int, noise=None):
        """Forces at lagged scales, BD update, wall ODE — everything except
        contact accounting (simulation_driver_interphase.cpp:16-63,79-90).

        On a float32 CUDA carry of the cell-range pair path the step is one
        replay of a CUDA graph of :meth:`_eager_step`'s launches
        (``models/g1_graph.py``): the returned positions and semiaxes are
        then the graph's buffers, which the step after next overwrites, so a
        caller reads or copies them before that.  Anywhere else it is
        :meth:`_eager_step`."""
        x = carry[0]
        if x.device.type == "cuda":
            if g1_graph.replays(self, x):
                return g1_graph.graph_step(self, carry, step, noise)
            tracing.count("graph.step_eager")
        return self._eager_step(carry, step, noise)

    @torch.no_grad()
    def _eager_step(self, carry, step: int, noise=None):
        """The G1 step launched call by call: the CPU's step and the card's
        yardstick for the graph.  On the card everything but the pair force
        (the bonded terms, the wall, the update and the wall ODE) is one
        launch of the rest kernel."""
        x, generator, semiaxes = carry
        c = self.config
        dt = c.timestep
        # Scales were last updated by the previous step's callback at
        # time (step-1) * dt.
        core_scale, bond_scale = self.scales((step - 1) * dt)

        forces, _ = self.pair_forces_full(x, core_scale)
        if noise is None:
            noise = standard_normal(x, generator)
        # Wall ODE: overdamped motion of the semiaxes under chromatin pressure
        # (simulation_driver_interphase.cpp:79-90), in the same call.
        rest = step_rest.rest(x, forces, self.bond_rows(bond_scale),
                              self.wall_rows(semiaxes, core_scale), self.update_rows(noise))
        return (rest.out, generator, rest.semiaxes)

    @tracing.traced("tick")
    @torch.no_grad()
    def contact_events_tick(self, x, step: int):
        """Fresh spatial search at a tick step -> contact events.

        Exactly the reference cadence and semantics: every
        ``contactmap_update_interval`` steps a full neighbor search at the
        *current* contact distance — the post-update positions and the core
        scale at ``step * dt`` — counts each in-range pair once
        (contact_map.cpp:33-63).  Returns (E, 3) int32 rows [i, j, 1]; for
        R replicas the ids are ``r * N + i`` and both beads of a row belong
        to one replica.
        """
        c = self.config
        core_now, _ = self.scales(step * c.timestep)
        return contact_events(self.cell_layout(x), c.contactmap_distance * core_now,
                              capacity=self.tick_capacity)

    def g1_chunk(self, carry, start: int, steps: int, window: "WindowAccumulator"):
        """G1 steps ``start + 1`` to ``start + steps``, each tick's contact
        events folded into ``window``.  Returns the new step state."""
        tick = self.config.contactmap_update_interval
        for step in range(start + 1, start + steps + 1):
            carry = self._bd_step4(carry, step)
            if step % tick == 0:
                window.add(self.contact_events_tick(carry[0], step))
        return carry


class WindowAccumulator:
    """The contact window on the device: tick events fold into sorted COO
    rows (``ops/contact.merge_events_acc``), and only the deduplicated window
    moves to the host, once per dump.  When the rows run out, the buffer
    grows past the watermark with headroom and the merge is run again.
    ``events`` counts the events folded into the current window (their
    number is known on the host: it costs no sync); a window's counts sum to
    it.  A merge run again counts ``window.merge_reruns``."""

    def __init__(self, particles: int, capacity: Optional[int], device, log=print):
        self.capacity = capacity or max(1 << 16, 16 * particles)
        self.device = device
        self.log = log
        self.acc, self.rows = empty_window_acc(self.capacity, device)
        self.events = 0

    @tracing.traced("merge")
    def add(self, events):
        while True:
            acc, rows, overflow = merge_events_acc(self.acc, self.rows, events)
            if overflow == 0:
                self.acc, self.rows = acc, rows
                self.events += events.shape[0]
                return
            self.capacity = -(-int((self.capacity + overflow) * 3 // 2) // 4096) * 4096
            self.log(f"engine: growing window accumulator to {self.capacity}")
            grown, _ = empty_window_acc(self.capacity, self.device)
            self.acc = torch.cat([self.acc, grown[self.acc.shape[0]:]])
            tracing.count("window.merge_reruns")

    @tracing.traced("dump")
    def take(self) -> np.ndarray:
        """The window's sorted (i, j, count) rows on the host; the window
        starts afresh."""
        with tracing.sync("take"):
            coo = self.acc[: self.rows].cpu().numpy()
        self.acc, self.rows = empty_window_acc(self.capacity, self.device)
        self.events = 0
        return coo


# -- the interphase stage, for one store or for R in lock-step ---------------
#
# The stage works on the carry the model's steps take: positions (N, 3) and
# one generator for one store (``run_interphase``), (R, N, 3) and R
# generators for R stores (``parallel/ensemble.py``).  Where the two runs
# write or log differently, the positions' shape selects.


def _clock(device) -> float:
    """Host seconds, the device synchronised first."""
    if device.type == "cuda":
        with tracing.sync("clock"):
            torch.cuda.synchronize(device)
    return _time.perf_counter()


def _to_host(tensor, site: str) -> np.ndarray:
    with tracing.sync(site):
        return tensor.detach().cpu().numpy()


def _refresh_bound(model: InterphaseModel, x, log):
    """Fit the grid to ``x``: for R stores one grid spans the widest."""
    with tracing.sync("refresh_bound"):
        extent = float(x.abs().max())
    if model.update_bound(extent):
        log(f"engine: grid bound -> {model.bound:g}")


def _per_store(value, x) -> list:
    """``value`` (positions, semiaxes, generators) as one entry a store:
    itself for one store (``x`` (N, 3)), its rows for R (``x`` (R, N, 3))."""
    return [value] if x.dim() == 2 else list(value)


def _from_stores(arrays, like):
    """One host array a store as a tensor of ``like``'s shape (one store's,
    or R stacked), dtype and device."""
    return torch.as_tensor(np.stack(arrays), dtype=like.dtype,
                           device=like.device).reshape(like.shape)


def _frame_energy(model: InterphaseModel, x, t: float, semiaxes) -> Optional[float]:
    """The mean energy a bead that a frame of one store carries (an energy
    pass and a sync); None for R stores, whose frames carry 0.0."""
    if x.dim() == 3:
        return None
    core, bond = model.scales(t)
    with torch.no_grad():
        energy = model.total_energy(x, core, bond, semiaxes)
    with tracing.sync("frame_energy"):
        return float(energy) / model.n


def _save_frames(stores, step: int, x, semiaxes, context: InterphaseContext, windows=None):
    """Frame ``step`` of every store in its current stage.  Positions and
    semiaxes go to the host once for all stores; then each store in order
    gets its positions, ``context`` with its own wall, its window when
    ``windows`` (one a store) is given (an empty one writes nothing), and
    ``append_frame``.  Returns the host copies."""
    axes = _to_host(semiaxes, "frame_context")
    positions = _to_host(x, "frame_positions")
    for k, (store, rows, wall) in enumerate(
            zip(stores, _per_store(positions, x), _per_store(axes, x))):
        store.save_positions(step, rows)
        store.save_interphase_context(step, dataclasses.replace(
            context, wall_semiaxes=tuple(float(v) for v in wall)))
        if windows is not None:
            store.save_contacts(step, windows[k])
        store.append_frame(step)
    return positions, axes


def save_g1_frame(stores, model: InterphaseModel, step: int, x, semiaxes, windows,
                  mean_energy: float):
    """Write G1 frame ``step`` of the carry's positions ``x`` and wall
    ``semiaxes`` into ``stores`` (one, or R in the carry's order): the
    context holds the time, the store's wall, the schedule's scales at that
    time and ``mean_energy``; ``windows``, when given, holds one contact
    window a store.  Returns the host copies of positions and semiaxes, from
    which :func:`save_g1_checkpoints` writes."""
    t = step * model.config.timestep
    core, bond = model.scales(t)
    return _save_frames(stores, step, x, semiaxes, InterphaseContext(
        time=t, core_scale=float(core), bond_scale=float(bond), mean_energy=mean_energy),
        windows)


def save_g1_checkpoints(stores, step: int, positions, axes, generator, x):
    """Every store's snapshot of the step state at ``step``, one store after
    another: a frame's host copies ``positions`` and ``axes`` and the state
    of each store's generator."""
    for store, rows, wall, g in zip(stores, _per_store(positions, x), _per_store(axes, x),
                                    _per_store(generator, x)):
        store.save_checkpoint(step, {"positions": rows, "semiaxes": wall,
                                     "key": g.get_state().numpy()})


def _window_written(log, timings, x, step: int, coo, events: int, capacity, seconds: float):
    """Record a written window in ``timings["windows"]``: its step, rows,
    the tick events folded into it (its counts sum to them), the
    accumulator's rows, the host seconds since the previous window.  A run
    of one store also logs it."""
    if timings is not None:
        timings.setdefault("windows", []).append(dict(
            step=step, rows=len(coo), events=int(events), capacity=capacity, seconds=seconds))
    if x.dim() == 2:
        log(f"window at step {step}: {len(coo)} pairs from {int(events)} events"
            + ("" if capacity is None else f", accumulator capacity {capacity}"))


def run_relaxation(stores, model: InterphaseModel, generator, device, log, timings: Optional[dict]):
    """The relaxation of every store from its structure at step 0, with
    ``generator`` (one, or a list of R: the carry stacks the stores) — a
    frame every ``relaxation_sampling_interval`` steps at the initial scales
    and wall.  Returns the step state at its end."""
    c = model.config
    for store in stores:
        store.set_stage("relaxation")
        store.clear_frames()
    rows = [torch.as_tensor(store.load_positions(0), dtype=model.dtype, device=device)
            for store in stores]
    x = rows[0] if isinstance(generator, torch.Generator) else torch.stack(rows)
    if x.shape[-2] != model.n:
        raise ValueError("initial structure size mismatch")
    semiaxes = torch.as_tensor(c.wall_semiaxes_init, dtype=model.dtype,
                               device=device).repeat(*x.shape[:-2], 1)

    def frame(step, x):
        _refresh_bound(model, x, log)
        energy = _frame_energy(model, x, 0.0, semiaxes)
        _save_frames(stores, step, x, semiaxes, InterphaseContext(
            time=0.0, core_scale=c.core_scale_init, bond_scale=c.bond_scale_init,
            mean_energy=0.0 if energy is None else energy))
        if step or x.dim() == 2:
            log(progress_line("relaxation", step, t=0.0, energy=energy))

    frame(0, x)
    t0 = _clock(device)
    state = (x, generator, semiaxes)
    n_chunks = c.relaxation_steps // c.relaxation_sampling_interval
    for chunk in range(n_chunks):
        for s in range(c.relaxation_sampling_interval):
            state = model.relaxation_step(state, s)
        frame((chunk + 1) * c.relaxation_sampling_interval, state[0])
    if timings is not None:
        timings["relaxation_seconds"] = _clock(device) - t0
        timings["relaxation_steps"] = n_chunks * c.relaxation_sampling_interval
    return state


def start_g1(stores, model: InterphaseModel, state, log, timings: Optional[dict]):
    """G1's start in every store, from the relaxed step ``state``.  Returns
    the step state and the step G1 goes on from.

    Intra-stage resume: a long G1 run snapshots its step state at contact
    window boundaries, and a run of the stage again goes on from the
    snapshot when every store holds one at the same step in (0, ``steps``)
    (the reference can only restart whole stages, SURVEY.md §5.3-5.4).
    Windows flush there, so no contact counts twice."""
    c = model.config
    x, generator, semiaxes = state
    for store in stores:
        store.set_stage("interphase")
    checkpoints = [store.load_checkpoint() for store in stores]
    steps_at = {None if cp is None else int(cp["step"]) for cp in checkpoints}
    resume = steps_at.pop() if len(steps_at) == 1 else None
    if resume is not None and 0 < resume < c.steps:
        log(f"resuming interphase from checkpoint at step {resume}" if x.dim() == 2
            else f"resuming ensemble interphase from step {resume}")
        for store in stores:
            # Frames written after the snapshot (before the crash) would be
            # re-appended by the resumed chunks.
            store.truncate_frames(resume)
        x = _from_stores([cp["positions"] for cp in checkpoints], x)
        semiaxes = _from_stores([cp["semiaxes"] for cp in checkpoints], semiaxes)
        for g, cp in zip(_per_store(generator, x), checkpoints):
            g.set_state(torch.from_numpy(np.ascontiguousarray(cp["key"], np.uint8)))
        _refresh_bound(model, x, log)
        return (x, generator, semiaxes), resume
    for store in stores:
        store.clear_frames()
    # callback(0): sample, one contact update, dump-and-clear the window
    # (step 0 satisfies both cadences), then the wall gets its first
    # (reaction-free) update.
    events = model.contact_events_tick(x, 0)
    coo = merge_window([events_to_host(events)])
    energy = _frame_energy(model, x, 0.0, semiaxes)
    save_g1_frame(stores, model, 0, x, semiaxes, split_window(coo, model.n, len(stores)),
                  0.0 if energy is None else energy)
    if x.dim() == 2:
        log(progress_line("interphase", 0, t=0.0, energy=energy))
    _window_written(log, timings, x, 0, coo, events.shape[0], None, 0.0)
    semiaxes = semiaxes + c.timestep * c.wall_mobility * (0.0 - model.wall_spring * semiaxes)
    return (x, generator, semiaxes), 0


def run_g1_frames(stores, model: InterphaseModel, state, resume: int,
                  settings: EngineSettings, log, timings: Optional[dict]):
    """G1 from step ``resume`` on, a chunk of ``sampling_interval`` steps at
    a time; after each the grid refit, a window dumped every
    ``contactmap_output_window`` frames, every store's frame, a progress
    line every ``logging_interval`` steps and, at a window, every store's
    checkpoint.  The checkpoints go at the end.  Returns the final positions
    on the host."""
    c = model.config
    device = state[0].device
    beads = state[0].shape[:-1].numel()
    window = WindowAccumulator(beads, settings.acc_capacity, device, log)
    sampling = c.sampling_interval
    window_steps = sampling * c.contactmap_output_window
    t_g1 = t_window = _clock(device)
    wall_t0 = _time.perf_counter()
    steps_done = 0
    for chunk in range(resume // sampling, c.steps // sampling):
        start = chunk * sampling
        state = model.g1_chunk(state, start, sampling, window)
        with tracing.span("g1.frame"):
            x, generator, semiaxes = state
            _refresh_bound(model, x, log)
            step = start + sampling
            coo = None
            if step % window_steps == 0:
                events, capacity = window.events, window.capacity
                coo = window.take()
                t_now = _clock(device)
                _window_written(log, timings, x, step, coo, events, capacity, t_now - t_window)
                t_window = t_now
            energy = _frame_energy(model, x, step * c.timestep, semiaxes)
            positions, axes = save_g1_frame(
                stores, model, step, x, semiaxes,
                None if coo is None else split_window(coo, model.n, len(stores)),
                0.0 if energy is None else energy)
            steps_done += sampling
            if step % c.logging_interval == 0:
                rate = steps_done / max(_time.perf_counter() - wall_t0, 1e-9)
                one = x.dim() == 2
                log(progress_line("interphase", step, t=step * c.timestep, energy=energy,
                                  radius=float(np.cbrt(np.prod(axes))) if one else None)
                    + ("" if one else f"\t{len(stores)} replicas")
                    + f"\t{rate:.1f} steps/s ({rate * beads:.3g} bead-steps/s)")
            if coo is not None:
                save_g1_checkpoints(stores, step, positions, axes, generator, x)
    if timings is not None:
        timings["g1_seconds"] = _clock(device) - t_g1
        timings["g1_steps"] = steps_done
        timings["grid_bound"] = model.bound
    for store in stores:
        store.clear_checkpoint()
    return _to_host(state[0], "final")


def run_interphase(store, settings: Optional[EngineSettings] = None, log=print,
                   device=None, timings: Optional[dict] = None,
                   n_shards: Optional[int] = None, mesh=None):
    """Full interphase stage: relaxation then G1, with reference cadences.

    Runs on the first CUDA card unless ``device`` says otherwise; with no card
    and no such request it raises.  ``timings``, when given, receives the
    host-clock seconds and step counts of the two phases (the device is
    synchronised before each reading), a record of each G1 window written
    (``windows``: its step, rows, the tick events folded into it, the
    accumulator's rows, the seconds since the previous window) and the final
    grid bound.  Returns the final positions.

    With ``mesh`` (``parallel/mesh.py``), or ``n_shards`` > 1 (a mesh of one
    replica over the process group, which must have that many ranks), the G1
    phase is spatially decomposed over the ranks of the replica
    (``parallel/halo.py``).  Every rank calls this, on the mesh's device (a
    ``device`` that names another raises): the replica's first rank with the
    store, which only it opens, runs the relaxation and frame 0 and writes
    everything; the others pass None.  ``timings`` then also receives the G1
    steps that ran again with a wider halo and the final halo geometry.
    """
    if mesh is None and n_shards is not None and n_shards > 1:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(1, n_shards)
    if mesh is not None:
        from ..parallel.halo import run_halo_g1
        from ..parallel.mesh import mesh_device

        device = mesh_device(mesh, device)
        if mesh.shard != 0:
            return run_halo_g1(None, mesh, None, settings, log, timings)
    device = resolve_device(device)
    config = store.load_config()
    design = store.load_interphase_design()
    settings = settings or EngineSettings()
    model = InterphaseModel.from_design(design, config, settings, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(design.seed))

    state = run_relaxation([store], model, generator, device, log, timings)
    state, resume = start_g1([store], model, state, log, timings)
    if mesh is not None:
        return run_halo_g1(store, mesh, dict(
            model=model, config=config, design=design, x=state[0], generator=generator,
            semiaxes=state[2], resume_step=resume,
        ), settings, log, timings)
    return run_g1_frames([store], model, state, resume, settings, log, timings)
