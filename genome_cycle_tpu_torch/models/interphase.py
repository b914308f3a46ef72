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
counterpart here.

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
from ..ops.bonded import (
    chain_bond_pairs,
    loop_bond_pairs,
    pair_bond_forces,
    shift_bond_forces,
)
from ..ops.contact import (
    contact_events,
    empty_window_acc,
    events_to_host,
    merge_events_acc,
    merge_window,
)
from ..ops.integrator import BDParams, bd_update
from ..ops.neighbor import pairwise_forces_dense
from ..ops.pair_kernels import ab_pair_forces, build_cell_layout
from ..ops.wall import wall_forces
from ..utils.logging import progress_line


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

    def bonded_forces(self, positions, bond_scale, with_energy=False):
        """All topology-indexed terms: chain bonds, loops, nucleolar bonds,
        nucleolar droplet.  Cheap O(N)."""
        c = self.config

        # Chain bonds: fluctuation-preserving rescale K/s^2, l*s
        # (simulation_driver_forcefield.cpp:78-88).  Uniform (i, i+1)
        # offset -> shift formulation (rolls, no gather/scatter).
        s2 = bond_scale * bond_scale
        k_bond = self.bond_k_row / s2
        l_bond = self.bond_l_row * bond_scale
        forces, energy = shift_bond_forces(
            positions, 1, self.bond_mask,
            lambda r2: pot.semispring_energy(r2, k_bond, l_bond),
            lambda r2: pot.semispring_force_coeff(r2, k_bond, l_bond),
        )

        if self.use_loops:
            k_loop = self.loop_k_row / s2
            f, e = shift_bond_forces(
                positions, 2, self.loop_mask,
                lambda r2: pot.harmonic_energy(r2, k_loop),
                lambda r2: pot.harmonic_force_coeff(r2, k_loop),
            )
            forces, energy = forces + f, energy + e

        if self.nuc_bonds.shape[0]:
            k_nuc = c.nucleolus_bond_spring / s2
            l_nuc = c.nucleolus_bond_length * bond_scale
            f, e = pair_bond_forces(
                positions,
                self.nuc_bonds,
                lambda r2: pot.semispring_energy(r2, k_nuc, l_nuc),
                lambda r2: pot.semispring_force_coeff(r2, k_nuc, l_nuc),
            )
            forces, energy = forces + f, energy + e

        if self.use_droplet:
            cutoff = c.nucleolus_droplet_cutoff

            def drop_u(r2, i, j):
                return pot.cutoff_shift(
                    lambda q: pot.softwell_energy(
                        q, c.nucleolus_droplet_energy, c.nucleolus_droplet_decay, 6
                    ),
                    r2,
                    cutoff,
                )

            def drop_c(r2, i, j):
                coeff = pot.softwell_force_coeff(
                    r2, c.nucleolus_droplet_energy, c.nucleolus_droplet_decay, 6
                )
                return torch.where(r2 < cutoff * cutoff, coeff, torch.zeros_like(coeff))

            f, e = pairwise_forces_dense(
                positions, drop_c, drop_u if with_energy else None,
                targets=self.nuc_targets,
            )
            forces, energy = forces + f, energy + e

        return forces, energy

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

    def _assemble_forces(self, x, core_scale, bond_scale, semiaxes,
                         with_energy=False):
        """Full force field.  Returns (forces, reaction, energy)."""
        forces, energy = self.pair_forces_full(x, core_scale, with_energy)
        f, e = self.bonded_forces(x, bond_scale, with_energy)
        wf, reaction, we = self.wall_forces_rows(x, semiaxes, core_scale)
        return forces + f + wf, reaction, energy + e + we

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

    @torch.no_grad()
    def _bd_step4(self, carry, step: int, noise=None):
        """Forces at lagged scales, BD update, wall ODE — everything except
        contact accounting (simulation_driver_interphase.cpp:16-63,79-90)."""
        x, generator, semiaxes = carry
        c = self.config
        dt = c.timestep
        # Scales were last updated by the previous step's callback at
        # time (step-1) * dt.
        core_scale, bond_scale = self.scales((step - 1) * dt)

        forces, reaction, _ = self._assemble_forces(
            x, core_scale, bond_scale, semiaxes
        )
        x = bd_update(
            x, forces, self.mobility, generator, BDParams(c.temperature, dt),
            noise=noise,
        )

        # Wall ODE: overdamped motion of the semiaxes under chromatin pressure
        # (simulation_driver_interphase.cpp:79-90).
        semiaxes = semiaxes + dt * c.wall_mobility * (
            reaction - self.wall_spring * semiaxes
        )
        return (x, generator, semiaxes)

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
        return contact_events(self.cell_layout(x), c.contactmap_distance * core_now)

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
    grows past the watermark with headroom and the merge is run again."""

    def __init__(self, particles: int, capacity: Optional[int], device, log=print):
        self.capacity = capacity or max(1 << 16, 16 * particles)
        self.device = device
        self.log = log
        self.acc, self.rows = empty_window_acc(self.capacity, device)

    def add(self, events):
        while True:
            acc, rows, overflow = merge_events_acc(self.acc, self.rows, events)
            if overflow == 0:
                self.acc, self.rows = acc, rows
                return
            self.capacity = -(-int((self.capacity + overflow) * 3 // 2) // 4096) * 4096
            self.log(f"engine: growing window accumulator to {self.capacity}")
            grown, _ = empty_window_acc(self.capacity, self.device)
            self.acc = torch.cat([self.acc, grown[self.acc.shape[0]:]])

    def take(self) -> np.ndarray:
        """The window's sorted (i, j, count) rows on the host; the window
        starts afresh."""
        coo = self.acc[: self.rows].cpu().numpy()
        self.acc, self.rows = empty_window_acc(self.capacity, self.device)
        return coo


def save_g1_frame(store, model: InterphaseModel, step: int, x, semiaxes, contacts_coo,
                  mean_energy: float) -> InterphaseContext:
    """Write G1 frame ``step`` of ``x`` (N, 3) into the store's current
    stage: positions, the context (time, wall semiaxes, the schedule's scales
    at that time, ``mean_energy``) and, when given and not empty, the
    window's contacts.  Returns the context."""
    t = step * model.config.timestep
    core, bond = model.scales(t)
    ctx = InterphaseContext(
        time=t,
        wall_semiaxes=tuple(float(v) for v in semiaxes.detach().cpu().numpy()),
        core_scale=float(core),
        bond_scale=float(bond),
        mean_energy=mean_energy,
    )
    store.save_positions(step, x.detach().cpu().numpy())
    store.save_interphase_context(step, ctx)
    if contacts_coo is not None and len(contacts_coo):
        store.save_contacts(step, contacts_coo)
    store.append_frame(step)
    return ctx


def run_interphase(store, settings: Optional[EngineSettings] = None, log=print,
                   device=None, timings: Optional[dict] = None,
                   n_shards: Optional[int] = None, mesh=None):
    """Full interphase stage: relaxation then G1, with reference cadences.

    Runs on the first CUDA card unless ``device`` says otherwise; with no card
    and no such request it raises.  ``timings``, when given, receives the
    host-clock seconds and step counts of the two phases (the device is
    synchronised before each reading).  Returns the final positions.

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
    c = config.interphase
    n = design.particle_count
    dtype = model.dtype

    generator = torch.Generator(device=device)
    generator.manual_seed(int(design.seed))

    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return _time.perf_counter()

    def to_host(tensor):
        return tensor.detach().cpu().numpy()

    def refresh_bound(x):
        if model.update_bound(float(x.abs().max())):
            log(f"engine: grid bound -> {model.bound:g}")

    semiaxes0 = torch.as_tensor(c.wall_semiaxes_init, dtype=dtype, device=device)

    def mean_energy(x, t, semiaxes):
        core, bond = model.scales(t)
        with torch.no_grad():
            return float(model.total_energy(x, core, bond, semiaxes)) / n

    # ---- relaxation phase --------------------------------------------------
    store.set_stage("relaxation")
    store.clear_frames()
    x = torch.as_tensor(store.load_positions(0), dtype=dtype, device=device)
    if x.shape[0] != n:
        raise ValueError("initial structure size mismatch")
    refresh_bound(x)

    def relax_context(x):
        return InterphaseContext(
            time=0.0,
            wall_semiaxes=tuple(float(v) for v in to_host(semiaxes0)),
            core_scale=c.core_scale_init,
            bond_scale=c.bond_scale_init,
            mean_energy=mean_energy(x, 0.0, semiaxes0),
        )

    ctx = relax_context(x)
    store.save_positions(0, to_host(x))
    store.save_interphase_context(0, ctx)
    store.append_frame(0)
    log(progress_line("relaxation", 0, t=0.0, energy=ctx.mean_energy))

    t_relax = clock()
    state = (x, generator, semiaxes0)
    n_chunks = c.relaxation_steps // c.relaxation_sampling_interval
    for chunk in range(n_chunks):
        for s in range(c.relaxation_sampling_interval):
            state = model.relaxation_step(state, s)
        step = (chunk + 1) * c.relaxation_sampling_interval
        x = state[0]
        refresh_bound(x)
        ctx = relax_context(x)
        store.save_positions(step, to_host(x))
        store.save_interphase_context(step, ctx)
        store.append_frame(step)
        log(progress_line("relaxation", step, t=0.0, energy=ctx.mean_energy))
    if timings is not None:
        timings["relaxation_seconds"] = clock() - t_relax
        timings["relaxation_steps"] = n_chunks * c.relaxation_sampling_interval

    # ---- interphase (G1) phase ---------------------------------------------
    store.set_stage("interphase")

    sampling = c.sampling_interval
    window_steps = sampling * c.contactmap_output_window

    # Intra-stage resume: a long G1 run snapshots its step state at contact
    # window boundaries; re-running the stage continues from the snapshot
    # (the reference can only restart whole stages, SURVEY.md §5.3-5.4).
    checkpoint = store.load_checkpoint()
    resume_step = 0
    if checkpoint is not None and 0 < checkpoint["step"] < c.steps:
        resume_step = int(checkpoint["step"])
        log(f"resuming interphase from checkpoint at step {resume_step}")
        # Frames written after the snapshot (before the crash) would be
        # re-appended by the resumed chunks.
        store.truncate_frames(resume_step)
    else:
        checkpoint = None
        store.clear_frames()

    def save_frame(step, x, semiaxes, contacts_coo=None):
        return save_g1_frame(store, model, step, x, semiaxes, contacts_coo,
                             mean_energy(x, step * c.timestep, semiaxes))

    if checkpoint is not None:
        x = torch.as_tensor(checkpoint["positions"], dtype=dtype, device=device)
        semiaxes = torch.as_tensor(checkpoint["semiaxes"], dtype=dtype, device=device)
        generator.set_state(
            torch.from_numpy(np.ascontiguousarray(checkpoint["key"], np.uint8))
        )
        refresh_bound(x)
    else:
        # callback(0): sample, one contact update, dump-and-clear the window
        # (step 0 satisfies both cadences), then the wall gets its first
        # (reaction-free) update.
        semiaxes = semiaxes0
        coo0 = merge_window([events_to_host(model.contact_events_tick(x, 0))])
        ctx = save_frame(0, x, semiaxes, coo0)
        log(progress_line("interphase", 0, t=0.0, energy=ctx.mean_energy))
        semiaxes = semiaxes + c.timestep * c.wall_mobility * (
            0.0 - model.wall_spring * semiaxes
        )

    if mesh is not None:
        return run_halo_g1(store, mesh, dict(
            model=model, config=config, design=design, x=x, generator=generator,
            semiaxes=semiaxes, resume_step=resume_step,
        ), settings, log, timings)

    window = WindowAccumulator(n, settings.acc_capacity, device, log)
    state = (x, generator, semiaxes)
    t_g1 = clock()
    wall_t0 = _time.perf_counter()
    steps_done = 0

    n_chunks = c.steps // sampling
    for chunk in range(resume_step // sampling, n_chunks):
        start = chunk * sampling
        state = model.g1_chunk(state, start, sampling, window)
        x, _, semiaxes = state
        refresh_bound(x)
        step = start + sampling

        contacts_coo = window.take() if step % window_steps == 0 else None

        ctx = save_frame(step, x, semiaxes, contacts_coo)
        steps_done += sampling
        if step % c.logging_interval == 0:
            rate = steps_done / max(_time.perf_counter() - wall_t0, 1e-9)
            log(
                progress_line(
                    "interphase", step, t=step * c.timestep,
                    energy=ctx.mean_energy,
                    radius=float(np.cbrt(np.prod(to_host(semiaxes)))),
                )
                + f"\t{rate:.1f} steps/s ({rate * n:.3g} bead-steps/s)"
            )

        # Snapshot the step state at window boundaries (contact windows are
        # flushed there, so a resume never double-counts contacts).
        if contacts_coo is not None:
            store.save_checkpoint(
                step,
                {
                    "positions": to_host(x),
                    "semiaxes": to_host(semiaxes),
                    "key": generator.get_state().numpy(),
                },
            )
    if timings is not None:
        timings["g1_seconds"] = clock() - t_g1
        timings["g1_steps"] = steps_done

    store.clear_checkpoint()
    return to_host(state[0])
