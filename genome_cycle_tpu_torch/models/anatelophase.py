"""Anatelophase stage: anaphase dragging + telophase packing.

PyTorch counterpart of the JAX package's ``models/anatelophase.py``, itself a
re-design of ``stage_anatelophase/simulation_driver.cpp`` (SURVEY.md §2.5):
one coarse bead system (N ~ hundreds), two phases with a forcefield swap at
the anaphase->telophase boundary.  The coarse system is small, so pairwise
repulsion uses the dense masked O(N^2) path (no cell grid).

The stage runs a chunk of ``sampling_interval`` steps at a time
(:meth:`AnatelophaseModel.run_chunk`, ``ops/mitotic.py::run_chunk``): on the
card one launch of the hand-written chunk kernel (``csrc/mitotic_chunk.cu``),
as the JAX package runs one ``lax.scan`` a chunk; on the CPU the eager
:meth:`AnatelophaseModel.step` K times.  The eager step, a few dozen small
launches, stays as the kernel's plain version and yardstick; it never waits
for the device: no value is read back, no branch depends on a tensor,
energies are evaluated only for a progress line.

Noise: each phase draws from its own ``torch.Generator`` on the run's device,
seeded ``design.seed`` (anaphase) and ``design.seed + 1`` (telophase), a
chunk's (K, N, 3) standard normals in one draw.  The numbers differ from the
JAX package's split ``PRNGKey``, so runs at temperature > 0 agree in
distribution only; at temperature 0 they agree step for step.
"""

from __future__ import annotations

import time as _time
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..config import MitoticPhaseConfig, SimulationConfig
from ..store import StageDesign
from ..ops import mitotic
from ..ops import potentials as pot
from ..ops.bonded import (
    bending_forces,
    bending_triples,
    chain_bond_pairs,
    kfiber_forces,
    pair_bond_forces,
    point_source_forces,
)
from ..ops.integrator import BDParams, bd_update
from ..ops.neighbor import pairwise_forces_dense
from ..utils import tracing
from ..utils.logging import progress_line

# Arrays of the model, under the field names of the JAX dataclass.
ARRAY_FIELDS = (
    "mobility", "bond_pairs", "triples", "kinetochores", "kfiber_springs", "pole",
)
_INT_FIELDS = {"bond_pairs": (-1, 2), "triples": (-1, 3), "kinetochores": (-1,)}


def register_arrays(module: nn.Module, arrays: dict, fields, int_fields, device):
    """Register ``arrays[name]`` for every name of ``fields`` as a buffer of
    ``module`` on ``device``: int64 in the given shape for ``int_fields``
    (index tensors), float32 otherwise."""
    missing = [name for name in fields if name not in arrays]
    if missing:
        raise KeyError(f"arrays lack the fields {missing}")
    for name in fields:
        value = np.asarray(arrays[name])
        if name in int_fields:
            tensor = torch.as_tensor(value.astype(np.int64)).reshape(int_fields[name])
        else:
            tensor = torch.as_tensor(value.astype(np.float64)).to(torch.float32)
        module.register_buffer(name, tensor.to(device))


class AnatelophaseModel(nn.Module):
    """Static description of the coarse system (arrays as buffers) + force
    field and step of both phases.  The step state is ``(x, generator)``."""

    def __init__(self, config: MitoticPhaseConfig, arrays: dict, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        register_arrays(self, arrays, ARRAY_FIELDS, _INT_FIELDS, device)
        self.n = int(self.mobility.shape[0])
        self.register_buffer(
            "origin", torch.zeros(3, dtype=torch.float32, device=device),
            persistent=False,
        )
        self._terms = {}

    @property
    def device(self):
        return self.mobility.device

    @classmethod
    def from_design(
        cls, design: StageDesign, config: SimulationConfig, device=None
    ) -> "AnatelophaseModel":
        m = config.mitotic_phase
        return cls(m, design_arrays(design, m), device)

    def forces(self, positions, telophase: bool, with_energy=False):
        """Force field of the anaphase (``telophase`` False) or the telophase.
        Returns (forces (N, 3), energy); energy is 0 unless ``with_energy``."""
        m = self.config

        def rep_c(r2, i, j):
            return pot.softcore_force_coeff(r2, m.core_repulsion, m.core_diameter, 2, 3)

        def rep_u(r2, i, j):
            return pot.softcore_energy(r2, m.core_repulsion, m.core_diameter, 2, 3)

        forces, energy = pairwise_forces_dense(
            positions, rep_c, rep_u if with_energy else None
        )

        bond_k = m.bond_spring * (m.telophase_bond_spring_multiplier if telophase else 1.0)
        f, e = pair_bond_forces(
            positions,
            self.bond_pairs,
            (lambda r2: pot.semispring_energy(r2, bond_k, m.bond_length))
            if with_energy else None,
            lambda r2: pot.semispring_force_coeff(r2, bond_k, m.bond_length),
        )
        forces, energy = forces + f, energy + e

        bend_e = m.bending_energy * (
            m.telophase_bending_energy_multiplier if telophase else 1.0
        )
        f, e = bending_forces(positions, self.triples, bend_e, with_energy)
        forces, energy = forces + f, energy + e

        if telophase:
            # Packing well keeps the decondensing chromosomes together
            # (simulation_driver.cpp:175-189).
            f, e = point_source_forces(
                positions,
                self.origin,
                (lambda r2: pot.semispring_energy(
                    r2, m.telophase_packing_spring, m.telophase_packing_radius
                )) if with_energy else None,
                lambda r2: pot.semispring_force_coeff(
                    r2, m.telophase_packing_spring, m.telophase_packing_radius
                ),
            )
        else:
            # Anaphase kinetochore dragging toward the shifted pole.
            f, e = kfiber_forces(
                positions, self.kinetochores, self.pole, self.kfiber_springs,
                m.kfiber_length_anaphase, with_energy,
            )
        return forces + f, energy + e

    @torch.no_grad()
    def step(self, carry, step, telophase: bool, noise=None):
        """One BD step; ``noise`` (N, 3) replaces the generator's draw."""
        x, generator = carry
        m = self.config
        forces, _ = self.forces(x, telophase)
        x = bd_update(
            x, forces, self.mobility, generator, BDParams(m.temperature, m.timestep),
            noise=noise,
        )
        return (x, generator)

    def mitotic_terms(self, telophase: bool) -> mitotic.MitoticTerms:
        """The phase's term table and parameters for the chunk kernel, built
        once a phase."""
        if telophase not in self._terms:
            self._terms[telophase] = mitotic.terms_from_anatelophase(self, telophase)
        return self._terms[telophase]

    @torch.no_grad()
    def run_chunk(self, carry, steps: int, telophase: bool):
        """``steps`` BD steps: the chunk's (steps, N, 3) standard normals in
        one draw from the generator, then ``ops/mitotic.py::run_chunk`` (one
        kernel launch on the card; :meth:`step` ``steps`` times, step k with
        the draw's slab k, on the CPU)."""
        x, generator = carry
        m = self.config
        noise = torch.randn((steps, self.n, 3), dtype=x.dtype, device=x.device,
                            generator=generator)
        x = mitotic.run_chunk(x, self.mitotic_terms(telophase), self.mobility, noise,
                              m.temperature, m.timestep)
        return (x, generator)

    def initial_rods(self, rng: np.random.Generator, chains) -> np.ndarray:
        """Randomly-directed rods from Gaussian-displaced centroids at
        -spindle_axis (simulation_driver.cpp:221-237)."""
        m = self.config
        positions = np.zeros((self.n, 3))
        start_center = -np.asarray(m.spindle_axis)
        for chain in chains:
            centroid = start_center + m.anaphase_start_stddev * rng.normal(size=3)
            direction = rng.normal(size=3)
            step_vec = m.bond_length * direction / np.linalg.norm(direction)
            length = chain.end - chain.start
            pos = centroid - step_vec * length / 2
            for i in range(chain.start, chain.end):
                positions[i] = pos
                pos = pos + step_vec
        return positions


def design_arrays(design: StageDesign, m: MitoticPhaseConfig) -> dict:
    """The model's numpy arrays from a stage design."""
    chains = design.chains
    # Chains without a kinetochore (shorter than the coarse-graining
    # window) have no microtubule attachment: exclude them from dragging.
    attached = [c for c in chains if c.kinetochore is not None]
    # Per-chain kinetochore spring: K = decay_rate / (core_mobility/len)
    # (stage_anatelophase/simulation_driver.cpp:158-168).
    lens = np.asarray([c.end - c.start for c in attached], np.float64)
    return dict(
        mobility=np.full((design.particle_count,), m.core_mobility),
        bond_pairs=chain_bond_pairs(chains),
        triples=bending_triples(chains, m.penalize_centromere_bending),
        kinetochores=np.asarray([c.kinetochore for c in attached], np.int32),
        kfiber_springs=m.kfiber_decay_rate_anaphase
        / (m.core_mobility / np.maximum(lens, 1)),
        pole=np.asarray(m.anaphase_spindle_shift, np.float64),
    )


def _to_host(value: torch.Tensor):
    """Enqueue a copy of ``value`` to the host, into pinned memory when it is
    on the card, and record an event after it.  Returns (host tensor, event);
    on the CPU the copy is done on return and the event is None."""
    host = torch.empty(value.shape, dtype=value.dtype, pin_memory=value.is_cuda)
    host.copy_(value.detach(), non_blocking=True)
    if not value.is_cuda:
        return host, None
    copied = torch.cuda.Event()
    copied.record(torch.cuda.current_stream(value.device))
    return host, copied


def _wait(copied):
    if copied is not None:
        copied.synchronize()


def run_stage_phase(store, stage, steps, m, chunk_fn, energy_fn, state, log,
                    timings=None):
    """The sampling loop the mitotic phases share: clear the stage's frames,
    store step 0, then a frame every ``sampling_interval`` steps and a
    progress line (mean energy per bead) every ``logging_interval``.
    ``chunk_fn(state, steps)`` advances the state ``(x, generator)`` by
    ``sampling_interval`` steps, one chunk a frame; ``energy_fn(x)`` is the
    total energy of ``x`` as a 0-d tensor on its device.

    One frame deep: after chunk k the loop enqueues the copies of frame k to
    the host (positions and, on a logging frame, energy), then chunk k + 1,
    and only then waits on those copies and writes frame k and its line, so
    that the store's writes run while the device runs chunk k + 1.  A stage
    of n chunks writes n of its n + 1 frames so (``mitotic.frames_overlapped``).
    Returns the final state; ``timings`` receives the phase's host-clock
    seconds (device synchronised) and step count under ``<stage>_seconds/_steps``."""
    device = state[0].device
    interval = m.sampling_interval

    def clock():
        if device.type == "cuda":
            with tracing.sync("clock"):
                torch.cuda.synchronize(device)
        return _time.perf_counter()

    def read(step, x):
        logged = step == 0 or step % m.logging_interval == 0
        return step, _to_host(x), _to_host(energy_fn(x)) if logged else None

    def write(frame):
        step, (positions, copied), energy = frame
        with tracing.span("mitotic.frame"):
            with tracing.sync("mitotic_frame"):
                _wait(copied)
            store.save_positions(step, positions.numpy())
            store.append_frame(step)
        if energy is not None:
            value, copied = energy
            with tracing.sync("mitotic_energy"):
                _wait(copied)
            log(progress_line(stage, step, energy=float(value) / positions.shape[0]))

    store.set_stage(stage)
    store.clear_frames()
    t0 = clock()
    frame = read(0, state[0])
    n_chunks = steps // interval
    for chunk in range(1, n_chunks + 1):
        state = chunk_fn(state, interval)
        write(frame)
        tracing.count("mitotic.frames_overlapped")
        frame = read(chunk * interval, state[0])
    write(frame)
    if timings is not None:
        timings[f"{stage}_seconds"] = clock() - t0
        timings[f"{stage}_steps"] = n_chunks * interval
    return state


def seeded_generator(seed: int, device) -> torch.Generator:
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    return generator


def run_anatelophase(store, log=print, device=None, timings: Optional[dict] = None):
    """Anaphase then telophase, with the reference cadences.

    Runs on the first CUDA card unless ``device`` says otherwise; with no card
    and no such request it raises.  Returns the final positions."""
    device = resolve_device(device)
    config = store.load_config()
    design = store.load_anatelophase_design()
    model = AnatelophaseModel.from_design(design, config, device)
    m = model.config

    store.set_stage("anaphase")

    # Initial structure may be stored (cycle continuation)
    # (simulation_driver.cpp:211-219); otherwise random rods.
    if store.check_positions(0):
        x0 = store.load_positions(0)
        if x0.shape[0] != model.n:
            raise ValueError("initial structure size mismatch")
    else:
        x0 = model.initial_rods(np.random.default_rng(design.seed), design.chains)
    x = torch.as_tensor(np.asarray(x0), dtype=torch.float32, device=device)

    def run_phase(stage: str, telophase: bool, steps: int, x, seed: int):
        def energy(x):
            with torch.no_grad():
                return model.forces(x, telophase, with_energy=True)[1]

        return run_stage_phase(
            store, stage, steps, m,
            lambda state, steps: model.run_chunk(state, steps, telophase),
            energy, (x, seeded_generator(seed, device)), log, timings,
        )

    (x, _) = run_phase("anaphase", False, m.anaphase_steps, x, design.seed)
    (x, _) = run_phase("telophase", True, m.telophase_steps, x, design.seed + 1)
    log("Finished.")
    return x.cpu().numpy()
