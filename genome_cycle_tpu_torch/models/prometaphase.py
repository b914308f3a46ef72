"""Prometaphase/metaphase stage: bipolar spindle congression.

PyTorch counterpart of the JAX package's ``models/prometaphase.py``, itself a
re-design of ``stage_prometaphase/simulation_driver.cpp`` (SURVEY.md §2.8):
duplicated sister chromatids, sister-kinetochore cohesion, two kinetochore
fiber fields (one per pole) and the polar ejection force-flux potential from
both poles.  Small coarse system -> dense pairwise repulsion, plain PyTorch.

The two fiber fields act on disjoint kinetochores, so they are one
:func:`kfiber_forces` call with a pole for each kinetochore; the two ejection
sources are one :func:`point_source_forces` call.  Like the anatelophase step,
the step never waits for the device.

Noise: one ``torch.Generator`` on the run's device, seeded ``design.seed``;
see ``models/anatelophase.py`` on how runs compare with the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..config import MitoticPhaseConfig, SimulationConfig
from ..store import StageDesign
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
from .anatelophase import register_arrays, run_stage_phase, seeded_generator

# Arrays of the model, under the field names of the JAX dataclass.
ARRAY_FIELDS = (
    "mobility", "bond_pairs", "triples", "sister_pairs",
    "target_kinetochores", "sister_kinetochores",
    "target_springs", "sister_springs", "target_pole", "sister_pole",
)
_INT_FIELDS = {
    "bond_pairs": (-1, 2), "triples": (-1, 3), "sister_pairs": (-1, 2),
    "target_kinetochores": (-1,), "sister_kinetochores": (-1,),
}


class PrometaphaseModel(nn.Module):
    """Static description of the duplicated coarse system (arrays as buffers)
    + force field and step.  The step state is ``(x, generator)``."""

    def __init__(self, config: MitoticPhaseConfig, arrays: dict, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        register_arrays(self, arrays, ARRAY_FIELDS, _INT_FIELDS, device)
        self.n = int(self.mobility.shape[0])
        # Both fiber fields as one: kinetochore, its pole, its spring.
        count = self.target_kinetochores.shape[0]
        derived = dict(
            kfiber_kinetochores=torch.cat(
                [self.target_kinetochores, self.sister_kinetochores]),
            kfiber_poles=torch.cat(
                [self.target_pole.expand(count, 3), self.sister_pole.expand(count, 3)]),
            kfiber_springs=torch.cat([self.target_springs, self.sister_springs]),
            poles=torch.stack([self.target_pole, self.sister_pole]),
        )
        for name, tensor in derived.items():
            self.register_buffer(name, tensor, persistent=False)

    @property
    def device(self):
        return self.mobility.device

    @classmethod
    def from_design(
        cls, design: StageDesign, config: SimulationConfig, device=None
    ) -> "PrometaphaseModel":
        m = config.mitotic_phase
        return cls(m, design_arrays(design, m), device)

    def forces(self, positions, with_energy=False):
        """Returns (forces (N, 3), energy); energy is 0 unless ``with_energy``."""
        m = self.config

        def rep_c(r2, i, j):
            return pot.softcore_force_coeff(r2, m.core_repulsion, m.core_diameter, 2, 3)

        def rep_u(r2, i, j):
            return pot.softcore_energy(r2, m.core_repulsion, m.core_diameter, 2, 3)

        def semispring(length):
            return (
                (lambda r2: pot.semispring_energy(r2, m.bond_spring, length))
                if with_energy else None,
                lambda r2: pot.semispring_force_coeff(r2, m.bond_spring, length),
            )

        forces, energy = pairwise_forces_dense(
            positions, rep_c, rep_u if with_energy else None
        )

        f, e = pair_bond_forces(positions, self.bond_pairs, *semispring(m.bond_length))
        forces, energy = forces + f, energy + e

        f, e = bending_forces(positions, self.triples, m.bending_energy, with_energy)
        forces, energy = forces + f, energy + e

        # Sister cohesion: semispring between sister kinetochores, with the
        # chain bonds' spring constant (simulation_driver.cpp:100-118).
        f, e = pair_bond_forces(
            positions, self.sister_pairs, *semispring(m.sister_separation)
        )
        forces, energy = forces + f, energy + e

        # Two kinetochore-fiber fields, one per pole.
        f, e = kfiber_forces(
            positions, self.kfiber_kinetochores, self.kfiber_poles,
            self.kfiber_springs, m.kfiber_length_prometaphase, with_energy,
        )
        forces, energy = forces + f, energy + e

        # Polar ejection force from both poles (simulation_driver.cpp:162-182).
        if m.polar_ejection_force != 0:
            b = float(np.sqrt(m.polar_ejection_cross_section))
            f, e = point_source_forces(
                positions,
                self.poles,
                (lambda r2: pot.force_flux_energy(r2, m.polar_ejection_force, b))
                if with_energy else None,
                lambda r2: pot.force_flux_force_coeff(r2, m.polar_ejection_force, b),
            )
            forces, energy = forces + f, energy + e

        return forces, energy

    @torch.no_grad()
    def step(self, carry, step, noise=None):
        """One BD step; ``noise`` (N, 3) replaces the generator's draw."""
        x, generator = carry
        m = self.config
        forces, _ = self.forces(x)
        x = bd_update(
            x, forces, self.mobility, generator, BDParams(m.temperature, m.timestep),
            noise=noise,
        )
        return (x, generator)


def design_arrays(design: StageDesign, m: MitoticPhaseConfig) -> dict:
    """The model's numpy arrays from a stage design."""
    chains = design.chains
    t_kin, s_kin, t_spring, s_spring = [], [], [], []
    for target_index, sister_index in design.sister_chromatids:
        target = chains[target_index]
        sister = chains[sister_index]
        if target.kinetochore is None or sister.kinetochore is None:
            # Kinetochore-less chromatid pair: no cohesion/fiber terms.
            continue
        t_kin.append(target.kinetochore)
        s_kin.append(sister.kinetochore)
        # K = decay / (core_mobility / chain_len)
        # (stage_prometaphase/simulation_driver.cpp:137-158).
        for springs, chain in ((t_spring, target), (s_spring, sister)):
            springs.append(
                m.kfiber_decay_rate_prometaphase
                / (m.core_mobility / (chain.end - chain.start))
            )
    return dict(
        mobility=np.full((design.particle_count,), m.core_mobility),
        bond_pairs=chain_bond_pairs(chains),
        triples=bending_triples(chains, m.penalize_centromere_bending),
        sister_pairs=np.stack([t_kin, s_kin], axis=1).astype(np.int32)
        if t_kin else np.zeros((0, 2), np.int32),
        target_kinetochores=np.asarray(t_kin, np.int32),
        sister_kinetochores=np.asarray(s_kin, np.int32),
        target_springs=np.asarray(t_spring, np.float64),
        sister_springs=np.asarray(s_spring, np.float64),
        target_pole=np.asarray(design.pole_positions[0], np.float64),
        sister_pole=np.asarray(design.pole_positions[1], np.float64),
    )


def run_prometaphase(store, log=print, device=None, timings: Optional[dict] = None):
    """The prometaphase stage from the structure ``transition prometaphase``
    stored, with the reference cadences.

    Runs on the first CUDA card unless ``device`` says otherwise; with no card
    and no such request it raises.  Returns the final positions."""
    device = resolve_device(device)
    config = store.load_config()
    design = store.load_prometaphase_design()
    model = PrometaphaseModel.from_design(design, config, device)
    m = model.config

    store.set_stage("prometaphase")

    # Requires an initial structure from `transition prometaphase`
    # (simulation_driver.cpp:196-210).
    if not store.check_positions(0):
        raise RuntimeError("no initial structure is given")
    x0 = store.load_positions(0)
    if x0.shape[0] != model.n:
        raise ValueError("initial structure size mismatch")
    x = torch.as_tensor(np.asarray(x0), dtype=torch.float32, device=device)

    def mean_energy(x):
        with torch.no_grad():
            return float(model.forces(x, with_energy=True)[1]) / model.n

    (x, _) = run_stage_phase(
        store, "prometaphase", m.prometaphase_steps, m, model.step, mean_energy,
        (x, seeded_generator(design.seed, device)), log, timings,
    )
    return x.cpu().numpy()
