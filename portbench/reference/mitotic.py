"""Plain reference of the mitotic stages' steps, worked out from the
configuration and the chains.

The coarse chains of anaphase and telophase (stage_anatelophase/
simulation_driver.cpp) and the duplicated ones of prometaphase
(stage_prometaphase/simulation_driver.cpp): softcore<2,3> repulsion of
every pair, semispring chain bonds, cosine bending over triples that do not
cross a kinetochore (unless ``penalize_centromere_bending``), then per phase
the kinetochore fibers toward the shifted pole (anaphase), the packing well
around the origin (telophase), or sister cohesion, two fiber fields and the
polar ejection (prometaphase); the Euler-Maruyama update on handed-in
standard normals, ``K`` steps at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from . import potentials as pot
from .config import SimulationConfig
from .topology import compile_topology, load_chains

PHASES = ("anaphase", "telophase", "prometaphase")


def _triples(chains, penalize: bool) -> np.ndarray:
    out = []

    def add(start, end):
        if end - start >= 3:
            i = np.arange(start, end - 2)
            out.append(np.stack([i, i + 1, i + 2], axis=1))

    for c in chains:
        if penalize or c.kinetochore is None:
            add(c.start, c.end)
        else:
            add(c.start, c.kinetochore)
            add(c.kinetochore + 1, c.end)
    return np.concatenate(out) if out else np.zeros((0, 3), np.int64)


def _bonds(chains) -> np.ndarray:
    out = [np.stack([np.arange(c.start, c.end - 1), np.arange(c.start + 1, c.end)], axis=1)
           for c in chains if c.end - c.start > 1]
    return np.concatenate(out) if out else np.zeros((0, 2), np.int64)


class MitoticSystem:
    """The coarse system of one mitotic phase on ``device`` in ``dtype``."""

    def __init__(self, config: SimulationConfig, chains_text: str, phase: str, device, dtype):
        if phase not in PHASES:
            raise ValueError(f"phase {phase!r}: expected one of {PHASES}")
        self.m = m = config.mitotic_phase
        self.phase, self.device, self.dtype = phase, device, dtype
        topology = compile_topology(load_chains(chains_text), config)
        design = topology.prometaphase if phase == "prometaphase" else topology.anatelophase
        chains = design.chains
        self.n = n = len(design.particle_types)

        def t(values, kind=None):
            return torch.as_tensor(np.asarray(values), device=device, dtype=kind or dtype)

        self.mobility = t(np.full(n, m.core_mobility))
        self.bonds = t(_bonds(chains), torch.long)
        self.triples = t(_triples(chains, m.penalize_centromere_bending), torch.long)
        telophase = phase == "telophase"
        self.bond_spring = m.bond_spring * (
            m.telophase_bond_spring_multiplier if telophase else 1.0)
        self.bending = m.bending_energy * (
            m.telophase_bending_energy_multiplier if telophase else 1.0)
        if phase == "anaphase":
            attached = [c for c in chains if c.kinetochore is not None]
            lengths = np.asarray([c.end - c.start for c in attached], np.float64)
            self.kinetochores = t([c.kinetochore for c in attached], torch.long)
            self.poles = t(np.tile(np.asarray(m.anaphase_spindle_shift, np.float64),
                                   (len(attached), 1)))
            self.fiber_springs = t(m.kfiber_decay_rate_anaphase
                                   / (m.core_mobility / np.maximum(lengths, 1)))
            self.fiber_length = m.kfiber_length_anaphase
        elif phase == "prometaphase":
            target, sister, springs = [], [], []
            for ti, si in design.sister_chromatids:
                tc, sc = chains[int(ti)], chains[int(si)]
                if tc.kinetochore is None or sc.kinetochore is None:
                    continue
                target.append(tc.kinetochore)
                sister.append(sc.kinetochore)
                # K = decay rate / (core mobility / chain length), a chromatid each.
                springs.append(tuple(
                    m.kfiber_decay_rate_prometaphase / (m.core_mobility / (chain.end - chain.start))
                    for chain in (tc, sc)))
            springs = np.asarray(springs, np.float64).reshape(-1, 2)
            poles = np.asarray(design.pole_positions, np.float64)
            self.sisters = t(np.stack([target, sister], axis=1).reshape(-1, 2), torch.long)
            self.kinetochores = t(target + sister, torch.long)
            self.poles = t(np.concatenate([np.tile(poles[0], (len(target), 1)),
                                           np.tile(poles[1], (len(sister), 1))]))
            self.fiber_springs = t(np.concatenate([springs[:, 0], springs[:, 1]]))
            self.fiber_length = m.kfiber_length_prometaphase
            self.pole_pair = t(poles)

    def _pair_bonds(self, x, pairs, spring, length):
        forces = torch.zeros_like(x)
        if pairs.shape[0] == 0:
            return forces
        i, j = pairs[:, 0], pairs[:, 1]
        dx = x[i] - x[j]
        c = pot.semispring_force_coeff(torch.sum(dx * dx, dim=-1), spring, length)
        f = c[:, None] * dx
        return forces.index_add_(0, i, f).index_add_(0, j, -f)

    def forces(self, x):
        """The phase's force on every bead of ``x`` (N, 3)."""
        m = self.m
        dx = x[:, None, :] - x[None, :, :]
        r2 = torch.sum(dx * dx, dim=-1)
        r2 = r2 + torch.diag(torch.full((x.shape[0],), float("inf"), dtype=x.dtype,
                                        device=x.device))
        c = pot.softcore_force_coeff(r2, m.core_repulsion, m.core_diameter, 2, 3)
        forces = torch.sum(c[..., None] * dx, dim=1)
        forces = forces + self._pair_bonds(x, self.bonds, self.bond_spring, m.bond_length)
        forces = forces + self._bending(x)
        if self.phase == "telophase":
            r2w = torch.sum(x * x, dim=-1)
            cw = pot.semispring_force_coeff(r2w, m.telophase_packing_spring,
                                            m.telophase_packing_radius)
            return forces + cw[:, None] * x
        forces = forces + self._fibers(x)
        if self.phase == "prometaphase":
            forces = forces + self._pair_bonds(x, self.sisters, m.bond_spring, m.sister_separation)
            if m.polar_ejection_force != 0:
                b = float(np.sqrt(m.polar_ejection_cross_section))
                d = x[None, :, :] - self.pole_pair[:, None, :]
                ce = pot.force_flux_force_coeff(torch.sum(d * d, dim=-1), m.polar_ejection_force, b)
                forces = forces + torch.sum(ce[..., None] * d, dim=0)
        return forces

    def _bending(self, x):
        """-grad of e (1 - a.b / |a||b|), a = x_j - x_i, b = x_k - x_j:
        -dU/da = e/(|a||b|) (b - (a.b / |a|^2) a), and alike for b."""
        forces = torch.zeros_like(x)
        if self.triples.shape[0] == 0:
            return forces
        i, j, k = self.triples.unbind(1)
        a, b = x[j] - x[i], x[k] - x[j]
        a2, b2 = torch.sum(a * a, dim=-1), torch.sum(b * b, dim=-1)
        dot = torch.sum(a * b, dim=-1)
        scale = self.bending * torch.rsqrt(a2 * b2)
        ga = scale[:, None] * (b - (dot / a2)[:, None] * a)
        gb = scale[:, None] * (a - (dot / b2)[:, None] * b)
        return forces.index_add_(0, i, -ga).index_add_(0, j, ga - gb).index_add_(0, k, gb)

    def _fibers(self, x):
        dx = x[self.kinetochores] - self.poles
        c = pot.spring_force_coeff(torch.sum(dx * dx, dim=-1), self.fiber_springs,
                                   self.fiber_length)
        return torch.zeros_like(x).index_add_(0, self.kinetochores, c[:, None] * dx)

    def run(self, x, noise):
        """``noise.shape[0]`` Euler-Maruyama steps from ``x`` on the handed-in
        normals: returns the positions after the last."""
        m = self.m
        sigma = torch.sqrt(2.0 * m.temperature * self.mobility * m.timestep)[:, None]
        mob_dt = (self.mobility * m.timestep)[:, None]
        for xi in noise:
            x = x + mob_dt * self.forces(x) + sigma * xi
        return x
