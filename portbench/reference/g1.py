"""Plain reference of the interphase (G1) step, its contact tick and a
frame's energy, worked out from the configuration and the chains.

One G1 step at step ``s`` (simulation_driver_interphase.cpp:16-90): the
forces at the scales of time (s - 1) dt -- the A/B softcore pair repulsion
over every pair, the chain bonds (K / s^2, l s), the loops, the nucleolar
bonds and droplet, the ellipsoidal wall with its axial reaction -- then the
Euler-Maruyama update x + mu F dt + sqrt(2 mu kT dt) xi on the handed-in
standard normals xi, and the wall ODE a + dt mu_wall (reaction - k a).
The tick counts every pair i < j closer than the contact distance at the
core scale of time s dt.

Every function takes positions of one replica (N, 3) in the dtype the
system was built in.  The pair terms are summed over dense blocks of the
N x N distance matrix: the beads are ordered by a grid of the terms' reach,
cut into tiles of ``_TILE`` in that order, and two tiles make a block when
their bounding boxes lie within the reach.  Every pair closer than the
reach lies in some block, and a pair term is zero beyond its reach, so the
sums are those over every pair; the grid only orders, and no grid or
neighbour list of the program is involved.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import potentials as pot
from .config import SimulationConfig
from .topology import compile_topology, load_chains

DROPLET_EXPONENT = 6          # softwell<6>, the reference's droplet
_TILE = 64                    # beads a tile
_BLOCK_PAIRS = 1 << 24        # pair-matrix elements a batch of tile pairs holds


def _pairs_of(chains, offset: int) -> np.ndarray:
    pairs = [np.stack([np.arange(c.start, c.end - offset),
                       np.arange(c.start + offset, c.end)], axis=1)
             for c in chains if c.end - c.start > offset]
    return np.concatenate(pairs) if pairs else np.zeros((0, 2), np.int64)


class G1System:
    """The interphase system of ``config`` over ``chains_text``, its
    per-bead and per-bond parameters on ``device`` in ``dtype``."""

    def __init__(self, config: SimulationConfig, chains_text: str, device, dtype):
        self.config = c = config.interphase
        self.device, self.dtype = device, dtype
        topology = compile_topology(load_chains(chains_text), config).interphase
        self.n = n = len(topology.particle_types)
        ab = np.asarray(topology.ab_factors, np.float64).reshape(n, 2)
        af, bf = ab[:, 0], ab[:, 1]
        nuc = np.asarray(topology.nucleolar_bonds, np.int64).reshape(-1, 2)
        mobility = np.where(af >= bf, c.a_core_mobility, c.b_core_mobility)
        if len(nuc):
            mobility[nuc[:, 1]] = c.nucleolus_mobility
        bonds = _pairs_of(topology.chains, 1)
        loops = _pairs_of(topology.chains, 2)

        def mixed(pairs, a_value, b_value):
            a_mix = 0.5 * (af[pairs[:, 0]] + af[pairs[:, 1]])
            b_mix = 0.5 * (bf[pairs[:, 0]] + bf[pairs[:, 1]])
            return a_mix * a_value + b_mix * b_value

        def t(values, kind=None):
            return torch.as_tensor(np.asarray(values), device=device, dtype=kind or dtype)

        self.af, self.bf, self.mobility = t(af), t(bf), t(mobility)
        self.bonds = t(bonds, torch.long)
        self.bond_spring = t(mixed(bonds, c.a_core_bond_spring, c.b_core_bond_spring))
        self.bond_length = t(mixed(bonds, c.a_core_bond_length, c.b_core_bond_length))
        loop_spring = mixed(loops, c.a_core_2nd_bond_spring, c.b_core_2nd_bond_spring)
        self.use_loops = bool(len(loops)) and bool(np.any(loop_spring != 0))
        self.loops, self.loop_spring = t(loops, torch.long), t(loop_spring)
        self.nuc_bonds = t(nuc, torch.long)
        targets = np.unique(nuc[:, 1]) if len(nuc) else np.zeros(0, np.int64)
        self.use_droplet = c.nucleolus_droplet_energy != 0 and len(targets) > 1
        self.nuc_targets = t(targets, torch.long)
        self.wall_a = 0.5 * (self.af + c.wall_ab_factor.a)
        self.wall_b = 0.5 * (self.bf + c.wall_ab_factor.b)

    # -- schedule -----------------------------------------------------------

    def scales(self, time: float):
        """(core scale, bond scale) at ``time`` (interphase.cpp:67-76)."""
        c = self.config
        core = 1.0 - (1.0 - c.core_scale_init) * math.exp(-time / c.core_scale_tau)
        bond = 1.0 - (1.0 - c.bond_scale_init) * math.exp(-time / c.bond_scale_tau)
        return core, bond

    def _ab(self, core: float, half: bool = False) -> dict:
        c = self.config
        f = 0.5 if half else 1.0
        return dict(a_energy=c.a_core_repulsion, a_diameter=c.a_core_diameter * core * f,
                    b_energy=c.b_core_repulsion, b_diameter=c.b_core_diameter * core * f)

    # -- terms ---------------------------------------------------------------

    def _blocks(self, x, reach: float):
        """(rows, cols, dx, r2) for batches of tile pairs that hold every
        pair i != j closer than ``reach``: rows and cols (B, T) bead ids,
        ``n`` for a tile's padding; dx, r2 (B, T, T, ...) of row minus
        column; r2 of a bead with itself and of the padding is +inf."""
        n, dev = x.shape[0], x.device
        inf = float("inf")
        cell = torch.floor((x - x.min(dim=0).values) / reach).to(torch.int64)
        dims = cell.max(dim=0).values + 1
        order = torch.argsort((cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2])
        tiles = -(-n // _TILE)
        ids = torch.full((tiles * _TILE,), n, dtype=torch.int64, device=dev)
        ids[:n] = order
        ids = ids.view(tiles, _TILE)
        pos = torch.cat([x, x.new_zeros((1, 3))])[ids]
        pad = (ids == n)[..., None]
        lo = torch.where(pad, inf, pos).min(dim=1).values
        hi = torch.where(pad, -inf, pos).max(dim=1).values
        gap = torch.clamp(torch.maximum(lo[None] - hi[:, None], lo[:, None] - hi[None]), min=0)
        a, b = torch.nonzero(torch.sum(gap * gap, dim=-1) <= reach * reach, as_tuple=True)
        per = max(1, _BLOCK_PAIRS // (_TILE * _TILE))
        for k in range(0, a.shape[0], per):
            ta, tb = a[k:k + per], b[k:k + per]
            rows, cols = ids[ta], ids[tb]
            dx = pos[ta][:, :, None, :] - pos[tb][:, None, :, :]
            r2 = torch.sum(dx * dx, dim=-1)
            off = (rows[:, :, None] == cols[:, None, :]) | (rows == n)[:, :, None] \
                | (cols == n)[:, None, :]
            yield rows, cols, dx, r2.masked_fill_(off, inf)

    def _reach(self, core: float) -> float:
        c = self.config
        return max(c.a_core_diameter, c.b_core_diameter) * core

    def pair_forces(self, x, core: float, with_energy: bool = False):
        """A/B softcore repulsion of every pair (forcefield.cpp:30-52):
        (forces, energy)."""
        params = self._ab(core)
        n = x.shape[0]
        forces = x.new_zeros((n + 1, 3))
        energy = x.new_zeros(())
        af, bf = torch.cat([self.af, self.af[:1]]), torch.cat([self.bf, self.bf[:1]])
        for rows, cols, dx, r2 in self._blocks(x, self._reach(core)):
            a_mix = 0.5 * (af[rows][:, :, None] + af[cols][:, None, :])
            b_mix = 0.5 * (bf[rows][:, :, None] + bf[cols][:, None, :])
            c = pot.ab_pair_force_coeff(r2, a_mix, b_mix, params)
            forces.index_add_(0, rows.reshape(-1),
                              torch.sum(c[..., None] * dx, dim=2).reshape(-1, 3))
            if with_energy:
                energy = energy + 0.5 * torch.sum(pot.ab_pair_energy(r2, a_mix, b_mix, params))
        return forces[:n], energy

    @staticmethod
    def _bond_terms(x, pairs, energy_fn, coeff_fn):
        forces = torch.zeros_like(x)
        if pairs.shape[0] == 0:
            return forces, x.new_zeros(())
        i, j = pairs[:, 0], pairs[:, 1]
        dx = x[i] - x[j]
        r2 = torch.sum(dx * dx, dim=-1)
        f = coeff_fn(r2)[:, None] * dx
        forces.index_add_(0, i, f)
        forces.index_add_(0, j, -f)
        return forces, torch.sum(energy_fn(r2))

    def bonded_forces(self, x, bond: float):
        """Chain bonds, loops, nucleolar bonds and droplet at bond scale
        ``bond``: (forces, energy)."""
        c = self.config
        s2 = bond * bond
        k, length = self.bond_spring / s2, self.bond_length * bond
        forces, energy = self._bond_terms(
            x, self.bonds, lambda r2: pot.semispring_energy(r2, k, length),
            lambda r2: pot.semispring_force_coeff(r2, k, length))
        if self.use_loops:
            kl = self.loop_spring / s2
            f, e = self._bond_terms(x, self.loops, lambda r2: pot.harmonic_energy(r2, kl),
                                    lambda r2: pot.harmonic_force_coeff(r2, kl))
            forces, energy = forces + f, energy + e
        kn, ln = c.nucleolus_bond_spring / s2, c.nucleolus_bond_length * bond
        f, e = self._bond_terms(x, self.nuc_bonds, lambda r2: pot.semispring_energy(r2, kn, ln),
                                lambda r2: pot.semispring_force_coeff(r2, kn, ln))
        forces, energy = forces + f, energy + e
        if self.use_droplet:
            f, e = self._droplet(x)
            forces, energy = forces + f, energy + e
        return forces, energy

    def _droplet(self, x):
        """softwell<6> among the nucleolar particles, the force cut at the
        cutoff and the energy shifted to zero there."""
        c = self.config
        ids = self.nuc_targets
        pos = x[ids]
        dx = pos[:, None, :] - pos[None, :, :]
        r2 = torch.sum(dx * dx, dim=-1)
        r2 = r2 + torch.diag(torch.full((len(ids),), float("inf"), dtype=x.dtype, device=x.device))
        e, decay = c.nucleolus_droplet_energy, c.nucleolus_droplet_decay
        cut = c.nucleolus_droplet_cutoff
        coeff = pot.softwell_force_coeff(r2, e, decay, DROPLET_EXPONENT)
        coeff = torch.where(r2 < cut * cut, coeff, torch.zeros_like(coeff))
        u = pot.cutoff_shift(lambda q: pot.softwell_energy(q, e, decay, DROPLET_EXPONENT), r2, cut)
        f = torch.sum(coeff[..., None] * dx, dim=1)
        return torch.zeros_like(x).index_add_(0, ids, f), 0.5 * torch.sum(u)

    def wall_energy(self, x, semiaxes, core: float):
        """The ellipsoidal wall (interphase.cpp, ops/wall): softcore inside
        against the signed distance to the wall along the bead's ray, a
        harmonic packing spring outside."""
        params = dict(self._ab(core, half=True), packing_spring=self.config.wall_packing_spring)
        eps = 1e-12
        x2 = x * x
        r2 = torch.sum(x2, dim=-1) + eps
        s2 = torch.sum(x2 / (semiaxes * semiaxes), dim=-1) + eps
        d = torch.sqrt(r2 / s2) - torch.sqrt(r2)
        d2 = d * d
        u_in = pot.ab_pair_energy(d2, self.wall_a, self.wall_b, params)
        u_out = pot.harmonic_energy(d2, params["packing_spring"])
        return torch.sum(torch.where(d > 0, u_in, u_out))

    def wall_forces(self, x, semiaxes, core: float):
        """(forces, axial reaction (3,), energy) by differentiating the
        wall's energy."""
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            ag = semiaxes.detach().requires_grad_(True)
            energy = self.wall_energy(xg, ag, core)
            gx, ga = torch.autograd.grad(energy, (xg, ag))
        return -gx, -ga, energy.detach()

    # -- step, energy, tick ----------------------------------------------------

    def step(self, x, semiaxes, noise, step: int):
        """G1 step ``step`` of one replica from (x, semiaxes) on the normals
        ``noise``: returns (new x, new semiaxes, the largest |mu F| dt)."""
        c = self.config
        core, bond = self.scales((step - 1) * c.timestep)
        forces, _ = self.pair_forces(x, core)
        f, _ = self.bonded_forces(x, bond)
        fw, reaction, _ = self.wall_forces(x, semiaxes, core)
        forces = forces + f + fw
        drift = self.mobility[:, None] * forces * c.timestep
        sigma = torch.sqrt(2.0 * c.temperature * self.mobility * c.timestep)
        x_new = x + drift + sigma[:, None] * noise
        spring = torch.as_tensor(c.wall_semiaxes_spring, dtype=x.dtype, device=x.device)
        semi_new = semiaxes + c.timestep * c.wall_mobility * (reaction - spring * semiaxes)
        return x_new, semi_new, torch.linalg.norm(drift, dim=-1).max()

    def run(self, x, semiaxes, noise_at, first: int, steps: int):
        """G1 steps ``first`` to ``first + steps - 1`` of one replica, step
        ``s`` on the normals ``noise_at(s)``: returns (x, semiaxes)."""
        for s in range(first, first + steps):
            x, semiaxes, _ = self.step(x, semiaxes, noise_at(s), s)
        return x, semiaxes

    def mean_energy(self, x, semiaxes, step: int):
        """Total energy over the particle count at time ``step`` dt: pair,
        bonded and wall terms at that time's scales."""
        core, bond = self.scales(step * self.config.timestep)
        _, e_pair = self.pair_forces(x, core, with_energy=True)
        _, e_bond = self.bonded_forces(x, bond)
        return (e_pair + e_bond + self.wall_energy(x, semiaxes, core)) / self.n

    def contacts(self, x, step: int, band: float):
        """Pairs i < j within the contact distance at the tick of ``step``:
        (keys of the pairs found, keys of the pairs whose r^2 lies within
        ``band`` of the cutoff^2, relatively), keys ``i << 32 | j`` as a
        sorted int64 numpy array."""
        core, _ = self.scales(step * self.config.timestep)
        cutoff2 = (self.config.contactmap_distance * core) ** 2
        found, near = [], []
        reach = math.sqrt(cutoff2 * (1.0 + band))
        for rows, cols, _, r2 in self._blocks(x, reach):
            i, j = rows[:, :, None], cols[:, None, :]
            for store, hit in ((found, r2 < cutoff2),
                               (near, torch.abs(r2 - cutoff2) <= band * cutoff2)):
                hit = hit & (j > i)
                store.append(((i << 32 | j).expand(hit.shape))[hit].cpu().numpy())
        empty = np.zeros(0, np.int64)
        return np.sort(np.concatenate(found or [empty])), np.sort(np.concatenate(near or [empty]))
