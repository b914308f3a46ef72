"""Potential library: pure elementwise energy/force-coefficient functions.

Every pair potential is expressed through two functions of the *squared*
distance r2:

- ``*_energy(r2, ...)``      -> u(r)
- ``*_force_coeff(r2, ...)`` -> c(r) such that the force on the particle at
  displacement ``dx`` (from the interaction partner / source to the particle)
  is ``F = c * dx``; i.e. c = -(1/r) du/dr, following the micromd convention
  ``evaluate_force(r) = -grad u`` (see e.g. the analytic force in the
  reference's force_flux_potential.hpp:30-37).

Formulating everything in r2 keeps sqrt/rsqrt out of the hot pairwise loops
(the softcore exponents used by the model are even, reference
stage_interphase/simulation_driver_forcefield.cpp:37-46).  Functional forms of
the micromd potentials (softcore/softwell/semispring/spring/harmonic/cosine
bending) are reconstructed from their documented semantics and usage in the
reference (SURVEY.md §2.9); the micromd submodule itself is not vendored there.

All functions are shape-polymorphic elementwise torch code and differentiable
by autograd; scalar parameters may be Python floats or tensors.
"""

from __future__ import annotations

import torch


# -- softcore: bounded polynomial repulsion  u(r) = e (1 - (r/s)^p)^n, r < s --

def softcore_energy(r2, energy, diameter, p: int, n: int):
    """softcore_potential<p, n>{energy, diameter} (micromd).

    u(r) = energy * (1 - (r/diameter)^p)^n for r < diameter, else 0.
    p must be even (2 or 8 in this model).
    """
    s = r2 / (diameter * diameter)
    sp = s ** (p // 2)
    core = 1.0 - sp
    return torch.where(core > 0, energy * core**n, torch.zeros_like(core))


def softcore_force_coeff(r2, energy, diameter, p: int, n: int):
    """c(r2) with F = c * dx:  c = e n p r^(p-2) / s^p * (1 - (r/s)^p)^(n-1)."""
    inv_d2 = 1.0 / (diameter * diameter)
    s = r2 * inv_d2
    sp = s ** (p // 2)
    core = 1.0 - sp
    # r^(p-2)/d^p = s^(p/2 - 1) / d^2
    coeff = energy * n * p * inv_d2 * s ** (p // 2 - 1) * core ** (n - 1)
    return torch.where(core > 0, coeff, torch.zeros_like(core))


# -- softwell: attractive well  u(r) = -e / (1 + (r/d)^n) ----------------------

def softwell_energy(r2, energy, decay_distance, n: int):
    """softwell_potential<n>{energy, decay_distance} (micromd). n even."""
    t = (r2 / (decay_distance * decay_distance)) ** (n // 2)
    return -energy / (1.0 + t)


def softwell_force_coeff(r2, energy, decay_distance, n: int):
    """c = -(1/r) du/dr = -e n t / (r2 (1+t)^2), attraction (c < 0)."""
    inv_d2 = 1.0 / (decay_distance * decay_distance)
    t = (r2 * inv_d2) ** (n // 2)
    denom = (1.0 + t) ** 2
    # du/dr2 = e n/2 * t / r2 / (1+t)^2 ; c = -2 du/dr2
    safe_r2 = torch.clamp(r2, min=1e-30)
    return -energy * n * t / (safe_r2 * denom)


def cutoff_shift(energy_fn, r2, cutoff):
    """micromd apply_cutoff: shift so u(cutoff) = 0 and truncate beyond."""
    u = energy_fn(r2) - energy_fn(torch.as_tensor(cutoff * cutoff, dtype=r2.dtype, device=r2.device))
    return torch.where(r2 < cutoff * cutoff, u, torch.zeros_like(u))


# -- springs ------------------------------------------------------------------

def spring_energy(r2, spring_constant, equilibrium_distance):
    """spring_potential: u = K/2 (r - b)^2."""
    r = torch.sqrt(torch.clamp(r2, min=1e-30))
    d = r - equilibrium_distance
    return 0.5 * spring_constant * d * d


def spring_force_coeff(r2, spring_constant, equilibrium_distance):
    """c = -K (1 - b/r)."""
    r = torch.sqrt(torch.clamp(r2, min=1e-30))
    return -spring_constant * (1.0 - equilibrium_distance / r)


def semispring_energy(r2, spring_constant, equilibrium_distance):
    """semispring_potential: one-sided spring, engages only when stretched
    (r > b). Used for chain bonds and the telophase packing well
    (stage_anatelophase/simulation_driver.cpp:100-110,180-188)."""
    r = torch.sqrt(torch.clamp(r2, min=1e-30))
    d = torch.clamp(r - equilibrium_distance, min=0.0)
    return 0.5 * spring_constant * d * d


def semispring_force_coeff(r2, spring_constant, equilibrium_distance):
    r = torch.sqrt(torch.clamp(r2, min=1e-30))
    stretched = r > equilibrium_distance
    c = -spring_constant * (1.0 - equilibrium_distance / r)
    return torch.where(stretched, c, torch.zeros_like(c))


def harmonic_energy(r2, spring_constant):
    """harmonic_potential: u = K/2 r^2 (about zero separation)."""
    return 0.5 * spring_constant * r2


def harmonic_force_coeff(r2, spring_constant):
    return -spring_constant + torch.zeros_like(r2)


# -- force flux: polar ejection  u(r) = f b atan2(b, r) -----------------------

def force_flux_energy(r2, constant_force, reactive_distance):
    """Reference: common/potentials/force_flux_potential.hpp:24-28."""
    r = torch.sqrt(torch.clamp(r2, min=1e-30))
    return constant_force * reactive_distance * torch.atan2(torch.as_tensor(reactive_distance, dtype=r.dtype, device=r.device), r)


def force_flux_force_coeff(r2, constant_force, reactive_distance):
    """F = f b^2 / (b^2 r + r^3) * dx  (force_flux_potential.hpp:30-37)."""
    r = torch.sqrt(torch.clamp(r2, min=1e-30))
    b2 = reactive_distance * reactive_distance
    return constant_force * b2 / (b2 * r + r * r2)


# -- cosine bending over bonded triples ---------------------------------------

def cosine_bending_energy(r_prev, r_next, bending_energy):
    """cosine_bending_potential: u = e (1 - cos theta), theta the angle between
    consecutive bond vectors r_prev = x[i+1]-x[i], r_next = x[i+2]-x[i+1].
    Zero for a straight chain. Used by the mitotic stages
    (stage_anatelophase/simulation_driver.cpp:119-133)."""
    dot = torch.sum(r_prev * r_next, dim=-1)
    nn = torch.sqrt(
        torch.clamp(
            torch.sum(r_prev * r_prev, dim=-1) * torch.sum(r_next * r_next, dim=-1),
            min=1e-30,
        )
    )
    return bending_energy * (1.0 - dot / nn)


# -- the interphase A/B mixed softcore pair -----------------------------------

def ab_pair_energy(r2, a_mix, b_mix, params):
    """Per-pair A/B copolymer repulsion (simulation_driver_forcefield.cpp:30-52):

    u = a_mix * softcore<2,3>(e_a, d_a * core_scale)
      + b_mix * softcore<8,3>(e_b, d_b * core_scale)

    where a_mix = (a_i + a_j)/2, b_mix = (b_i + b_j)/2. ``params`` is a dict
    with a_energy, a_diameter, b_energy, b_diameter (diameters pre-scaled).
    """
    ua = softcore_energy(r2, params["a_energy"], params["a_diameter"], 2, 3)
    ub = softcore_energy(r2, params["b_energy"], params["b_diameter"], 8, 3)
    return a_mix * ua + b_mix * ub


def ab_pair_force_coeff(r2, a_mix, b_mix, params):
    ca = softcore_force_coeff(r2, params["a_energy"], params["a_diameter"], 2, 3)
    cb = softcore_force_coeff(r2, params["b_energy"], params["b_diameter"], 8, 3)
    return a_mix * ca + b_mix * cb
