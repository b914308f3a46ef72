"""Ellipsoidal nuclear-envelope wall: confinement forces + axial reaction.

Replaces micromd's ``make_ellipsoid_inward_forcefield`` /
``make_ellipsoid_outward_forcefield`` pair with ``stats.axial_reaction``
(reference usage: stage_interphase/simulation_driver_forcefield.cpp:189-244).

Geometry: for a particle at x and semiaxes a, let s = sqrt(sum(x_i^2/a_i^2))
be the scaled radius.  The signed distance to the surface is approximated
along the radial ray: d = |x| (1/s - 1) (positive inside).  The inward field
evaluates a per-particle mixed softcore at that distance (half-diameter cores,
so B-type beads with wall_ab_factor b=10 are pressed harder — the lamina
attraction of heterochromatin modeled as differential wall repulsion); the
outward field is a harmonic recapture spring on the penetration depth.

Both the particle forces and the per-axis wall reaction are derived from one
scalar energy by automatic differentiation (``torch.autograd.grad``):

    forces         = -dU/dx
    axial_reaction = -dU/da   (generalized force conjugate to each semiaxis)

which is exactly the quantity the wall-inflation ODE consumes
(simulation_driver_interphase.cpp:79-90).  micromd accumulates its reaction
statistic during force evaluation; the autodiff formulation is guaranteed
consistent with the energy by construction.
"""

from __future__ import annotations

import torch

from . import potentials


def wall_energy(positions, semiaxes, a_mix, b_mix, params):
    """Total wall energy.

    ``positions`` (N, 3) with ``semiaxes`` (3,), or R replicas: (R, N, 3)
    with (R, 3), each replica in its own wall.  ``a_mix``/``b_mix``:
    per-particle mixed weights (a_i + wall_a)/2 and (b_i + wall_b)/2.
    ``params``: dict with ``a_energy``, ``a_diameter``, ``b_energy``,
    ``b_diameter`` (HALF core diameters, pre-scaled by core_scale) and
    ``packing_spring``.

    ``eps`` keeps both radicands away from zero, so the gradient is finite
    for a bead at the origin; both branches of the final ``where`` are
    finite polynomials of ``d2``, so the unused one never passes a NaN
    gradient, also not for a bead exactly on the wall.
    """
    eps = 1e-12
    x2 = positions * positions
    r2 = torch.sum(x2, dim=-1) + eps
    s2 = torch.sum(x2 / (semiaxes * semiaxes)[..., None, :], dim=-1) + eps
    # R(direction) = |x| / s: radius of the ellipsoid along the particle's ray.
    d = torch.sqrt(r2 / s2) - torch.sqrt(r2)  # signed distance, >0 inside
    d2 = d * d

    inside = d > 0
    u_in = potentials.ab_pair_energy(d2, a_mix, b_mix, params)
    u_out = potentials.harmonic_energy(d2, params["packing_spring"])
    return torch.sum(torch.where(inside, u_in, u_out))


def wall_forces(positions, semiaxes, a_mix, b_mix, params):
    """Returns (forces (N,3), axial_reaction (3,), energy), all detached.

    For R replicas, (R, N, 3) forces and an (R, 3) reaction: the energy is
    summed over the replicas, and since replica r's term depends on its own
    semiaxes only, row r of the gradient is replica r's reaction."""
    with torch.enable_grad():
        x = positions.detach().requires_grad_(True)
        a = semiaxes.detach().requires_grad_(True)
        energy = wall_energy(x, a, a_mix, b_mix, params)
        grad_x, grad_a = torch.autograd.grad(energy, (x, a))
    return -grad_x, -grad_a, energy.detach()
