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
scalar energy:

    forces         = -dU/dx
    axial_reaction = -dU/da   (generalized force conjugate to each semiaxis)

which is exactly the quantity the wall-inflation ODE consumes
(simulation_driver_interphase.cpp:79-90).  micromd accumulates its reaction
statistic during force evaluation.  The plain version,
:func:`wall_forces_reference`, differentiates the energy by autograd
(``torch.autograd.grad``), consistent with it by construction; on the card
:func:`wall_forces` launches the rest kernel of ``csrc/step_rest.cu``, which
takes the derivatives in closed form, and :func:`wall_forces_analytic` is
that arithmetic in plain torch, held against autograd on the CPU.
"""

from __future__ import annotations

import torch

from . import potentials, step_rest


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


def wall_forces_reference(positions, semiaxes, a_mix, b_mix, params):
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


def wall_forces_analytic(positions, semiaxes, a_mix, b_mix, params):
    """:func:`wall_forces_reference` with the derivatives in closed form, the
    arithmetic of the rest kernel (``csrc/step_rest.cu``).  With
    R = sqrt(r2/s2) the radius of the wall along the bead's ray, d = R -
    sqrt(r2) and c = -2 dU/d(d^2) (the potentials' force coefficient):

        dd/dx_k = x_k [(1 - r2/(a_k^2 s2)) / (R s2) - 1/sqrt(r2)]
        dd/da_k = r2 x_k^2 / (R s2^2 a_k^3)
        F_k = c d dd/dx_k,   reaction_k = sum over beads of c d dd/da_k.

    At the origin x_k = 0 makes the force 0 (eps keeps the bracket finite);
    on the wall d = 0 does.

    d is a small difference of two numbers of the wall's size near the wall,
    so its rounding, magnified by the steep softcore, would show in the
    force: r2, s2, R and d are taken in float64 (for float32 positions as
    well), and the rest in the positions' dtype."""
    eps = 1e-12
    dtype = positions.dtype
    x2 = positions * positions
    a2 = (semiaxes * semiaxes)[..., None, :]
    wide = positions.double() ** 2
    r2_wide = torch.sum(wide, dim=-1) + eps
    s2_wide = torch.sum(wide / (semiaxes.double() ** 2)[..., None, :], dim=-1) + eps
    radius_wide = torch.sqrt(r2_wide / s2_wide)
    root_wide = torch.sqrt(r2_wide)
    d = (radius_wide - root_wide).to(dtype)
    r2, s2 = r2_wide.to(dtype), s2_wide.to(dtype)
    radius, root = radius_wide.to(dtype), root_wide.to(dtype)
    d2 = d * d
    inside = d > 0
    c_in = potentials.ab_pair_force_coeff(d2, a_mix, b_mix, params)
    c_out = potentials.harmonic_force_coeff(d2, params["packing_spring"])
    u_in = potentials.ab_pair_energy(d2, a_mix, b_mix, params)
    u_out = potentials.harmonic_energy(d2, params["packing_spring"])
    g = torch.where(inside, c_in, c_out) * d
    rs2 = radius * s2
    q = (r2 / s2)[..., None]
    dd_dx = positions * ((1.0 - q / a2) / rs2[..., None] - (1.0 / root)[..., None])
    forces = g[..., None] * dd_dx
    h = g * r2 / (rs2 * s2)
    reaction = torch.sum(h[..., None] * x2 / (a2 * semiaxes[..., None, :]), dim=-2)
    energy = torch.sum(torch.where(inside, u_in, u_out))
    return forces, reaction, energy


def wall_forces(positions, semiaxes, a_mix, b_mix, params):
    """Returns (forces (N,3), axial_reaction (3,), energy), all detached; for
    R replicas (R, N, 3) forces and an (R, 3) reaction, the energy summed.

    On a CUDA tensor the rest kernel of ``csrc/step_rest.cu`` (bonds off)
    computes all three in one launch, or the call raises; on a CPU tensor
    the plain version :func:`wall_forces_reference` (autograd) does."""
    if positions.device.type != "cuda":
        return wall_forces_reference(positions, semiaxes, a_mix, b_mix, params)
    rest = step_rest.launch_rest(
        positions, wall=step_rest.WallRows(semiaxes, a_mix, b_mix, params), with_energy=True)
    return rest.out, rest.reaction, rest.wall_energy
