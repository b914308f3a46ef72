"""Overdamped Langevin (Brownian dynamics) integration.

Replacement for ``md::simulate_brownian_dynamics`` (SURVEY.md
§2.9): an Euler-Maruyama update

    x += mu * F * dt + sqrt(2 * mu * kT * dt) * xi,   xi ~ N(0, 1)

with per-particle mobility mu and an explicit ``torch.Generator`` on the
positions' device for the noise (instead of the reference's seeded mt19937).

``spacestep`` reproduces micromd's displacement-limited stepping used by the
interphase relaxation (simulation_driver_relaxation.cpp:48-55): the effective
timestep of a step is scaled down so the largest deterministic displacement
|mu F| dt does not exceed ``spacestep`` (noise scales with sqrt(dt_eff)
accordingly), defusing huge forces in fresh spline-resampled structures.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class BDParams(NamedTuple):
    temperature: float
    timestep: float
    spacestep: Optional[float] = None


def bd_update(positions, forces, mobility, generator, params: BDParams, noise=None):
    """One Euler-Maruyama step; returns new positions.

    ``noise`` (N, 3) replaces the generator's draw of standard normals, so
    that a test can hand two implementations the same numbers.  No host
    synchronisation: the displacement limit stays a tensor on the device.
    """
    dt = params.timestep
    drift_vel = mobility[:, None] * forces  # mu F
    if params.spacestep is not None:
        max_disp = torch.max(torch.linalg.norm(drift_vel, dim=-1)) * dt
        scale = torch.clamp(
            params.spacestep / torch.clamp(max_disp, min=1e-30), max=1.0
        )
        dt = dt * scale
    sigma = torch.sqrt(2.0 * params.temperature * mobility * dt)
    if noise is None:
        noise = torch.randn(
            positions.shape, dtype=positions.dtype, device=positions.device,
            generator=generator,
        )
    return positions + drift_vel * dt + sigma[:, None] * noise
