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

On a CUDA tensor :func:`bd_update` launches the update kernel of
``csrc/step_rest.cu`` (the displacement limit reduced on the device);
:func:`bd_update_reference` is its plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import step_rest
from ..utils import tracing


class BDParams(NamedTuple):
    temperature: float
    timestep: float
    spacestep: Optional[float] = None


@tracing.traced("noise")
def standard_normal(positions, generator):
    """The update's standard normals, of the positions' shape: (N, 3) from
    one ``generator``, or (R, N, 3) from a sequence of R, replica r drawing
    what a single run with its generator draws."""
    if positions.dim() == 3:
        return torch.stack([
            torch.randn(positions.shape[1:], dtype=positions.dtype,
                        device=positions.device, generator=g)
            for g in generator
        ])
    return torch.randn(
        positions.shape, dtype=positions.dtype, device=positions.device,
        generator=generator,
    )


def bd_update_reference(positions, forces, mobility, generator, params: BDParams, noise=None):
    """Plain version of :func:`bd_update`."""
    dt = params.timestep
    drift_vel = mobility[:, None] * forces  # mu F
    if params.spacestep is not None:
        max_disp = torch.linalg.norm(drift_vel, dim=-1).amax(dim=-1, keepdim=True) * dt
        scale = torch.clamp(
            params.spacestep / torch.clamp(max_disp, min=1e-30), max=1.0
        )
        dt = dt * scale                      # (..., 1): one step a replica
    sigma = torch.sqrt(2.0 * params.temperature * mobility * dt)
    if noise is None:
        noise = standard_normal(positions, generator)
    if torch.is_tensor(dt):
        dt = dt[..., None]
    return positions + drift_vel * dt + sigma[..., None] * noise


def bd_update(positions, forces, mobility, generator, params: BDParams, noise=None):
    """One Euler-Maruyama step; returns new positions.

    ``positions`` (N, 3) with one ``generator``, or (R, N, 3) for R
    independent replicas with a sequence of R generators: replica r draws
    from its own, the numbers a single run with that generator draws, and the
    displacement limit takes the largest drift of each replica apart.
    ``noise`` replaces the draws of standard normals, so that a test can hand
    two implementations the same numbers.  No host synchronisation: the
    displacement limit stays a tensor on the device.

    On a CUDA tensor the update kernel runs (the draws are the same
    ``torch.randn`` calls), or the call raises; on a CPU tensor the plain
    version :func:`bd_update_reference` does.
    """
    if positions.device.type != "cuda":
        return bd_update_reference(positions, forces, mobility, generator, params, noise)
    if noise is None:
        noise = standard_normal(positions, generator)
    return step_rest.launch_update(positions, forces, mobility, noise, params.temperature,
                                   params.timestep, params.spacestep)
