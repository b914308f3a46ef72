"""State carried across from the JAX package, as numpy arrays.

The port never sees JAX: a caller (a test, a migration script) turns a JAX
``InterphaseModel``, ``AnatelophaseModel`` or ``PrometaphaseModel`` into a
dict of numpy arrays under the dataclass's field names —
``{f.name: np.asarray(getattr(m, f.name)) for f in dataclasses.fields(m)
if f.name in ARRAY_FIELDS}`` with the ``ARRAY_FIELDS`` of the port's module
of that model — and hands it over here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .config import SimulationConfig
from .models.anatelophase import AnatelophaseModel, seeded_generator
from .models.interphase import ARRAY_FIELDS, EngineSettings, InterphaseModel
from .models.prometaphase import PrometaphaseModel


def interphase_model_from_numpy(
    arrays: dict,
    config: SimulationConfig,
    settings: Optional[EngineSettings] = None,
    device=None,
) -> InterphaseModel:
    """The port's :class:`InterphaseModel` from per-bead numpy arrays under
    the JAX dataclass's field names (see ``ARRAY_FIELDS``)."""
    missing = [name for name in ARRAY_FIELDS if name not in arrays]
    if missing:
        raise KeyError(f"arrays lack the fields {missing}")
    return InterphaseModel(config.interphase, arrays, settings, device)


def anatelophase_model_from_numpy(
    arrays: dict, config: SimulationConfig, device=None
) -> AnatelophaseModel:
    """The port's :class:`AnatelophaseModel` from numpy arrays under the JAX
    dataclass's field names (``models.anatelophase.ARRAY_FIELDS``)."""
    return AnatelophaseModel(config.mitotic_phase, arrays, device)


def prometaphase_model_from_numpy(
    arrays: dict, config: SimulationConfig, device=None
) -> PrometaphaseModel:
    """The port's :class:`PrometaphaseModel` from numpy arrays under the JAX
    dataclass's field names (``models.prometaphase.ARRAY_FIELDS``)."""
    return PrometaphaseModel(config.mitotic_phase, arrays, device)


def mitotic_state_from_numpy(positions, seed: int = 0, device=None):
    """The step state ``(x, generator)`` of a mitotic stage from numpy
    positions; the generator lives on ``device`` and is seeded with ``seed``."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(positions), dtype=torch.float32, device=device)
    return (x, seeded_generator(seed, device))


def state_from_numpy(positions, semiaxes, seed: int = 0, device=None,
                     dtype=torch.float32):
    """The step state ``(x, generator, semiaxes)`` from numpy arrays; the
    generator lives on ``device`` and is seeded with ``seed``."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(positions), dtype=dtype, device=device)
    a = torch.as_tensor(np.asarray(semiaxes), dtype=dtype, device=device)
    return (x, seeded_generator(seed, device), a)
