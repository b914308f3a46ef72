"""Simulation configuration: JSON round-trip with compiled-in defaults.

Reference parity: ``src/simulation/common/simulation_config.hpp:15-123`` and
``simulation_config.cpp:42-164``.  Every field is optional
in the JSON input and falls back to the defaults below; the *resolved* config
is re-serialized into the trajectory store next to the raw source text
(provenance design of ``stage_prepare/prepare.cpp:377-382``).

Deliberate deviation from the reference: ``a_core_2nd_bond_spring`` and
``b_core_2nd_bond_spring`` exist in the reference struct
(``simulation_config.hpp:88-89``) but are missing from its JSON traits
(``simulation_config.cpp:109-118``), which makes the intra-TAD loop force
permanently inert there.  We expose them in JSON (documented fix; see
SURVEY.md §2.2).  Their default remains 0, so default behaviour matches.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

Vec3 = tuple[float, float, float]


@dataclasses.dataclass
class ABFactor:
    """(a, b) weight pair; serialized as a 2-element JSON array.

    Reference: ``ab_factor_config`` (simulation_config.hpp:8-12) with the
    custom array traits in simulation_config.cpp:13-38.
    """

    a: float = 0.0
    b: float = 0.0

    def to_json(self) -> list[float]:
        return [self.a, self.b]

    @classmethod
    def from_json(cls, obj: Any) -> "ABFactor":
        a, b = obj
        return cls(float(a), float(b))


@dataclasses.dataclass
class MitoticPhaseConfig:
    """Parameters of the coarse-grained mitotic stages.

    Reference: ``mitotic_phase_config`` (simulation_config.hpp:15-58).
    """

    # Overdamped Langevin dynamics
    temperature: float = 1.0
    timestep: float = 1e-4
    anaphase_steps: int = 200_000
    telophase_steps: int = 50_000
    prometaphase_steps: int = 400_000
    sampling_interval: int = 1000
    logging_interval: int = 10_000

    # Initialization
    anaphase_start_stddev: float = 1.0

    # Polymer chain
    coarse_graining: int = 100
    core_diameter: float = 0.3
    core_repulsion: float = 2.0
    bond_length: float = 0.3
    bond_spring: float = 1000.0
    bending_energy: float = 1.0
    penalize_centromere_bending: bool = False
    core_mobility: float = 0.1

    # Sister chromatids
    sister_separation: float = 0.3
    sister_spring: float = 1000.0

    # Field-approximated microtubules
    spindle_axis: Vec3 = (0.0, 5.0, 0.0)
    kfiber_decay_rate_prometaphase: float = 1.0
    kfiber_decay_rate_anaphase: float = 1.0
    kfiber_length_prometaphase: float = 0.0
    kfiber_length_anaphase: float = 0.0
    polar_ejection_force: float = 0.0
    polar_ejection_cross_section: float = 0.0

    # Anatelophase modifications
    anaphase_spindle_shift: Vec3 = (0.0, 2.0, 0.0)
    telophase_packing_radius: float = 1.5
    telophase_packing_spring: float = 100.0
    telophase_bond_spring_multiplier: float = 1.0
    telophase_bending_energy_multiplier: float = 1.0


@dataclasses.dataclass
class InterphaseConfig:
    """Parameters of the interphase (relaxation + G1) stage.

    Reference: ``interphase_config`` (simulation_config.hpp:61-115).
    """

    # Overdamped Langevin dynamics
    temperature: float = 1.0
    timestep: float = 1e-5
    steps: int = 700_000
    sampling_interval: int = 1000
    logging_interval: int = 1000
    relaxation_spacestep: float = 0.001
    relaxation_steps: int = 10_000
    relaxation_sampling_interval: int = 1000
    relaxation_logging_interval: int = 100

    # Contact map
    contactmap_distance: float = 0.24
    contactmap_update_interval: int = 20
    contactmap_output_window: int = 10

    # Repulsive copolymer
    a_core_diameter: float = 0.30
    b_core_diameter: float = 0.24
    a_core_repulsion: float = 2.5
    b_core_repulsion: float = 2.5
    a_core_bond_spring: float = 100.0
    b_core_bond_spring: float = 50.0
    a_core_bond_length: float = 0.0
    b_core_bond_length: float = 0.0
    a_core_2nd_bond_spring: float = 0.0   # JSON-exposed here (see module docstring)
    b_core_2nd_bond_spring: float = 0.0   # JSON-exposed here (see module docstring)
    a_core_mobility: float = 1.0
    b_core_mobility: float = 1.0

    # Scheduled expansion
    core_scale_init: float = 0.5
    core_scale_tau: float = 0.5
    bond_scale_init: float = 0.5
    bond_scale_tau: float = 0.5

    # Nucleolar particles
    nucleolus_bead_count: int = 2
    nucleolus_ab_factor: ABFactor = dataclasses.field(
        default_factory=lambda: ABFactor(0.0, 10.0)
    )
    nucleolus_bond_spring: float = 10.0
    nucleolus_bond_length: float = 0.0
    nucleolus_droplet_energy: float = 0.3
    nucleolus_droplet_decay: float = 0.2
    nucleolus_droplet_cutoff: float = 0.4
    nucleolus_mobility: float = 1.0

    # Ellipsoidal, moving wall
    wall_semiaxes_init: Vec3 = (2.0, 2.0, 2.0)
    wall_semiaxes_spring: Vec3 = (3e4, 3e4, 3e4)
    wall_packing_spring: float = 1000.0
    wall_ab_factor: ABFactor = dataclasses.field(
        default_factory=lambda: ABFactor(0.0, 10.0)
    )
    wall_mobility: float = 2e-4


@dataclasses.dataclass
class SimulationConfig:
    """Top-level config; `source` holds the raw JSON input text (provenance).

    Reference: ``simulation_config`` (simulation_config.hpp:118-123).
    """

    mitotic_phase: MitoticPhaseConfig = dataclasses.field(
        default_factory=MitoticPhaseConfig
    )
    interphase: InterphaseConfig = dataclasses.field(default_factory=InterphaseConfig)
    source: str = ""


_VEC3_FIELDS = {
    "spindle_axis",
    "anaphase_spindle_shift",
    "wall_semiaxes_init",
    "wall_semiaxes_spring",
}
_AB_FIELDS = {"nucleolus_ab_factor", "wall_ab_factor"}
_INT_FIELDS = {
    "anaphase_steps",
    "telophase_steps",
    "prometaphase_steps",
    "sampling_interval",
    "logging_interval",
    "coarse_graining",
    "steps",
    "relaxation_steps",
    "relaxation_sampling_interval",
    "relaxation_logging_interval",
    "contactmap_update_interval",
    "contactmap_output_window",
    "nucleolus_bead_count",
}


def _block_from_json(cls, obj: dict):
    block = cls()
    known = {f.name for f in dataclasses.fields(cls)}
    for key, value in obj.items():
        if key not in known:
            raise ValueError(f"unknown config key: {cls.__name__}.{key}")
        if key in _VEC3_FIELDS:
            value = tuple(float(v) for v in value)
            if len(value) != 3:
                raise ValueError(f"{key} must be a 3-vector")
        elif key in _AB_FIELDS:
            value = ABFactor.from_json(value)
        elif key in _INT_FIELDS:
            value = int(value)
        elif key == "penalize_centromere_bending":
            value = bool(value)
        else:
            value = float(value)
        setattr(block, key, value)
    return block


def _block_to_json(block) -> dict:
    out = {}
    for f in dataclasses.fields(block):
        value = getattr(block, f.name)
        if f.name in _VEC3_FIELDS:
            value = list(value)
        elif f.name in _AB_FIELDS:
            value = value.to_json()
        out[f.name] = value
    return out


def parse_config(text: str) -> SimulationConfig:
    """Parse a JSON config; all fields optional (reference: parse_simulation_config,
    simulation_config.cpp:151-156)."""
    obj = json.loads(text)
    config = SimulationConfig(
        mitotic_phase=_block_from_json(MitoticPhaseConfig, obj.get("mitotic_phase", {})),
        interphase=_block_from_json(InterphaseConfig, obj.get("interphase", {})),
        source=text,
    )
    return config


def format_config(config: SimulationConfig) -> str:
    """Serialize the resolved config (reference: format_simulation_config,
    simulation_config.cpp:159-164)."""
    return json.dumps(
        {
            "mitotic_phase": _block_to_json(config.mitotic_phase),
            "interphase": _block_to_json(config.interphase),
        },
        separators=(",", ":"),
    )


def default_config() -> SimulationConfig:
    return SimulationConfig(source="{}")
