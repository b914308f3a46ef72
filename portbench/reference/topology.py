"""Topology compiler: chains.tsv -> per-stage particle/chain designs.

Pure host-side (numpy) input compilation, replicating the semantics of the
reference ``stage_prepare`` pipeline:

- chains.tsv record grouping: ``stage_prepare/chains.cpp:14-63``
- bead typing by first matching tag:  ``stage_prepare/prepare.cpp:175-197``
- nucleolar particle appending:       ``prepare.cpp:221-238``
- anatelophase coarse-graining + kinetochore midpoint: ``prepare.cpp:241-314``
- prometaphase sister duplication + poles: ``prepare.cpp:317-370``
- stage seed derivation (std::seed_seq): ``prepare.cpp:549-562``
"""

from __future__ import annotations

import dataclasses
import io
import sys
from typing import Optional

import numpy as np

from .config import SimulationConfig

# Numerical codes used in "/stages/*/metadata/particle_types" (enum dtype).
# Reference: stage_prepare/prepare.cpp:15-34.
INTERPHASE_TYPES = {
    "unknown": 0,
    "a": 1,
    "b": 2,
    "u": 3,
    "centromere": 4,
    "active_nor": 5,
    "silent_nor": 6,
    "nucleolus": 7,
}
MITOTIC_TYPES = {
    "unknown": 0,
    "arm": 1,
    "kinetochore": 2,
}

# Tag -> type priority order (first match wins). Reference: prepare.cpp:175-182.
_TAG_TYPE_ORDER = [
    ("anor", INTERPHASE_TYPES["active_nor"]),
    ("bnor", INTERPHASE_TYPES["silent_nor"]),
    ("cen", INTERPHASE_TYPES["centromere"]),
    ("A", INTERPHASE_TYPES["a"]),
    ("B", INTERPHASE_TYPES["b"]),
    ("u", INTERPHASE_TYPES["u"]),
]


@dataclasses.dataclass
class ChainBead:
    bin_start: int
    bin_end: int
    a_factor: float
    b_factor: float
    tags: str


@dataclasses.dataclass
class ChainDefinition:
    name: str
    beads: list[ChainBead]


@dataclasses.dataclass
class ChainDefinitions:
    chains: list[ChainDefinition]
    source: str


@dataclasses.dataclass
class ChainAssignment:
    """Half-open bead range [start, end) of one chain, with optional kinetochore."""

    name: str
    start: int
    end: int
    kinetochore: Optional[int] = None


@dataclasses.dataclass
class InterphaseTopology:
    particle_types: np.ndarray          # (N,) int32, INTERPHASE_TYPES codes
    ab_factors: np.ndarray              # (N, 2) float
    chains: list[ChainAssignment]
    nor_indices: np.ndarray             # (#aNOR,) int
    nucleolar_bonds: np.ndarray         # (B, 2) int (nor_index, nucleolus_index)


@dataclasses.dataclass
class AnatelophaseTopology:
    particle_types: np.ndarray          # (M,) int32, MITOTIC_TYPES codes
    chains: list[ChainAssignment]


@dataclasses.dataclass
class PrometaphaseTopology:
    particle_types: np.ndarray          # (2M,) int32
    chains: list[ChainAssignment]       # target/sister interleaved per chromosome
    sister_chromatids: np.ndarray       # (C, 2) int chain-index pairs
    pole_positions: np.ndarray          # (2, 3) float


@dataclasses.dataclass
class GenomeTopology:
    interphase: InterphaseTopology
    anatelophase: AnatelophaseTopology
    prometaphase: PrometaphaseTopology


def load_chains(path_or_text) -> ChainDefinitions:
    """Parse a chains.tsv file: columns ``chain start end a b tags``.

    Contiguous records with the same chain name are grouped into one chain
    (reference: chains.cpp:40-61).
    """
    if hasattr(path_or_text, "read"):
        source = path_or_text.read()
    elif "\n" in str(path_or_text) or "\t" in str(path_or_text):
        source = str(path_or_text)
    else:
        with open(path_or_text) as f:
            source = f.read()

    chains: list[ChainDefinition] = []
    current: Optional[ChainDefinition] = None

    lines = source.splitlines()
    if not lines:
        return ChainDefinitions(chains=[], source=source)

    header = lines[0].rstrip("\n").split("\t")
    expected = ["chain", "start", "end", "A", "B", "tags"]
    # Accept lowercase a/b header too.
    norm = [h if h not in ("a", "b") else h.upper() for h in header]
    if norm != expected:
        raise ValueError(f"bad chains.tsv header: {header!r}, expected {expected!r}")

    for line in lines[1:]:
        if not line.strip():
            continue
        fields = line.split("\t")
        if len(fields) != 6:
            raise ValueError(f"bad chains.tsv record: {line!r}")
        name, start, end, a, b, tags = fields
        if current is None or current.name != name:
            if current is not None and current.beads:
                chains.append(current)
            current = ChainDefinition(name=name, beads=[])
        current.beads.append(
            ChainBead(
                bin_start=int(start),
                bin_end=int(end),
                a_factor=float(a),
                b_factor=float(b),
                tags=tags,
            )
        )
    if current is not None and current.beads:
        chains.append(current)

    return ChainDefinitions(chains=chains, source=source)


def _check_tag(tags: str, tag: str) -> bool:
    """Exact comma-delimited membership test (reference: prepare.cpp:148-165)."""
    return tag in tags.split(",")


def compile_interphase(
    chains: ChainDefinitions, config: SimulationConfig
) -> InterphaseTopology:
    particle_types: list[int] = []
    ab_factors: list[tuple[float, float]] = []
    assignments: list[ChainAssignment] = []
    nor_indices: list[int] = []

    for chain in chains.chains:
        start = len(particle_types)
        for bead in chain.beads:
            bead_index = len(particle_types)
            bead_type = INTERPHASE_TYPES["unknown"]
            for tag, type_code in _TAG_TYPE_ORDER:
                if _check_tag(bead.tags, tag):
                    bead_type = type_code
                    break
            if bead_type == INTERPHASE_TYPES["active_nor"]:
                nor_indices.append(bead_index)
            particle_types.append(bead_type)
            ab_factors.append((bead.a_factor, bead.b_factor))
        assignments.append(
            ChainAssignment(name=chain.name, start=start, end=len(particle_types))
        )

    # Nucleolar particles appended after all chains (prepare.cpp:221-238).
    nucleolar_bonds: list[tuple[int, int]] = []
    icfg = config.interphase
    for nor_index in nor_indices:
        for _ in range(icfg.nucleolus_bead_count):
            nucleolus_index = len(particle_types)
            particle_types.append(INTERPHASE_TYPES["nucleolus"])
            ab_factors.append((icfg.nucleolus_ab_factor.a, icfg.nucleolus_ab_factor.b))
            nucleolar_bonds.append((nor_index, nucleolus_index))

    return InterphaseTopology(
        particle_types=np.asarray(particle_types, dtype=np.int32),
        ab_factors=np.asarray(ab_factors, dtype=np.float64).reshape(-1, 2),
        chains=assignments,
        nor_indices=np.asarray(nor_indices, dtype=np.int64),
        nucleolar_bonds=np.asarray(nucleolar_bonds, dtype=np.int64).reshape(-1, 2),
    )


def compile_anatelophase(
    interphase: InterphaseTopology, config: SimulationConfig
) -> AnatelophaseTopology:
    coarse_graining = config.mitotic_phase.coarse_graining
    particle_types: list[int] = []
    assignments: list[ChainAssignment] = []

    for assign in interphase.chains:
        # Centromeric range [start, end) of the fine chain (prepare.cpp:251-274).
        cen_start, cen_end = assign.start, assign.end
        seen = False
        for i in range(assign.start, assign.end):
            if interphase.particle_types[i] == INTERPHASE_TYPES["centromere"]:
                if not seen:
                    cen_start = i
                    seen = True
                cen_end = i + 1
        if not seen:
            print(f"No centromere found on {assign.name}", file=sys.stderr)

        length = assign.end - assign.start
        coarse_length = length // coarse_graining
        coarse_start = len(particle_types)

        centromere_midpoint = (cen_start + cen_end) // 2
        kinetochore_offset = (centromere_midpoint - assign.start) // coarse_graining

        kinetochore_index: Optional[int] = None
        for bin_index in range(coarse_length):
            bead_index = len(particle_types)
            type_code = MITOTIC_TYPES["arm"]
            if bin_index == kinetochore_offset:
                type_code = MITOTIC_TYPES["kinetochore"]
                kinetochore_index = bead_index
            particle_types.append(type_code)

        assignments.append(
            ChainAssignment(
                name=assign.name,
                start=coarse_start,
                end=coarse_start + coarse_length,
                kinetochore=kinetochore_index,
            )
        )

    return AnatelophaseTopology(
        particle_types=np.asarray(particle_types, dtype=np.int32),
        chains=assignments,
    )


def compile_prometaphase(
    anatelophase: AnatelophaseTopology, config: SimulationConfig
) -> PrometaphaseTopology:
    """Duplicate each chromatid into target + "-copy" sister (prepare.cpp:317-370)."""
    sister_chromatids = np.asarray(
        [(2 * i, 2 * i + 1) for i in range(len(anatelophase.chains))], dtype=np.int64
    ).reshape(-1, 2)

    particle_types: list[int] = []
    assignments: list[ChainAssignment] = []

    for assign in anatelophase.chains:
        chain_length = assign.end - assign.start
        # A chain shorter than coarse_graining beads coarse-grains to zero
        # beads and has no kinetochore (the reference would hit UB here via
        # optional::operator*; we degrade gracefully to offset 0).
        if assign.kinetochore is None:
            kinetochore_offset = 0
        else:
            kinetochore_offset = assign.kinetochore - assign.start

        target_start = assign.start * 2
        target_end = target_start + chain_length
        sister_start = target_end
        sister_end = sister_start + chain_length

        assignments.append(
            ChainAssignment(
                name=assign.name,
                start=target_start,
                end=target_end,
                kinetochore=target_start + kinetochore_offset,
            )
        )
        assignments.append(
            ChainAssignment(
                name=assign.name + "-copy",
                start=sister_start,
                end=sister_end,
                kinetochore=sister_start + kinetochore_offset,
            )
        )

        segment = list(anatelophase.particle_types[assign.start : assign.end])
        particle_types.extend(segment)
        particle_types.extend(segment)

    spindle_axis = np.asarray(config.mitotic_phase.spindle_axis, dtype=np.float64)
    pole_positions = np.stack([-spindle_axis, +spindle_axis])

    return PrometaphaseTopology(
        particle_types=np.asarray(particle_types, dtype=np.int32),
        chains=assignments,
        sister_chromatids=sister_chromatids,
        pole_positions=pole_positions,
    )


def compile_topology(
    chains: ChainDefinitions, config: SimulationConfig
) -> GenomeTopology:
    interphase = compile_interphase(chains, config)
    anatelophase = compile_anatelophase(interphase, config)
    prometaphase = compile_prometaphase(anatelophase, config)
    return GenomeTopology(
        interphase=interphase,
        anatelophase=anatelophase,
        prometaphase=prometaphase,
    )


def derive_stage_seeds(master_seed: int) -> dict[str, int]:
    """Derive the three stage seeds exactly as ``std::seed_seq{master}`` does
    (prepare.cpp:549-562): anaphase, interphase, prometaphase in order."""
    values = seed_seq_generate([master_seed], 3)
    return {
        "anaphase": values[0],
        "interphase": values[1],
        "prometaphase": values[2],
    }


def seed_seq_generate(seeds: list[int], n: int) -> list[int]:
    """Bit-exact re-implementation of ``std::seed_seq::generate`` ([rand.util.seedseq]).

    Matching the C++ derivation keeps /stages/*/metadata/seed values identical
    to reference-produced trajectory files for the same master seed.
    """
    if n == 0:
        return []
    mask = 0xFFFFFFFF
    out = [0x8B8B8B8B] * n
    s = len(seeds)
    if n >= 623:
        t = 11
    elif n >= 68:
        t = 7
    elif n >= 39:
        t = 5
    elif n >= 7:
        t = 3
    else:
        t = (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def T(x: int) -> int:
        return (x ^ (x >> 27)) & mask

    for k in range(m):
        r1 = (1664525 * T(out[k % n] ^ out[(k + p) % n] ^ out[(k - 1) % n])) & mask
        if k == 0:
            r2 = (r1 + s) & mask
        elif k <= s:
            r2 = (r1 + (k % n) + seeds[k - 1]) & mask
        else:
            r2 = (r1 + (k % n)) & mask
        out[(k + p) % n] = (out[(k + p) % n] + r1) & mask
        out[(k + q) % n] = (out[(k + q) % n] + r2) & mask
        out[k % n] = r2

    for k in range(m, m + n):
        r3 = (
            1566083941 * T((out[k % n] + out[(k + p) % n] + out[(k - 1) % n]) & mask)
        ) & mask
        r4 = (r3 - (k % n)) & mask
        out[(k + p) % n] = (out[(k + p) % n] ^ r3) & mask
        out[(k + q) % n] = (out[(k + q) % n] ^ r4) & mask
        out[k % n] = r4

    return out
