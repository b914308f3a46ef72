"""Trajectory .h5 -> GSD/HOOMD visualization file (OVITO-compatible).

Output parity with the reference tool (src/dumpgsd.py): chain backbones
become "chrom" bonds, spindle poles appear as pseudo-particles of type
"spindle_pole" (one in anaphase at the configured spindle shift, two in
prometaphase at the stored pole positions) wired to the kinetochores by
"microtubule" pseudo-bonds, interphase/relaxation frames carry "nucleolus"
pseudo-bonds, and the box is fixed at (100, 100, 100).

The implementation is data-driven rather than the reference's per-stage
decorator class hierarchy: a single :func:`build_scene` compiles the stage's
static topology (type table, backbone + pseudo bond arrays, pseudo-particle
positions) with vectorized numpy index math, and the frame loop just streams
positions through it.  GSD container IO lives in :mod:`gsdio` (original
format implementation).

The PyTorch port's copy of ``genome_cycle_tpu.analysis.dumpgsd``: host code,
no device work; ``h5py`` is imported where a trajectory is opened.
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import NamedTuple

import numpy as np

from .common import invoke_main, remove_none
from .gsdio import GSDWriter, write_hoomd_frame

LOG = logging.getLogger()
DEFAULT_BOX = (100.0, 100.0, 100.0, 0.0, 0.0, 0.0)

#: stage name -> kind of pseudo-topology it carries
_STAGE_EXTRAS = {
    "anaphase": "one-pole",
    "telophase": None,
    "relaxation": "nucleolus",
    "interphase": "nucleolus",
    "prometaphase": "two-poles",
}


class Scene(NamedTuple):
    """Static per-stage visualization topology; only positions vary per frame."""

    extra_positions: np.ndarray  # (P, 3) pseudo-particle coordinates
    type_ids: np.ndarray  # (N + P,) uint32
    type_names: list[str]
    bond_pairs: np.ndarray  # (B, 2) uint32
    bond_type_ids: np.ndarray  # (B,) uint32
    bond_type_names: list[str]


def backbone_bonds(chain_ranges: np.ndarray) -> np.ndarray:
    """(i, i+1) bond rows for every chain's bead range, vectorized."""
    segments = [
        np.stack([np.arange(s, e - 1), np.arange(s + 1, e)], axis=1)
        for s, e in np.asarray(chain_ranges, np.int64)
    ]
    return (
        np.concatenate(segments) if segments else np.zeros((0, 2), np.int64)
    )


def stored_type_table(metadata) -> tuple[np.ndarray, list[str]]:
    """Bead type ids + names recovered from the HDF5 enum dtype."""
    import h5py

    enum = h5py.check_enum_dtype(metadata["particle_types"].dtype) or {}
    names = [name for name, _ in sorted(enum.items(), key=lambda kv: kv[1])]
    return np.asarray(metadata["particle_types"][:], np.uint32), names


def build_scene(stage: str, metadata, config: dict) -> Scene:
    if stage not in _STAGE_EXTRAS:
        raise ValueError(f"unknown stage: {stage}")
    extras = _STAGE_EXTRAS[stage]

    bead_types, type_names = stored_type_table(metadata)
    n_beads = len(bead_types)

    extra_positions = np.zeros((0, 3))
    pseudo_pairs = np.zeros((0, 2), np.int64)
    pseudo_bond_name = None

    if extras == "one-pole":
        # Single spindle pole; every kinetochore is pulled toward it.
        extra_positions = np.reshape(
            config["mitotic_phase"]["anaphase_spindle_shift"], (1, 3)
        ).astype(float)
        kinetochores = np.asarray(metadata["kinetochore_beads"][:], np.int64)
        pseudo_pairs = np.stack(
            [kinetochores, np.full(len(kinetochores), n_beads)], axis=1
        )
        pseudo_bond_name = "microtubule"
    elif extras == "two-poles":
        # Column k of sister_chromatids attaches to pole k.
        extra_positions = np.asarray(metadata["pole_positions"][:], float)
        kinetochores = np.asarray(metadata["kinetochore_beads"][:], np.int64)
        sisters = np.asarray(metadata["sister_chromatids"][:], np.int64)
        attach = kinetochores[sisters]  # (C, 2)
        poles = n_beads + np.arange(2, dtype=np.int64)
        pseudo_pairs = np.stack(
            [attach, np.broadcast_to(poles, attach.shape)], axis=2
        ).reshape(-1, 2)
        pseudo_bond_name = "microtubule"
    elif extras == "nucleolus":
        pseudo_pairs = np.asarray(metadata["nucleolar_bonds"][:], np.int64).reshape(
            -1, 2
        )
        pseudo_bond_name = "nucleolus"

    n_extra = len(extra_positions)
    if n_extra:
        pole_type = len(type_names)
        type_names = type_names + ["spindle_pole"]
        bead_types = np.concatenate(
            [bead_types, np.full(n_extra, pole_type, np.uint32)]
        )

    chrom_pairs = backbone_bonds(metadata["chain_ranges"][:])
    bond_type_names = ["chrom"]
    bond_type_ids = np.zeros(len(chrom_pairs), np.uint32)
    bond_pairs = chrom_pairs
    if pseudo_bond_name is not None:
        bond_type_names.append(pseudo_bond_name)
        bond_pairs = np.concatenate([chrom_pairs, pseudo_pairs])
        bond_type_ids = np.concatenate(
            [bond_type_ids, np.ones(len(pseudo_pairs), np.uint32)]
        )

    return Scene(
        extra_positions=extra_positions,
        type_ids=bead_types,
        type_names=type_names,
        bond_pairs=bond_pairs.astype(np.uint32),
        bond_type_ids=bond_type_ids,
        bond_type_names=bond_type_names,
    )


def dump_trajectory(stage_store, writer: GSDWriter, scene: Scene):
    for raw in stage_store[".steps"]:
        step = raw.decode() if isinstance(raw, bytes) else str(raw)
        positions = np.concatenate(
            [stage_store[step]["positions"][:], scene.extra_positions]
        )
        write_hoomd_frame(
            writer,
            step=int(step),
            box=DEFAULT_BOX,
            positions=positions,
            type_ids=scene.type_ids,
            type_names=scene.type_names,
            bond_pairs=scene.bond_pairs.reshape(-1, 2),
            bond_type_ids=scene.bond_type_ids,
            bond_type_names=scene.bond_type_names,
        )


def main(*, input_filename: str, output_filename: str, stage: str = "interphase"):
    import h5py

    with h5py.File(input_filename, "r") as store:
        if stage not in store["stages"]:
            raise ValueError(
                f"unknown stage {stage!r}; trajectory has: "
                + ", ".join(sorted(store["stages"]))
            )
        stage_store = store["stages"][stage]
        config = json.loads(store["metadata"]["config"][()])
        scene = build_scene(stage, stage_store["metadata"], config)
        with GSDWriter(output_filename) as writer:
            dump_trajectory(stage_store, writer, scene)
            LOG.info("Wrote %d frames", writer.nframes)


def parse_args() -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--stage", type=str)
    parser.add_argument("input_filename")
    parser.add_argument("output_filename")
    return remove_none(vars(parser.parse_args()))


if __name__ == "__main__":
    invoke_main(main, parse_args(), LOG)
