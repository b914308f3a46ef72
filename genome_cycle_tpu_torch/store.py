"""Trajectory store with the reference-exact schema: HDF5 file or memory.

One store per simulated cell cycle.  Schema ground truth (SURVEY.md §2.3;
reference ``src/simulation/common/simulation_store.{hpp,cpp}`` and
``stage_prepare/prepare.cpp``):

    /metadata/master_seed                     u32
    /metadata/config                          str   (JSON of resolved config)
    /metadata/config_source                   str   (raw input JSON)
    /metadata/chains_source                   str   (raw chains.tsv text)
    /stages/<stage>/metadata/seed             u32
    /stages/<stage>/metadata/particle_types   (N,)  i32 *enum dtype*
    /stages/interphase/metadata/ab_factors    (N,2) f32
    /stages/<stage>/metadata/chain_names      (C,)  str
    /stages/<stage>/metadata/chain_ranges     (C,2) i32
    /stages/interphase/metadata/nucleolar_bonds     (B,2) i32
    /stages/{anaphase,prometaphase}/metadata/kinetochore_beads (C,) i32
    /stages/prometaphase/metadata/sister_chromatids (C,2) i32
    /stages/prometaphase/metadata/pole_positions    (2,3) f32
    /stages/<stage>/.steps                    (F,)  str   frame index
    /stages/<stage>/<step>/positions          (N,3) f32   quantized, gzip 6
    /stages/<stage>/<step>/context            str   (JSON)
    /stages/interphase/<step>/contacts        (K,3) i32   gzip 4 + scaleoffset 0

Stage names: anaphase, telophase, relaxation, interphase, prometaphase.
Relaxation soft-links interphase metadata; telophase soft-links anaphase
metadata (prepare.cpp:435-444, 489-496).  Positions are mantissa-quantized to
16 fraction bits before storing (simulation_store.cpp:22-33,197-215).

Two backends share every typed view: :class:`SimulationStore` over an HDF5
file (``h5py`` is imported when a store is opened or prepared, not when this
module is imported) and :class:`MemoryStore` over a dict keyed by the same
paths, holding the same dtypes and the same quantized positions, for machines
without ``h5py``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from .config import SimulationConfig, format_config, parse_config
from .topology import (
    INTERPHASE_TYPES,
    MITOTIC_TYPES,
    ChainAssignment,
    ChainDefinitions,
    GenomeTopology,
    derive_stage_seeds,
)

POSITION_FRACTION_BITS = 16
POSITION_COMPRESSION = 6
CONTACT_COMPRESSION = 4


def quantize_f64(values: np.ndarray, bits: int) -> np.ndarray:
    """Mantissa quantization: value = mant * 2^exp with mant in [0.5, 1)
    becomes round(mant * 2^bits) * 2^(exp - bits)."""
    out = np.ascontiguousarray(values, dtype=np.float64)
    mant, exp = np.frexp(out)
    scaled = np.rint(np.ldexp(mant, bits))
    return np.ldexp(scaled, exp - bits)


def quantize_positions(values: np.ndarray, bits: int = POSITION_FRACTION_BITS) -> np.ndarray:
    """Zero low mantissa bits for compressibility (simulation_store.cpp:22-33);
    the binary analogue of HDF5's scaleoffset filter."""
    return quantize_f64(np.asarray(values, np.float64), bits)


@dataclasses.dataclass
class InterphaseContext:
    """Per-frame interphase context, stored as a JSON string per frame.

    Field order matches the jsoncons traits (simulation_store.cpp:36-45).
    ``wall_energy`` is serialized but never assigned by the reference drivers;
    we keep the field for schema parity.
    """

    time: float = 0.0
    wall_semiaxes: tuple[float, float, float] = (0.0, 0.0, 0.0)
    core_scale: float = 1.0
    bond_scale: float = 1.0
    mean_energy: float = 0.0
    wall_energy: float = 0.0

    def to_json(self) -> str:
        return json.dumps(
            {
                "time": self.time,
                "wall_semiaxes": list(self.wall_semiaxes),
                "core_scale": self.core_scale,
                "bond_scale": self.bond_scale,
                "mean_energy": self.mean_energy,
                "wall_energy": self.wall_energy,
            },
            separators=(",", ":"),
        )

    @classmethod
    def from_json(cls, text: str) -> "InterphaseContext":
        obj = json.loads(text)
        return cls(
            time=obj["time"],
            wall_semiaxes=tuple(obj["wall_semiaxes"]),
            core_scale=obj["core_scale"],
            bond_scale=obj["bond_scale"],
            mean_energy=obj["mean_energy"],
            wall_energy=obj.get("wall_energy", 0.0),
        )


@dataclasses.dataclass
class StageDesign:
    """Chains (+ per-stage extras) as loaded back from the store."""

    seed: int
    chains: list[ChainAssignment]
    ab_factors: Optional[np.ndarray] = None          # interphase only
    nucleolar_bonds: Optional[np.ndarray] = None     # interphase only
    sister_chromatids: Optional[np.ndarray] = None   # prometaphase only
    pole_positions: Optional[np.ndarray] = None      # prometaphase only

    @property
    def particle_count(self) -> int:
        n = max(c.end for c in self.chains)
        if self.nucleolar_bonds is not None and len(self.nucleolar_bonds):
            n = max(n, int(self.nucleolar_bonds[:, 1].max()) + 1)
        return n


class _StoreViews:
    """Typed read/write views shared by the HDF5 and the in-memory store.

    Mirrors the reference ``simulation_store`` class (simulation_store.hpp:65-111)
    with the same per-stage namespace convention: ``set_stage`` selects the
    ``/stages/<stage>/`` prefix for frame-level I/O.  A backend supplies the
    primitives ``_has``, ``_get``, ``_get_text``, ``_get_texts``, ``_put``,
    ``_put_text``, ``_put_texts``, ``_put_enum``, ``_get_enum``, ``_remove``,
    ``_names``, ``_link``, ``flush`` and ``close``.
    """

    _stage = ""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def set_stage(self, name: str):
        self._stage = name

    def _data_path(self, *keys) -> str:
        return "/stages/" + self._stage + "/" + "/".join(str(k) for k in keys)

    def _metadata_path(self, stage: str, key: str) -> str:
        return f"/stages/{stage}/metadata/{key}"

    # -- config & metadata ---------------------------------------------------

    def load_config(self) -> SimulationConfig:
        return parse_config(self._get_text("/metadata/config"))

    def load_master_seed(self) -> int:
        return int(self._get("/metadata/master_seed"))

    def load_chains_source(self) -> str:
        return self._get_text("/metadata/chains_source")

    def load_seed(self, stage: str) -> int:
        return int(self._get(self._metadata_path(stage, "seed")))

    def load_chain_assignments(self, stage: str) -> list[ChainAssignment]:
        names = self._get_texts(self._metadata_path(stage, "chain_names"))
        ranges = self._get(self._metadata_path(stage, "chain_ranges"))
        chains = [
            ChainAssignment(name=name, start=int(lo), end=int(hi))
            for name, (lo, hi) in zip(names, ranges)
        ]
        kpath = self._metadata_path(stage, "kinetochore_beads")
        if self._has(kpath):
            for chain, k in zip(chains, self._get(kpath)):
                # -1 marks "no kinetochore" (chain shorter than the
                # coarse-graining window); keep it None, not a real index.
                chain.kinetochore = int(k) if int(k) >= 0 else None
        return chains

    def load_anatelophase_design(self) -> StageDesign:
        # Anaphase and telophase share the same design (simulation_store.cpp:86-95).
        stage = "anaphase"
        return StageDesign(
            seed=self.load_seed(stage),
            chains=self.load_chain_assignments(stage),
        )

    def load_interphase_design(self) -> StageDesign:
        stage = "interphase"
        return StageDesign(
            seed=self.load_seed(stage),
            chains=self.load_chain_assignments(stage),
            ab_factors=self._get(self._metadata_path(stage, "ab_factors")).astype(
                np.float64
            ),
            nucleolar_bonds=self._get(
                self._metadata_path(stage, "nucleolar_bonds")
            ).astype(np.int64),
        )

    def load_prometaphase_design(self) -> StageDesign:
        stage = "prometaphase"
        return StageDesign(
            seed=self.load_seed(stage),
            chains=self.load_chain_assignments(stage),
            sister_chromatids=self._get(
                self._metadata_path(stage, "sister_chromatids")
            ).astype(np.int64),
            pole_positions=self._get(
                self._metadata_path(stage, "pole_positions")
            ).astype(np.float64),
        )

    def load_particle_types(self, stage: str) -> tuple[np.ndarray, dict[str, int]]:
        return self._get_enum(self._metadata_path(stage, "particle_types"))

    # -- frames --------------------------------------------------------------

    def _save_steps(self, steps):
        self._put_texts(self._data_path(".steps"), [str(int(s)) for s in steps])

    def clear_frames(self):
        if self._has(self._data_path(".steps")):
            self._save_steps([])

    def load_steps(self) -> list[int]:
        path = self._data_path(".steps")
        if not self._has(path):
            return []
        return [int(s) for s in self._get_texts(path)]

    def append_frame(self, step: int):
        # Stored as strings for schema parity (simulation_store.cpp:177-189,
        # including the upstream "FIXME: Why strings?").
        self._save_steps(self.load_steps() + [step])
        # Frame boundaries are durability points: without a flush a hard kill
        # loses every buffered write since open (HDF5 caches aggressively).
        self.flush()

    def append_frames(self, steps_to_add):
        """Batch variant of append_frame (one dataset rewrite for many frames)."""
        self._save_steps(self.load_steps() + list(steps_to_add))

    def truncate_frames(self, max_step: int):
        """Drop frame-index entries beyond max_step (checkpoint resume)."""
        self._save_steps([s for s in self.load_steps() if s <= max_step])
        self.flush()

    def check_positions(self, step: int) -> bool:
        return self._has(self._data_path(step, "positions"))

    def save_positions(self, step: int, positions: np.ndarray):
        data = quantize_positions(positions).astype(np.float32)
        self._put(
            self._data_path(step, "positions"),
            data,
            compression="gzip",
            compression_opts=POSITION_COMPRESSION,
            chunks=data.shape if data.size else None,
        )

    def load_positions(self, step: int) -> np.ndarray:
        return self._get(self._data_path(step, "positions")).astype(np.float64)

    def save_interphase_context(self, step: int, context: InterphaseContext):
        self._put_text(self._data_path(step, "context"), context.to_json())

    def load_interphase_context(self, step: int) -> InterphaseContext:
        return InterphaseContext.from_json(
            self._get_text(self._data_path(step, "context"))
        )

    # -- intra-stage checkpointing (new capability over the reference, whose
    # -- only checkpoint granularity is whole stages; SURVEY.md §5.3-5.4) ----

    def save_checkpoint(self, step: int, arrays: dict):
        """Persist a snapshot of the step state under <stage>/.checkpoint."""
        base = self._data_path(".checkpoint")
        self._put(base + "/step", np.int64(step))
        for name, value in arrays.items():
            self._put(base + "/" + name, np.asarray(value))
        self.flush()

    def load_checkpoint(self) -> Optional[dict]:
        base = self._data_path(".checkpoint")
        if not self._has(base + "/step"):
            return None
        out = {"step": int(self._get(base + "/step"))}
        for name in self._names(base):
            if name != "step":
                out[name] = self._get(base + "/" + name)
        return out

    def clear_checkpoint(self):
        self._remove(self._data_path(".checkpoint"))

    def save_contacts(self, step: int, contacts: np.ndarray):
        """Sorted COO (i, j, count) rows; no-op when empty
        (simulation_store.cpp:253-267)."""
        contacts = np.asarray(contacts, dtype=np.int32).reshape(-1, 3)
        if len(contacts) == 0:
            return
        self._put(
            self._data_path(step, "contacts"),
            contacts,
            compression="gzip",
            compression_opts=CONTACT_COMPRESSION,
            scaleoffset=0,
            chunks=contacts.shape,
        )

    def load_contacts(self, step: int) -> Optional[np.ndarray]:
        path = self._data_path(step, "contacts")
        if not self._has(path):
            return None
        return self._get(path)


def _decode(value) -> str:
    return value.decode() if isinstance(value, bytes) else str(value)


class SimulationStore(_StoreViews):
    """The typed views over one trajectory HDF5 file."""

    def __init__(self, filename: str, mode: str = "r+"):
        import h5py

        self._h5py = h5py
        self._str = h5py.string_dtype(encoding="utf-8")
        self._file = h5py.File(filename, mode)
        self._stage = ""

    def close(self):
        self._file.close()

    def flush(self):
        self._file.flush()

    @property
    def file(self):
        return self._file

    # Kept under its old name: callers plant raw datasets through it.
    def _write(self, path: str, data, **kwargs):
        if path in self._file:
            del self._file[path]
        self._file.create_dataset(path, data=data, **kwargs)

    _put = _write

    def _has(self, path: str) -> bool:
        return path in self._file

    def _get(self, path: str):
        return self._file[path][()]

    def _get_text(self, path: str) -> str:
        return _decode(self._file[path][()])

    def _get_texts(self, path: str) -> list[str]:
        return [_decode(s) for s in self._file[path][:]]

    def _put_text(self, path: str, text: str):
        self._write(path, text, dtype=self._str)

    def _put_texts(self, path: str, texts):
        self._write(path, np.asarray(list(texts), dtype=object), dtype=self._str)

    def _put_enum(self, path: str, values, mapping: dict):
        dtype = self._h5py.enum_dtype(mapping, basetype=np.int32)
        self._write(path, np.asarray(values, np.int32), dtype=dtype)

    def _get_enum(self, path: str):
        dset = self._file[path]
        enum = self._h5py.check_enum_dtype(dset.dtype) or {}
        return dset[:].astype(np.int32), dict(enum)

    def _remove(self, path: str):
        if path in self._file:
            del self._file[path]

    def _names(self, path: str) -> list[str]:
        return list(self._file[path])

    def _link(self, existing: str, new: str):
        """Soft link with intermediate group creation (stage_prepare/h5_misc.hpp:9-27)."""
        parent = new.rsplit("/", 1)[0]
        if parent and parent not in self._file:
            self._file.require_group(parent)
        self._file[new] = self._h5py.SoftLink(existing)


class MemoryStore(_StoreViews):
    """The same views over a dict keyed by the HDF5 paths.

    Holds what the file would hold — same paths, same dtypes, the same
    16-bit mantissa quantization of positions — without compression and
    without durability: ``flush`` and ``close`` do nothing.
    """

    def __init__(self):
        self._data: dict[str, object] = {}
        self._links: dict[str, str] = {}
        self._stage = ""

    def close(self):
        pass

    def flush(self):
        pass

    def _resolve(self, path: str) -> str:
        return self._links.get(path, path)

    def _has(self, path: str) -> bool:
        return self._resolve(path) in self._data

    def _get(self, path: str):
        value = self._data[self._resolve(path)]
        if isinstance(value, tuple):  # enum dataset: (values, mapping)
            value = value[0]
        return value.copy() if isinstance(value, np.ndarray) else value

    _get_text = _get

    def _get_texts(self, path: str) -> list[str]:
        return list(self._data[self._resolve(path)])

    def _put(self, path: str, data, **_filters):
        self._data[path] = np.array(data)

    def _put_text(self, path: str, text: str):
        self._data[path] = str(text)

    def _put_texts(self, path: str, texts):
        self._data[path] = [str(t) for t in texts]

    def _put_enum(self, path: str, values, mapping: dict):
        self._data[path] = (np.asarray(values, np.int32).copy(), dict(mapping))

    def _get_enum(self, path: str):
        values, mapping = self._data[self._resolve(path)]
        return values.copy(), dict(mapping)

    def _remove(self, path: str):
        prefix = path + "/"
        for key in [k for k in self._data if k == path or k.startswith(prefix)]:
            del self._data[key]

    def _names(self, path: str) -> list[str]:
        prefix = path + "/"
        return sorted(
            {k[len(prefix):].split("/", 1)[0] for k in self._data if k.startswith(prefix)}
        )

    def _link(self, existing: str, new: str):
        self._links[new] = existing


def prepare_store(
    target,
    config: SimulationConfig,
    chains: ChainDefinitions,
    topology: GenomeTopology,
    master_seed: int,
):
    """Fill a fresh store with all /metadata and /stages/*/metadata datasets,
    replicating the reference prepare pipeline's writes (prepare.cpp:373-562).

    ``target`` is the name of the HDF5 file to create, or an empty
    :class:`MemoryStore`, which is filled in place."""
    if isinstance(target, MemoryStore):
        _write_metadata(target, config, chains, topology, master_seed)
        return
    with SimulationStore(target, "w") as store:
        _write_metadata(store, config, chains, topology, master_seed)


def _write_metadata(store, config, chains, topology, master_seed):
    store._put("/metadata/master_seed", np.uint32(master_seed))
    store._put_text("/metadata/config", format_config(config))
    store._put_text("/metadata/config_source", config.source)
    store._put_text("/metadata/chains_source", chains.source)

    def write_chain_meta(prefix: str, assigns, enum, types):
        store._put_enum(f"{prefix}/particle_types", types, enum)
        store._put_texts(f"{prefix}/chain_names", [c.name for c in assigns])
        store._put(
            f"{prefix}/chain_ranges",
            np.asarray([[c.start, c.end] for c in assigns], dtype=np.int32),
        )

    def kinetochores(assigns):
        return np.asarray(
            [c.kinetochore if c.kinetochore is not None else -1 for c in assigns],
            dtype=np.int32,
        )

    # Interphase (+ relaxation via soft links).
    inter = topology.interphase
    iprefix = "/stages/interphase/metadata"
    write_chain_meta(iprefix, inter.chains, INTERPHASE_TYPES, inter.particle_types)
    store._put(f"{iprefix}/ab_factors", inter.ab_factors.astype(np.float32))
    store._put(
        f"{iprefix}/nucleolar_bonds",
        inter.nucleolar_bonds.astype(np.int32).reshape(-1, 2),
    )
    for key in (
        "particle_types",
        "ab_factors",
        "chain_names",
        "chain_ranges",
        "nucleolar_bonds",
    ):
        store._link(f"{iprefix}/{key}", f"/stages/relaxation/metadata/{key}")

    # Anatelophase (+ telophase via soft links).
    ana = topology.anatelophase
    aprefix = "/stages/anaphase/metadata"
    write_chain_meta(aprefix, ana.chains, MITOTIC_TYPES, ana.particle_types)
    store._put(f"{aprefix}/kinetochore_beads", kinetochores(ana.chains))
    for key in ("particle_types", "chain_names", "chain_ranges"):
        store._link(f"{aprefix}/{key}", f"/stages/telophase/metadata/{key}")

    # Prometaphase.
    pro = topology.prometaphase
    pprefix = "/stages/prometaphase/metadata"
    write_chain_meta(pprefix, pro.chains, MITOTIC_TYPES, pro.particle_types)
    store._put(f"{pprefix}/kinetochore_beads", kinetochores(pro.chains))
    store._put(f"{pprefix}/sister_chromatids", pro.sister_chromatids.astype(np.int32))
    store._put(f"{pprefix}/pole_positions", pro.pole_positions.astype(np.float32))

    # Stage seeds, derived exactly as std::seed_seq (prepare.cpp:549-562).
    seeds = derive_stage_seeds(master_seed)
    for stage, seed in seeds.items():
        store._put(f"/stages/{stage}/metadata/seed", np.uint32(seed))
