"""Minimal GSD (General Simulation Data) v1 writer/reader, HOOMD schema.

The reference's dumpgsd.py depends on the `gsd` package (absent in this
environment), so this module implements the documented GSD v1 file layout
directly (https://gsd.readthedocs.io — file format specification):

    header (256 B): magic 0x65DF65DF65DF65DF, index/namelist locations and
    sizes, schema_version, gsd_version, application[64], schema[64]
    index: 32-byte entries (frame u64, N u64, location i64, M u32, id u16,
    type u8, flags u8), sorted by (frame, id), zero-location = end
    namelist: 64-byte zero-padded chunk names

Data chunks written per frame follow the HOOMD schema subset that OVITO and
gsd.hoomd consume: configuration/step+box, particles/{N,position,typeid,
types}, bonds/{N,group,typeid,types}.  A reader is included for round-trip
verification.

The port's copy of ``genome_cycle_tpu.analysis.gsdio``; it writes the same
bytes, the application name included.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

MAGIC = 0x65DF65DF65DF65DF
GSD_VERSION = (1 << 16) | 0  # v1.0 layout

_TYPE_CODES = {
    np.dtype(np.uint8): 1,
    np.dtype(np.uint16): 2,
    np.dtype(np.uint32): 3,
    np.dtype(np.uint64): 4,
    np.dtype(np.int8): 5,
    np.dtype(np.int16): 6,
    np.dtype(np.int32): 7,
    np.dtype(np.int64): 8,
    np.dtype(np.float32): 9,
    np.dtype(np.float64): 10,
}
_CODE_DTYPES = {v: k for k, v in _TYPE_CODES.items()}

_HEADER = struct.Struct("<QQQQQII64s64s80s")
_INDEX_ENTRY = struct.Struct("<QQqIHBB")


class GSDWriter:
    """Streaming single-pass GSD writer: data first, index+namelist at close."""

    def __init__(self, path: str, application="genome_cycle_tpu", schema="hoomd",
                 schema_version=(1, 0)):
        self._file = open(path, "wb")
        self._file.write(b"\0" * _HEADER.size)
        self._application = application
        self._schema = schema
        self._schema_version = (schema_version[0] << 16) | schema_version[1]
        self._names: list[str] = []
        self._name_ids: dict[str, int] = {}
        self._index: list[tuple] = []
        self._frame = 0

    def write_chunk(self, name: str, data):
        data = np.ascontiguousarray(data)
        if data.dtype not in _TYPE_CODES:
            raise TypeError(f"unsupported dtype {data.dtype} for chunk {name}")
        if data.ndim == 0:
            data = data.reshape(1)
        if data.ndim == 1:
            n, m = len(data), 1
        elif data.ndim == 2:
            n, m = data.shape
        else:
            raise ValueError("GSD chunks are at most 2-D")
        if name not in self._name_ids:
            if len(name) > 63:
                raise ValueError("chunk name too long")
            self._name_ids[name] = len(self._names)
            self._names.append(name)
        location = self._file.tell()
        self._file.write(data.tobytes())
        self._index.append(
            (
                self._frame,
                n,
                location,
                m,
                self._name_ids[name],
                _TYPE_CODES[data.dtype],
            )
        )

    def end_frame(self):
        self._frame += 1

    @property
    def nframes(self) -> int:
        return self._frame

    def close(self):
        index_location = self._file.tell()
        entries = sorted(self._index, key=lambda e: (e[0], e[4]))
        for frame, n, location, m, name_id, code in entries:
            self._file.write(
                _INDEX_ENTRY.pack(frame, n, location, m, name_id, code, 0)
            )
        namelist_location = self._file.tell()
        for name in self._names:
            self._file.write(name.encode().ljust(64, b"\0"))

        self._file.seek(0)
        self._file.write(
            _HEADER.pack(
                MAGIC,
                index_location,
                len(entries),
                namelist_location,
                len(self._names),
                self._schema_version,
                GSD_VERSION,
                self._application.encode()[:63].ljust(64, b"\0"),
                self._schema.encode()[:63].ljust(64, b"\0"),
                b"\0" * 80,
            )
        )
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class GSDReader:
    def __init__(self, path: str):
        self._file = open(path, "rb")
        header = _HEADER.unpack(self._file.read(_HEADER.size))
        (magic, index_loc, index_n, name_loc, name_n,
         self.schema_version, self.gsd_version, app, schema, _) = header
        if magic != MAGIC:
            raise ValueError("not a GSD file")
        self.application = app.rstrip(b"\0").decode()
        self.schema = schema.rstrip(b"\0").decode()

        self._file.seek(name_loc)
        self._names = [
            self._file.read(64).rstrip(b"\0").decode() for _ in range(name_n)
        ]
        self._file.seek(index_loc)
        self._entries = []
        for _ in range(index_n):
            frame, n, location, m, name_id, code, _flags = _INDEX_ENTRY.unpack(
                self._file.read(_INDEX_ENTRY.size)
            )
            if location == 0:
                break
            self._entries.append((frame, n, location, m, name_id, code))
        self.nframes = (self._entries[-1][0] + 1) if self._entries else 0

    def chunk(self, frame: int, name: str) -> Optional[np.ndarray]:
        try:
            name_id = self._names.index(name)
        except ValueError:
            return None
        for f, n, location, m, nid, code in self._entries:
            if f == frame and nid == name_id:
                dtype = _CODE_DTYPES[code]
                self._file.seek(location)
                data = np.frombuffer(
                    self._file.read(n * m * dtype.itemsize), dtype=dtype
                )
                return data.reshape(n, m) if m > 1 else data
        return None

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def encode_type_names(names: list[str]) -> np.ndarray:
    """HOOMD-style type-name encoding: (T, max_len+1) int8 zero-padded."""
    width = max((len(n) for n in names), default=0) + 1
    out = np.zeros((len(names), width), dtype=np.int8)
    for i, name in enumerate(names):
        raw = name.encode()
        out[i, : len(raw)] = np.frombuffer(raw, dtype=np.int8)
    return out


def decode_type_names(data: np.ndarray) -> list[str]:
    return [
        bytes(row.astype(np.uint8)).rstrip(b"\0").decode()
        for row in np.atleast_2d(data)
    ]


def write_hoomd_frame(
    writer: GSDWriter,
    *,
    step: int,
    box: tuple,
    positions: np.ndarray,
    type_ids: np.ndarray,
    type_names: list[str],
    bond_pairs: np.ndarray,
    bond_type_ids: np.ndarray,
    bond_type_names: list[str],
):
    writer.write_chunk("configuration/step", np.asarray([step], np.uint64))
    writer.write_chunk("configuration/box", np.asarray(box, np.float32))
    writer.write_chunk("particles/N", np.asarray([len(positions)], np.uint32))
    writer.write_chunk("particles/position", positions.astype(np.float32))
    writer.write_chunk("particles/typeid", np.asarray(type_ids, np.uint32))
    writer.write_chunk("particles/types", encode_type_names(type_names))
    writer.write_chunk("bonds/N", np.asarray([len(bond_pairs)], np.uint32))
    writer.write_chunk(
        "bonds/group", np.asarray(bond_pairs, np.uint32).reshape(-1, 2)
    )
    writer.write_chunk("bonds/typeid", np.asarray(bond_type_ids, np.uint32))
    writer.write_chunk("bonds/types", encode_type_names(bond_type_names))
    writer.end_frame()
