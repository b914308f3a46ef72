"""Contact search at a tick and the contact-window accumulator.

Counterpart of the JAX package's ``ops/contact.py`` (``events_to_host``,
``merge_window``, ``empty_window_acc``, ``merge_events_acc``) and of
``ops/block_pairs.py::block_contact_events``.

Reference semantics (contact_map.cpp:33-85): every
``contactmap_update_interval`` steps a fresh neighbour search at the current
contact distance counts each in-range pair once; the counts accumulate over an
output window and are dumped as COO rows sorted by the packed key
``i << 32 | j``.

The search walks the same cell layout as the pair-force kernel.  On the
card it is the hand-written kernel of ``csrc/contact_tick.cu``: every pair
found takes a row of a fixed event buffer through one counter, the
wrapper reads the counter (the tick's one host synchronisation) and, when the
buffer was too small, grows it and searches again (:func:`events_with_capacity`;
the buffer's size lives with the caller, :class:`EventCapacity`).  Its plain
version, :func:`contact_events_reference`, expands and filters the ragged
ranges in torch, so its event list has exactly as many rows as there are
pairs.  The window accumulator is a fixed buffer of sorted COO rows on the
device; a merge that needs more rows than it has reports by how many, and
the caller grows the buffer and merges again.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from . import _build
from ..utils import tracing
from .pair_kernels import CellLayout, _check_layout, expand_ranges, stencil_ranges

# Sentinel id for empty accumulator rows: sorts after every real bead id, so
# padding always sits at the tail.
_ACC_PAD = int(np.iinfo(np.int32).max)


def _check_cutoff(layout: CellLayout, cutoff: float):
    if cutoff > layout.cell * (1.0 + 1e-6):
        raise ValueError(
            f"contact cutoff {cutoff:g} exceeds the cell edge {layout.cell:g}: "
            "the one-cell stencil would lose pairs"
        )


def contact_events_reference(layout: CellLayout, cutoff: float, begin: int = 0,
                             end=None) -> torch.Tensor:
    """Plain version of :func:`contact_events`: the same pairs, in the order
    of the half stencil's ranges."""
    _check_cutoff(layout, cutoff)
    pos = layout.xyz[:, :3]
    cutoff2 = float(cutoff) * float(cutoff)
    rows = torch.arange(layout.n, device=pos.device)
    home = (rows >= begin) & ((rows < end) if end is not None else True)
    found = []
    for start, count in stencil_ranges(layout, half=True):
        for i, j in expand_ranges(start, torch.where(home, count, 0)):
            dx = pos[i] - pos[j]
            # Summed in this order, as the kernel sums it.
            r2 = (dx[:, 0] * dx[:, 0] + dx[:, 1] * dx[:, 1]) + dx[:, 2] * dx[:, 2]
            hit = (r2 < cutoff2) & (j > i)
            found.append(torch.stack([i[hit], j[hit]], dim=1))
    if not found:
        return torch.zeros((0, 3), dtype=torch.int32, device=pos.device)
    pairs = layout.order[torch.cat(found)]                    # original ids
    lo = torch.minimum(pairs[:, 0], pairs[:, 1])
    hi = torch.maximum(pairs[:, 0], pairs[:, 1])
    return torch.stack([lo, hi, torch.ones_like(lo)], dim=1).to(torch.int32)


class EventCapacity:
    """The rows of a tick's event buffer, kept by the caller (a model, a
    rank) from tick to tick.  ``rows`` None: 16 per row of the first layout
    searched.  A tick that finds more pairs than there are rows grows it to
    1.25 times the count, rounded up to a multiple of 4,096."""

    def __init__(self, rows: Optional[int] = None):
        self.rows = rows

    def grow(self, count: int):
        self.rows = int(math.ceil(count * 1.25 / 4096)) * 4096


def events_with_capacity(search, capacity: EventCapacity):
    """``search(rows) -> (buffer (rows, 3), count)`` run with the capacity's
    rows, and again with more rows as long as the count exceeds them (the
    search must be a pure function of its inputs: a rerun is exact).
    Returns the buffer's first ``count`` rows.  Each search run again counts
    ``contact.tick_reruns``."""
    while True:
        buffer, count = search(capacity.rows)
        if count <= capacity.rows:
            return buffer[:count]
        capacity.grow(count)
        tracing.count("contact.tick_reruns")


def _tick_entry_point():
    launch = _build.load_library("contact_tick").contact_tick_launch
    if not launch.argtypes:
        launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_uint] + [ctypes.c_void_p] * 3)
        launch.restype = ctypes.c_int
    return launch


def _tick_launch(layout: CellLayout, cutoff2: float, begin: int, end: int, buffer, count):
    """One launch of the tick kernel into ``buffer`` (rows, 3) int32; adds
    the pairs found to ``count`` (1,) int32, which must hold 0.  Allocates
    nothing and does not synchronise."""
    device = layout.xyz.device
    with torch.cuda.device(device):
        status = _tick_entry_point()(
            layout.xyz.data_ptr(), layout.cell_id.data_ptr(), layout.cell_start.data_ptr(),
            layout.order.data_ptr(), begin, end, *layout.shape, cutoff2, buffer.shape[0],
            buffer.data_ptr(), count.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"contact tick kernel launch failed: CUDA error {status}")
    tracing.count("launch.contact_tick")


def _tick_search(layout: CellLayout, cutoff2: float, begin: int, end: int, rows: int):
    """:func:`_tick_launch` into a fresh buffer of ``rows`` rows; returns the
    buffer and the count of pairs found (a host synchronisation)."""
    device = layout.xyz.device
    count = torch.zeros(1, dtype=torch.int32, device=device)
    buffer = torch.empty((rows, 3), dtype=torch.int32, device=device)
    _tick_launch(layout, cutoff2, begin, end, buffer, count)
    with tracing.sync("tick_count"):
        return buffer, int(count.item()) & 0xFFFFFFFF


def contact_events(layout: CellLayout, cutoff: float, begin: int = 0, end=None,
                   capacity: Optional[EventCapacity] = None) -> torch.Tensor:
    """Every pair i < j with r < cutoff exactly once, as (E, 3) int32 rows
    [i, j, 1] in original bead ids.

    The layout holds the positions the search runs on.  ``cutoff`` must not
    exceed the layout's cell edge (one-cell stencil).  Padded rows take part
    in no pair.  With a home range ``[begin, end)`` of the sorted order only
    the pairs whose lower sorted index lies in it are listed: ranks whose
    home ranges tile the sorted order list every pair once between them.

    A CUDA layout goes to the kernel of ``csrc/contact_tick.cu`` (rows in no
    fixed order; ``capacity`` is the caller's buffer size, grown when a tick
    overflows it, a fresh one when None), or the call raises; a CPU layout
    goes to the plain version :func:`contact_events_reference`.
    """
    if layout.xyz.device.type != "cuda":
        return contact_events_reference(layout, cutoff, begin, end)
    _check_cutoff(layout, cutoff)
    _check_layout(layout)
    capacity = capacity if capacity is not None else EventCapacity()
    if capacity.rows is None:
        capacity.rows = 16 * layout.n
    begin = max(int(begin), 0)
    end = layout.n if end is None else min(int(end), layout.n)
    cutoff2 = float(cutoff) * float(cutoff)
    return events_with_capacity(
        lambda rows: _tick_search(layout, cutoff2, begin, end, rows), capacity)


def merge_contact_events(keys: np.ndarray, weights: np.ndarray):
    """Sum weights of duplicate uint64 keys; returns (sorted unique keys,
    summed counts)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    weights = np.ascontiguousarray(weights, dtype=np.int64)
    uniq, inverse = np.unique(keys, return_inverse=True)
    sums = np.bincount(inverse, weights=weights.astype(np.float64))
    return uniq, np.rint(sums).astype(np.int64)


def events_to_host(events) -> tuple:
    """(E, 3) events -> (i, j, count) numpy arrays with i < j, in the shape
    :func:`merge_window` expects.  Rows with i < 0 are padding and dropped."""
    if isinstance(events, torch.Tensor):
        with tracing.sync("events_to_host"):
            ev = events.detach().cpu().numpy()
    else:
        ev = np.asarray(events)
    ev = ev.reshape(-1, 3)
    keep = ev[:, 0] >= 0
    a = ev[keep, 0].astype(np.int64)
    b = ev[keep, 1].astype(np.int64)
    return np.minimum(a, b), np.maximum(a, b), ev[keep, 2]


def merge_window(chunks) -> np.ndarray:
    """Merge per-chunk (i, j, count) triples into sorted COO (K, 3) int32.

    Sorted by the packed key (i << 32 | j), matching the reference dump order
    (contact_map.cpp:75-84).
    """
    if not chunks:
        return np.zeros((0, 3), dtype=np.int32)
    i = np.concatenate([c[0] for c in chunks])
    j = np.concatenate([c[1] for c in chunks])
    w = np.concatenate([c[2] for c in chunks])
    if len(i) == 0:
        return np.zeros((0, 3), dtype=np.int32)
    keys = (i.astype(np.uint64) << np.uint64(32)) | j.astype(np.uint64)
    uniq, sums = merge_contact_events(keys, w)
    out = np.empty((len(uniq), 3), dtype=np.int32)
    out[:, 0] = (uniq >> np.uint64(32)).astype(np.int32)
    out[:, 1] = (uniq & np.uint64(0xFFFFFFFF)).astype(np.int32)
    out[:, 2] = sums.astype(np.int32)
    return out


def split_window(coo: np.ndarray, n: int, replicas: int) -> list:
    """The window COO of R replicas of N beads (ids ``r * N + i``, rows
    sorted by the packed key) as R windows in their own ids.

    A row never joins two replicas, so the rows of replica r are the run with
    ``r * N <= i < (r + 1) * N``; less ``r * N`` on both ids, they keep the
    order of the packed key, and each is what :func:`merge_window` gives for
    that replica's events alone.
    """
    coo = np.asarray(coo, dtype=np.int32).reshape(-1, 3)
    cuts = np.searchsorted(coo[:, 0], np.arange(replicas + 1) * n)
    windows = []
    for r in range(replicas):
        rows = coo[cuts[r]:cuts[r + 1]]
        # Replica 0's ids need no shift: its window is a view, not a copy
        # (for one replica, the whole window).
        windows.append(rows - np.int32([r * n, r * n, 0]) if r else rows)
    return windows


def empty_window_acc(capacity: int, device="cpu"):
    """Fresh window accumulator on ``device``: (capacity, 3) int32 rows of
    [i, j, count] with the pad sentinel, plus the row count 0."""
    acc = torch.full((int(capacity), 3), _ACC_PAD, dtype=torch.int32, device=device)
    acc[:, 2] = 0
    return acc, 0


def merge_events_acc(acc, acc_n: int, events):
    """Fold tick events into the sorted-COO window accumulator.

    Live accumulator rows and events (canonicalised to i < j; rows with
    i < 0 are padding) are keyed by the int64 ``i << 32 | j``, sorted, and
    equal keys are summed run by run — the same rows in the same order as
    :func:`merge_window` gives on the host.

    Returns ``(acc', n', overflow)`` with Python ints; ``overflow > 0`` means
    that many unique pairs more than the accumulator has rows: the result is
    truncated, and the caller must grow the accumulator and merge again (the
    inputs are never mutated, so a retry is safe).
    """
    cap = acc.shape[0]
    ev = events.reshape(-1, 3).to(torch.int64)
    with tracing.sync("merge_pad"):
        ev = ev[ev[:, 0] >= 0]
    lo = torch.minimum(ev[:, 0], ev[:, 1])
    hi = torch.maximum(ev[:, 0], ev[:, 1])
    live = acc[:acc_n].to(torch.int64)
    keys = torch.cat([(live[:, 0] << 32) | live[:, 1], (lo << 32) | hi])
    counts = torch.cat([live[:, 2], ev[:, 2]])

    keys, perm = torch.sort(keys)
    with tracing.sync("merge_unique"):
        uniq, inverse = torch.unique_consecutive(keys, return_inverse=True)
    sums = torch.zeros_like(uniq).index_add_(0, inverse, counts[perm])

    n_unique = int(uniq.shape[0])
    keep = min(n_unique, cap)
    out, _ = empty_window_acc(cap, acc.device)
    out[:keep, 0] = (uniq[:keep] >> 32).to(torch.int32)
    out[:keep, 1] = (uniq[:keep] & 0xFFFFFFFF).to(torch.int32)
    out[:keep, 2] = sums[:keep].to(torch.int32)
    return out, keep, max(n_unique - cap, 0)
