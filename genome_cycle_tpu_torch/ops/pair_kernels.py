"""The A/B copolymer pair force: cell layout, CUDA kernel wrapper, plain version.

Counterpart of the JAX package's ``ops/pallas_kernels.py``.  The function is
the reference's per-pair mixed softcore
(stage_interphase/simulation_driver_forcefield.cpp:30-52):
F_i = sum_j c(r2) (x_i - x_j) with c = a_mix * c_softcore<2,3> + b_mix *
c_softcore<8,3>, a_mix = (a_i + a_j)/2, b_mix = (b_i + b_j)/2, diameters
scaled by the core scale, summed over the 27 neighbour cells of i.

Three parts:

- :func:`build_cell_layout` — the layout: beads sorted by flat cell id, a
  cell being the range ``[cell_start[c], cell_start[c+1])`` of that order.
  No per-cell capacity, so nothing overflows.  R replicas of one topology
  share one layout, cubes side by side along x, and so one launch of the
  kernel.  Rows of a padded buffer (a rank's own beads and halo bands,
  ``parallel/halo.py``) take no cell: they sort after every bead.  On a CUDA
  tensor it launches the hand-written ``csrc/cell_layout.cu`` (a stable
  counting sort with the cells as its buckets, four kernels from one host
  call) or raises; on a CPU tensor it
  takes the plain version :func:`build_cell_layout_reference`, which the
  card's tests hold the kernel to, bit for bit.
- :func:`ab_pair_forces` — the wrapper.  On a CUDA layout it launches the
  hand-written kernel ``csrc/ab_pair_forces.cu`` or raises; on a CPU layout it
  takes the plain version.  Neither wrapper falls back on the card.
- :func:`ab_pair_forces_reference` — the plain version, walking the same
  layout with ragged range expansion; the CPU tests and the on-card comparison
  use it.  ``ops.neighbor.pairwise_forces_dense`` is the layout-free oracle.

:func:`ab_pair_forces_rows` is the kernel with its four scalars read on the
card from a :class:`StepScalars` row, the form a CUDA graph of the G1 step
replays (``models/g1_graph.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import _build
from ..utils import tracing


# Floats a row of the per-step table (the sources' kStepRow): the pair
# kernel's e_a, 1/d_a^2, e_b, 1/d_b^2 in the first four, the rest kernel's
# s^2, s and the wall's e_a, 1/d_a^2, e_b, 1/d_b^2 in the next six.
STEP_ROW = 16


class StepScalars(NamedTuple):
    """The scalars of a run of G1 steps on the card, for launches that a
    CUDA graph replays step after step: the kernels read row ``index[0]`` of
    ``rows``, and the rest kernel of the step advances ``index`` by one."""

    index: torch.Tensor    # (1,) int32
    rows: torch.Tensor     # (K, STEP_ROW) float32


class CellLayout(NamedTuple):
    """Beads in cell-sorted order over a grid of ``shape`` cells (z runs
    fastest).

    One system fills a cube of ``dims`` cells per axis.  R replicas lie side
    by side along x, replica r in the cube of cells whose x index runs from
    ``r * (dims + 1)``, so that a column of empty cells separates neighbouring
    replicas: no stencil reaches from one into the next.  A bead's id is then
    ``r * N + i`` for bead i of replica r, and every replica's beads keep
    their relative order in the sorted order.
    """

    cell: float                # cell edge; each replica's cube starts at -bound on every axis
    dims: int                  # cells per axis of one replica's cube
    order: torch.Tensor        # (R N,) int64: sorted index -> bead id
    cell_id: torch.Tensor      # (R N,) int32 flat cell id, ascending
    cell_start: torch.Tensor   # (cells + 1,) int32 range starts
    xyz: torch.Tensor          # (R N, 4) f32 x, y, z, 0 in sorted order
    ab: torch.Tensor           # (R N, 2) f32 a, b factors in sorted order
    replicas: int = 1          # R
    # Whether rows were left out (``valid``): they carry the cell id
    # ``num_cells``, sort last and lie in no range; ``cell_start[num_cells]``
    # is the count of the rows that take part.
    padded: bool = False

    @property
    def n(self) -> int:
        return self.order.shape[0]

    @property
    def shape(self) -> tuple:
        """Cells along x, y and z."""
        return (self.replicas * (self.dims + 1) - 1, self.dims, self.dims)

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz


def grid_dims(bound: float, cell: float) -> int:
    """Cells per axis of the cubic grid over [-bound, bound]."""
    return max(int(math.ceil(2.0 * bound / cell)), 1)


@tracing.traced("layout")
def build_cell_layout(positions, af, bf, bound: float, cell: float, valid=None) -> CellLayout:
    """Sort beads into the cells of the cubic grid over [-bound, bound]^3.

    ``positions`` is (N, 3), or (R, N, 3) for R replicas of one topology
    (``af``, ``bf`` of length N), which get a cube each, side by side along x
    (see :class:`CellLayout`).  Beads outside the grid are clipped into the
    edge cells of their own replica's cube; clipping is monotone per axis, so
    two beads closer than one cell still land in the same or in neighbouring
    cells and keep interacting.  No host synchronisation.

    ``valid`` (bool, of the positions' leading shape) marks the rows that
    take part; the others are padding.  A padded row gets the cell id
    ``num_cells``, one past the last cell, so it sorts after every bead and
    lies in no ``cell_start`` range: it meets no bead and no other padded
    row, whatever its coordinates.  (Clipping it into the grid instead would
    put every padded row in one edge cell, at r = 0 from each other.)

    On a CUDA tensor the kernels of ``csrc/cell_layout.cu`` build it, launched
    on the current stream from one host call; anything that keeps them from
    launching raises.  On a CPU tensor :func:`build_cell_layout_reference`
    builds it.  Both give the same layout to the bit on the card.
    """
    if positions.device.type != "cuda":
        return build_cell_layout_reference(positions, af, bf, bound, cell, valid)
    dims = grid_dims(bound, cell)
    x = _float32(positions)
    replicas = x.shape[0] if x.dim() == 3 else 1
    nx = _check_grid(replicas, dims)
    cells = nx * dims * dims
    per_replica = x.shape[-2]
    rows = replicas * per_replica
    device = x.device
    af, bf = _float32(af), _float32(bf)
    if af.device != device or bf.device != device:
        raise ValueError(f"af and bf must lie on {device}")
    if tuple(af.shape) != (per_replica,) or tuple(bf.shape) != (per_replica,):
        raise ValueError(f"af and bf must hold {per_replica} factors, one a bead of a replica")
    if valid is not None:
        valid = valid.to(device=device, dtype=torch.bool).reshape(-1).contiguous()
        if valid.shape[0] != rows:
            raise ValueError(f"valid has {valid.shape[0]} rows, the positions {rows}")
    index = device.index
    # The stream's handle as PyTorch's own generated code reads it: a
    # torch.cuda.Stream object costs 8 us of host a call on the H100's host.
    stream = torch._C._cuda_getCurrentRawStream(index)
    launch, scratch_bytes = _layout_entry_point(rows, cells)
    scratch = _scratch_for(device, stream, scratch_bytes)
    order = torch.empty(rows, dtype=torch.int64, device=device)
    cell_id = torch.empty(rows, dtype=torch.int32, device=device)
    cell_start = torch.empty(cells + 1, dtype=torch.int32, device=device)
    xyz = torch.empty((rows, 4), dtype=torch.float32, device=device)
    ab = torch.empty((rows, 2), dtype=torch.float32, device=device)
    args = (x.data_ptr(), None if valid is None else valid.data_ptr(), af.data_ptr(),
            bf.data_ptr(), rows, per_replica, dims, nx, -float(bound), _reciprocal(cell),
            scratch.data_ptr(), scratch_bytes, order.data_ptr(), cell_id.data_ptr(),
            cell_start.data_ptr(), xyz.data_ptr(), ab.data_ptr(), stream)
    if torch.cuda.current_device() == index:     # the guard costs 6 us of host
        status = launch(*args)
    else:
        with torch.cuda.device(device):
            status = launch(*args)
    if status != 0:
        raise RuntimeError(f"cell layout kernel launch failed: CUDA error {status}")
    tracing.count("launch.cell_layout")
    return CellLayout(
        cell=float(cell), dims=dims, order=order, cell_id=cell_id, cell_start=cell_start,
        xyz=xyz, ab=ab, replicas=replicas, padded=valid is not None,
    )


def _check_grid(replicas: int, dims: int) -> int:
    """Cells along x of R cubes of ``dims`` cells; raises where the grid's
    cell ids (and the padded rows' one past them) do not fit 32 bits."""
    nx = replicas * (dims + 1) - 1
    if nx * dims * dims >= 2 ** 31 - 1:
        raise ValueError(f"grid of {nx} x {dims}^2 cells does not fit 32-bit cell ids")
    return nx


def _float32(tensor):
    """``tensor`` as contiguous float32, itself where it is one already."""
    if tensor.dtype == torch.float32 and tensor.is_contiguous():
        return tensor
    return tensor.to(torch.float32).contiguous()


@functools.lru_cache(maxsize=64)
def _reciprocal(cell: float) -> float:
    """1 / cell in float32, as PyTorch forms ``t / cell`` on a CUDA tensor:
    the product with the host scalar's float32 reciprocal."""
    return float(np.float32(1.0) / np.float32(cell))


_layout_lib = None
_scratch_sizes: dict = {}
# The layout's scratch for each card and stream, grown when short.  Layouts
# on one stream run one after the other, so they never share it at once.
_scratch: dict = {}


def _layout_entry_point(rows: int, cells: int):
    """(launch function, scratch bytes) of ``csrc/cell_layout.cu`` for
    ``rows`` rows over ``cells`` cells."""
    global _layout_lib
    if _layout_lib is None:
        lib = _build.load_library("cell_layout")
        # Pointers and the stream as c_void_p: without argtypes ctypes
        # passes a Python int as a 32-bit int and cuts the pointer.
        lib.cell_layout_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.cell_layout_scratch_bytes.restype = ctypes.c_ulonglong
        lib.cell_layout_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
            + [ctypes.c_void_p, ctypes.c_ulonglong] + [ctypes.c_void_p] * 6)
        lib.cell_layout_launch.restype = ctypes.c_int
        _layout_lib = lib
    key = (rows, cells)
    if key not in _scratch_sizes:
        _scratch_sizes[key] = _layout_lib.cell_layout_scratch_bytes(rows, cells)
    return _layout_lib.cell_layout_launch, _scratch_sizes[key]


def _scratch_for(device, stream: int, nbytes: int):
    key = (device.index, stream)
    held = _scratch.get(key)
    if held is None or held.shape[0] < nbytes:
        held = torch.empty(nbytes, dtype=torch.uint8, device=device)
        _scratch[key] = held
    return held


def release_scratch(device, stream: int):
    """Take the layout's scratch of a card and stream out of the cache and
    return it (None if there is none): a CUDA graph captured on that stream
    keeps it for its replays."""
    return _scratch.pop((torch.device(device).index, stream), None)


def build_cell_layout_reference(positions, af, bf, bound: float, cell: float,
                                valid=None) -> CellLayout:
    """Plain torch version of :func:`build_cell_layout`, on either device:
    the CPU's layout, and the card's yardstick for the kernels."""
    dims = grid_dims(bound, cell)
    x = positions.to(torch.float32)
    replicas = x.shape[0] if x.dim() == 3 else 1
    nx = _check_grid(replicas, dims)
    lower = -float(bound)
    coords = torch.floor((x - lower) / cell).to(torch.int64).clamp_(0, dims - 1)
    if x.dim() == 3:
        # Clipped into its own cube first, then moved to it.
        offsets = (dims + 1) * torch.arange(replicas, device=x.device)
        coords[..., 0] += offsets[:, None]
        coords, x = coords.reshape(-1, 3), x.reshape(-1, 3)
    flat = (coords[:, 0] * dims + coords[:, 1]) * dims + coords[:, 2]
    if valid is not None:
        flat = torch.where(valid.reshape(-1), flat, nx * dims * dims)
    sorted_flat, order = torch.sort(flat, stable=True)
    edges = torch.arange(nx * dims * dims + 1, device=x.device, dtype=torch.int64)
    cell_start = torch.searchsorted(sorted_flat, edges).to(torch.int32)
    xyz = torch.zeros((x.shape[0], 4), dtype=torch.float32, device=x.device)
    xyz[:, :3] = x[order]
    bead = order if replicas == 1 else order % af.shape[0]
    ab = torch.stack([af[bead], bf[bead]], dim=1).to(torch.float32).contiguous()
    return CellLayout(
        cell=float(cell), dims=dims, order=order,
        cell_id=sorted_flat.to(torch.int32), cell_start=cell_start,
        xyz=xyz, ab=ab, replicas=replicas, padded=valid is not None,
    )


def stencil_ranges(layout: CellLayout, half: bool = False):
    """The 27-cell stencil of every sorted bead as contiguous index ranges.

    The three z-neighbours of a cell column are contiguous in the flat id, so
    the stencil is 9 ranges.  Yields ``(start, count)`` int64 tensors of
    length N, the count 0 where a column lies outside the grid.  With
    ``half`` only the ranges whose cells have a flat id not below the bead's
    own are yielded (5 ranges): every unordered pair then appears from its
    lower sorted index only, given the filter ``j > i`` on the own column.
    A padded row has no stencil: its counts are 0.
    """
    nx, ny, nz = layout.shape
    c = layout.cell_id.to(torch.int64)
    real = c < nx * ny * nz
    cz = c % nz
    cy = (c // nz) % ny
    cx = c // (nz * ny)
    starts = layout.cell_start.to(torch.int64)
    z_hi = torch.clamp(cz + 1, max=nz - 1)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            if half and (ox, oy) < (0, 0):
                continue
            z_lo = cz if half and (ox, oy) == (0, 0) else torch.clamp(cz - 1, min=0)
            x, y = cx + ox, cy + oy
            inside = real & (x >= 0) & (x < nx) & (y >= 0) & (y < ny)
            column = (x.clamp(0, nx - 1) * ny + y.clamp(0, ny - 1)) * nz
            start = starts[column + z_lo]
            count = starts[column + z_hi + 1] - start
            yield start, torch.where(inside, count, torch.zeros_like(count))


def expand_ranges(start, count, max_pairs: int = 1 << 23):
    """Ragged expansion of per-bead ranges into candidate pairs.

    Yields ``(i, j)`` int64 index tensors, bead blocks at a time so that one
    piece holds about ``max_pairs`` candidates at most.  Sizes its outputs on
    the host (one synchronisation per call).
    """
    n = start.shape[0]
    ends = torch.cumsum(count, 0)
    total = int(ends[-1]) if n else 0
    if total == 0:
        return
    pieces = max(1, -(-total // max_pairs))
    # Block edges at equal shares of the candidate count.
    targets = torch.arange(1, pieces, device=start.device) * (total // pieces)
    cuts = [0, *torch.searchsorted(ends, targets, right=True).tolist(), n]
    rows_all = torch.arange(n, device=start.device)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        if hi <= lo:
            continue
        cnt = count[lo:hi]
        size = int(ends[hi - 1] - (ends[lo - 1] if lo else 0))
        if size == 0:
            continue
        i = torch.repeat_interleave(rows_all[lo:hi], cnt, output_size=size)
        first = torch.cumsum(cnt, 0) - cnt          # offset of each bead's run
        within = torch.arange(size, device=start.device) - first.index_select(0, i - lo)
        yield i, start.index_select(0, i) + within


def _check_params(layout: CellLayout, params: Sequence[float]):
    e_a, inv_da2, e_b, inv_db2 = (float(v) for v in params)
    reach = 1.0 / math.sqrt(min(inv_da2, inv_db2))
    if reach > layout.cell * (1.0 + 1e-6):
        raise ValueError(
            f"largest core diameter {reach:g} exceeds the cell edge "
            f"{layout.cell:g}: the one-cell stencil would lose pairs"
        )
    return e_a, inv_da2, e_b, inv_db2


def in_reach(r2, inv_da2: float, inv_db2: float):
    """Whether a pair at squared distance ``r2`` lies inside the larger core
    diameter.  Beyond it both softcore terms are exactly zero: with the
    smaller 1/d^2 the rounded quotient r2/d^2 is the smaller of the two, so
    where it is not below 1 neither core ``1 - s`` is positive.  The CUDA
    kernel skips pairs by this very test; its cores are fused multiply-adds,
    so within one rounding of the diameter it can drop a core of about 1e-7
    that it would otherwise have kept."""
    return r2 * min(inv_da2, inv_db2) < 1.0


def ab_pair_forces_reference(layout: CellLayout, params, with_energy: bool = False,
                             begin: int = 0, end=None, per_bead: bool = False):
    """Plain torch version of :func:`ab_pair_forces` over the same layout.

    ``params`` = [e_a, 1/d_a^2, e_b, 1/d_b^2] (diameters pre-scaled).  Returns
    (forces (N, 3) in original bead order, energy scalar tensor, or (N,)
    per-bead energies with ``per_bead``).  Only the rows of the home range
    ``[begin, end)`` of the sorted order get their force and energy; every
    other row, padding included, gets zeros.
    """
    e_a, inv_da2, e_b, inv_db2 = _check_params(layout, params)
    with_energy = with_energy or per_bead
    pos = layout.xyz[:, :3]
    a, b = layout.ab[:, 0], layout.ab[:, 1]
    forces_sorted = torch.zeros_like(pos)
    energy_sorted = pos.new_zeros(pos.shape[0])  # as the kernel: a bead's half of each pair
    # Shaped for small systems on a CPU, where a call costs its count of
    # tensor operations: the half stencil's ranges of all beads as one ragged
    # list, every unordered pair once (both beads get their share), and the
    # arithmetic only for the pairs in reach (every other term is exactly
    # zero, see `in_reach`).  Then the rows outside the home range are
    # cleared (padded rows take part in no pair: theirs are 0 already).
    n = pos.shape[0]
    ranges = list(stencil_ranges(layout, half=True))
    starts = torch.cat([start for start, _ in ranges])
    counts = torch.cat([count for _, count in ranges])
    for row, j in expand_ranges(starts, counts):
        i = row % n
        dx = pos.index_select(0, i) - pos.index_select(0, j)
        r2 = torch.sum(dx * dx, dim=-1)
        keep = torch.nonzero(in_reach(r2, inv_da2, inv_db2) & (j > i)).squeeze(1)
        i, j, dx, r2 = (t.index_select(0, keep) for t in (i, j, dx, r2))
        a_mix = 0.5 * (a[i] + a[j])
        b_mix = 0.5 * (b[i] + b[j])
        core_a = torch.clamp(1.0 - r2 * inv_da2, min=0.0)
        s_b = r2 * inv_db2
        core_b = torch.clamp(1.0 - s_b ** 4, min=0.0)
        coeff = (
            a_mix * (6.0 * e_a * inv_da2) * core_a ** 2
            + b_mix * (24.0 * e_b * inv_db2) * s_b ** 3 * core_b ** 2
        )
        f = coeff[:, None] * dx
        forces_sorted.index_add_(0, i, f)
        forces_sorted.index_add_(0, j, f, alpha=-1)
        if with_energy:
            u = 0.5 * (a_mix * e_a * core_a ** 3 + b_mix * e_b * core_b ** 3)
            energy_sorted.index_add_(0, i, u)
            energy_sorted.index_add_(0, j, u)
    for outside in (slice(0, max(int(begin), 0)), slice(n if end is None else int(end), n)):
        forces_sorted[outside] = 0.0
        energy_sorted[outside] = 0.0
    forces = torch.empty_like(forces_sorted)
    forces[layout.order] = forces_sorted
    if per_bead:
        energy = torch.empty_like(energy_sorted)
        energy[layout.order] = energy_sorted
        return forces, energy
    return forces, energy_sorted.sum()


def _entry_points():
    """The C launch functions of ``csrc/ab_pair_forces.cu``: the kernel with
    its scalars by value and with them read on the card."""
    lib = _build.load_library("ab_pair_forces")
    cells, rows = lib.ab_pair_forces_launch, lib.ab_pair_forces_rows_launch
    if not cells.argtypes:
        # Every pointer and the stream as c_void_p: without argtypes ctypes
        # passes a Python int as a 32-bit int and cuts the pointer.
        cells.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] * 4
                          + [ctypes.c_void_p] * 3)
        rows.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
        cells.restype = rows.restype = ctypes.c_int
    return cells, rows


def _check_tensor(name, tensor, dtype, shape, device, align):
    if tensor.device != device:
        raise ValueError(f"{name} lies on {tensor.device}, expected {device}")
    if tensor.dtype != dtype:
        raise TypeError(f"{name} has dtype {tensor.dtype}, expected {dtype}")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(tensor.shape)}, expected {tuple(shape)}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if tensor.data_ptr() % align:
        raise ValueError(f"{name} is not aligned to {align} bytes")


def _check_layout(layout: CellLayout):
    """Raise on a layout the kernels do not take."""
    device = layout.xyz.device
    n = layout.n
    cells = layout.num_cells
    if cells >= 2 ** 31 - 1 or n >= 2 ** 31 - 2 ** 16:
        raise ValueError("bead or cell count does not fit 32-bit indices")
    # The kernel copies positions 16 bytes and factors 8 bytes at a time.
    _check_tensor("xyz", layout.xyz, torch.float32, (n, 4), device, 16)
    _check_tensor("ab", layout.ab, torch.float32, (n, 2), device, 8)
    _check_tensor("cell_id", layout.cell_id, torch.int32, (n,), device, 4)
    _check_tensor("cell_start", layout.cell_start, torch.int32, (cells + 1,), device, 4)
    _check_tensor("order", layout.order, torch.int64, (n,), device, 8)


def _launch(layout: CellLayout, params, with_energy, begin=0, end=None):
    """Check the inputs, allocate the outputs and launch the kernel on the
    current stream, without synchronising.  Returns (forces (N, 3), per-bead
    energy (N,) or None) in bead order.  The kernel takes the home range
    ``[begin, end)`` and clips ``end`` on the device to the rows that take
    part."""
    e_a, inv_da2, e_b, inv_db2 = _check_params(layout, params)
    _check_layout(layout)
    device = layout.xyz.device
    n = layout.n
    begin = max(int(begin), 0)
    end = n if end is None else min(int(end), n)
    # Rows the kernel does not write (outside the home range, padding) stay 0.
    partial = begin > 0 or end < n or layout.padded
    alloc = torch.zeros if partial else torch.empty
    forces = alloc((n, 3), dtype=torch.float32, device=device)
    per_bead = alloc((n,), dtype=torch.float32, device=device) if with_energy else None
    with torch.cuda.device(device):
        status = _entry_points()[0](
            layout.xyz.data_ptr(), layout.ab.data_ptr(), layout.cell_id.data_ptr(),
            layout.cell_start.data_ptr(), layout.order.data_ptr(), begin, end, *layout.shape,
            e_a, inv_da2, e_b, inv_db2,
            forces.data_ptr(), per_bead.data_ptr() if with_energy else None,
            torch.cuda.current_stream().cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"ab_pair_forces kernel launch failed: CUDA error {status}")
    return forces, per_bead


@tracing.traced("pair")
def ab_pair_forces(layout: CellLayout, params, with_energy: bool = False,
                   begin: int = 0, end=None, per_bead: bool = False):
    """A/B pair force (and optionally its energy) over a cell layout.

    ``params`` = [e_a, 1/d_a^2, e_b, 1/d_b^2] as Python floats, passed to the
    kernel by value.  Returns (forces (N, 3) in bead-id order, energy: a
    scalar tensor, zero unless ``with_energy``, or with ``per_bead`` the (N,)
    energies of the beads).  On a layout of R replicas N counts the beads of
    all of them, and the forces reshape to (R, N / R, 3).

    Only the beads of the home range ``[begin, end)`` of the sorted order get
    their force and energy (by default all of them); the other rows, padding
    included, come back as zeros.  ``end`` is clipped to the rows that take
    part on the device, so the call needs no host synchronisation.

    A CUDA layout goes to the kernel of ``csrc/ab_pair_forces.cu``, launched
    on the current stream without synchronising; anything that keeps it from
    launching raises.  A CPU layout goes to the plain version.
    """
    if layout.xyz.device.type != "cuda":
        return ab_pair_forces_reference(layout, params, with_energy, begin, end, per_bead)
    forces, energies = _launch(layout, params, with_energy or per_bead, begin=begin, end=end)
    tracing.count("launch.ab_pair_forces")
    if per_bead:
        return forces, energies
    energy = energies.sum() if with_energy else forces.new_zeros(())
    return forces, energy



def ab_pair_forces_rows(layout: CellLayout, scalars: StepScalars):
    """The forces of :func:`ab_pair_forces` (every row, no energy) on a
    CUDA layout without padding, e_a, 1/d_a^2, e_b, 1/d_b^2 read by the
    kernel from the step's row of ``scalars`` on the card: a launch that a
    CUDA graph replays step after step.  The rows' diameters are checked
    against the cell where the table is built.  Counts no launch: the
    graph's replays do."""
    _check_layout(layout)
    device = layout.xyz.device
    if device.type != "cuda" or layout.padded:
        raise ValueError("the pair kernel reads its scalars on the card only for a CUDA "
                         "layout without padding")
    _check_tensor("step index", scalars.index, torch.int32, (1,), device, 4)
    _check_tensor("step rows", scalars.rows, torch.float32,
                  (scalars.rows.shape[0], STEP_ROW), device, 16)
    launch = _entry_points()[1]
    n = layout.n
    forces = torch.empty((n, 3), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        status = launch(
            layout.xyz.data_ptr(), layout.ab.data_ptr(), layout.cell_id.data_ptr(),
            layout.cell_start.data_ptr(), layout.order.data_ptr(), 0, n, *layout.shape,
            scalars.rows.data_ptr(), scalars.index.data_ptr(), forces.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"ab_pair_forces kernel launch failed: CUDA error {status}")
    return forces


def candidate_pairs(layout: CellLayout) -> int:
    """Ordered candidate pairs (i, j != i) of the 27-cell stencil for this
    layout: the work the kernel's float32 bound is computed from."""
    total = 0
    for _, count in stencil_ranges(layout):
        total += int(count.sum())
    return total - int(layout.cell_start[-1])


def pairs_in_reach(layout: CellLayout, params) -> int:
    """Ordered pairs (i, j != i) among the candidates that pass
    :func:`in_reach`: the pairs the inputs strictly need evaluated."""
    _, inv_da2, _, inv_db2 = _check_params(layout, params)
    pos = layout.xyz[:, :3]
    total = 0
    for start, count in stencil_ranges(layout):
        for i, j in expand_ranges(start, count):
            dx = pos[i] - pos[j]
            r2 = torch.sum(dx * dx, dim=-1)
            total += int((in_reach(r2, inv_da2, inv_db2) & (i != j)).sum())
    return total
