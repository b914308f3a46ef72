"""Minimal cooler-format (.cool) reader/writer + ICE matrix balancing, with
the numerics on a torch device.

The port's counterpart of ``genome_cycle_tpu.analysis.coolio``.  The file
schema is the same documented single-resolution cooler layout:

    /chroms/name, /chroms/length
    /bins/chrom (enum-coded int32), /bins/start, /bins/end [, /bins/weight]
    /pixels/bin1_id, /pixels/bin2_id, /pixels/count
    /indexes/chrom_offset, /indexes/bin1_offset
    root attrs: format, format-version, bin-type, bin-size, nbins, nchroms,
    nnz, storage-mode ("symmetric-upper"), sum

plus multi-resolution container paths (``file.mcool::/resolutions/<res>``).
File I/O stays on the host: ``h5py`` is imported where a file is opened.
The numerics are torch functions that run where their tensors lie:

- :func:`merge_pixels` — the pixel merge of :func:`create_cooler`:
  upper-triangle keys, ``unique`` + ``index_add_`` in float64, rounded half
  to even as ``np.rint`` rounds;
- :func:`ice_weights` — iterative correction (ICE), the numerics of
  :func:`balance_cooler`: coverage, MAD filter with numpy's median (the mean
  of the two middle values of an even count), up to ``max_iters`` rounds,
  final unit marginals;
- :func:`dense_matrix` — the dense fetch: both orientations, the diagonal
  once, optionally times ``w_i w_j`` formed in float64 (a masked bin's NaN
  weight makes its whole row and column NaN, zeros included).

Counts are integers, so merged pixels equal numpy's whatever the order of
the sums; balancing weights agree to float64 rounding of sums taken in
another order (or, where the stopping test falls within that rounding of
``tol``, one round apart).
"""

from __future__ import annotations

import datetime

import numpy as np
import pandas as pd
import torch

from .. import resolve_device

#: Rows of the dense block weighted at a time (bounds the temporary outer
#: product of the weights).
_WEIGHT_ROWS = 1024


def _split_uri(uri: str) -> tuple[str, str]:
    if "::" in uri:
        path, group = uri.split("::", 1)
        if not group.startswith("/"):
            group = "/" + group
        return path, group
    return uri, "/"


def _column(values, device) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        return values.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(values), device=device).to(torch.int64)


def merge_pixels(chunks, n_bins: int, device=None):
    """Merge pixel chunks into sorted upper-triangle pixels on ``device``.

    ``chunks``: iterable of dicts or DataFrames with bin1_id/bin2_id/count
    (numpy arrays, lists or tensors).  Each pixel is keyed ``lo * n + hi``;
    duplicate keys merge by summation in float64, rounded half to even.
    Returns int64 tensors (bin1, bin2, count), sorted by (bin1, bin2).
    """
    device = resolve_device(device)
    keys, counts = [], []
    for chunk in chunks:
        b1 = _column(chunk["bin1_id"], device)
        b2 = _column(chunk["bin2_id"], device)
        if b1.numel() == 0:
            continue
        keys.append(torch.minimum(b1, b2) * n_bins + torch.maximum(b1, b2))
        ct = chunk["count"]
        ct = ct if isinstance(ct, torch.Tensor) else torch.as_tensor(np.asarray(ct))
        counts.append(ct.to(device=device, dtype=torch.float64))
    if not keys:
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        return empty, empty.clone(), empty.clone()
    uniq, inverse = torch.unique(torch.cat(keys), sorted=True, return_inverse=True)
    sums = torch.zeros(len(uniq), dtype=torch.float64, device=device)
    sums.index_add_(0, inverse, torch.cat(counts))
    return uniq // n_bins, uniq % n_bins, torch.round(sums).to(torch.int64)


def write_cooler(uri: str, bins: pd.DataFrame, bin1, bin2, counts, assembly=None):
    """Write merged pixels (sorted upper-triangle, as :func:`merge_pixels`
    returns them) and ``bins`` as a .cool dataset."""
    import h5py

    path, group = _split_uri(uri)
    bins = bins.reset_index(drop=True)
    n_bins = len(bins)
    bin1, bin2, counts = (
        (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).astype(np.int64)
        for v in (bin1, bin2, counts)
    )

    chrom_names = list(pd.unique(bins["chrom"].astype(str)))
    chrom_ids = {name: k for k, name in enumerate(chrom_names)}
    bin_chrom_ids = bins["chrom"].astype(str).map(chrom_ids).to_numpy(np.int32)
    # chrom length = max bin end per chromosome
    lengths = np.zeros(len(chrom_names), dtype=np.int64)
    ends = bins["end"].to_numpy()
    np.maximum.at(lengths, bin_chrom_ids, ends)

    widths = ends - bins["start"].to_numpy()
    binsize = int(widths.max()) if n_bins else 0
    uniform = n_bins > 0 and (widths == binsize).sum() >= n_bins - len(chrom_names)

    text = h5py.string_dtype(encoding="utf-8")
    mode = "w" if group == "/" else "a"
    with h5py.File(path, mode) as f:
        grp = f.require_group(group) if group != "/" else f
        for key in ("chroms", "bins", "pixels", "indexes"):
            if key in grp:
                del grp[key]

        grp.create_dataset("chroms/name", data=np.asarray(chrom_names, object), dtype=text)
        grp.create_dataset("chroms/length", data=lengths)
        grp.create_dataset("bins/chrom", data=bin_chrom_ids)
        grp.create_dataset("bins/start", data=bins["start"].to_numpy(np.int64))
        grp.create_dataset("bins/end", data=bins["end"].to_numpy(np.int64))
        grp.create_dataset("pixels/bin1_id", data=bin1)
        grp.create_dataset("pixels/bin2_id", data=bin2)
        grp.create_dataset("pixels/count", data=counts)

        chrom_offset = np.searchsorted(
            bin_chrom_ids, np.arange(len(chrom_names) + 1), side="left"
        ).astype(np.int64)
        bin1_offset = np.searchsorted(
            bin1, np.arange(n_bins + 1), side="left"
        ).astype(np.int64)
        grp.create_dataset("indexes/chrom_offset", data=chrom_offset)
        grp.create_dataset("indexes/bin1_offset", data=bin1_offset)

        grp.attrs["format"] = "HDF5::Cooler"
        grp.attrs["format-version"] = np.int64(3)
        grp.attrs["bin-type"] = "fixed" if uniform else "variable"
        grp.attrs["bin-size"] = np.int64(binsize)
        grp.attrs["storage-mode"] = "symmetric-upper"
        grp.attrs["nbins"] = np.int64(n_bins)
        grp.attrs["nchroms"] = np.int64(len(chrom_names))
        grp.attrs["nnz"] = np.int64(len(bin1))
        grp.attrs["sum"] = np.int64(counts.sum())
        grp.attrs["generated-by"] = "genome_cycle_tpu_torch"
        grp.attrs["creation-date"] = datetime.datetime.now().isoformat()
        if assembly:
            grp.attrs["genome-assembly"] = assembly


def create_cooler(uri: str, bins: pd.DataFrame, pixels_iter, assembly=None, device=None):
    """Create a .cool dataset from bins and an iterable of pixel chunks.

    ``bins``: DataFrame with chrom/start/end columns (chrom order defines
    chromosome order).  ``pixels_iter``: iterable of dicts or DataFrames with
    bin1_id/bin2_id/count; duplicate (bin1, bin2) entries are merged by
    summation on ``device`` (:func:`merge_pixels`).
    """
    bins = bins.reset_index(drop=True)
    bin1, bin2, counts = merge_pixels(pixels_iter, len(bins), device)
    write_cooler(uri, bins, bin1, bin2, counts, assembly)


def dense_matrix(bin1, bin2, counts, rows, cols, weights=None, dtype=torch.float64):
    """Dense block ``[r0, r1) x [c0, c1)`` of the symmetric matrix whose
    upper triangle the pixels hold, on the pixels' device.

    A pixel lands at (bin1, bin2) and, off the diagonal, at (bin2, bin1).
    With ``weights`` (float64, one per bin) the block is multiplied by
    ``w_i w_j`` in float64, as the JAX package multiplies it; the block is
    cast to ``dtype`` last.
    """
    (r0, r1), (c0, c1) = rows, cols
    device = bin1.device
    out = torch.zeros((r1 - r0, c1 - c0), dtype=torch.float64, device=device)
    counts = counts.to(torch.float64)
    direct = (bin1 >= r0) & (bin1 < r1) & (bin2 >= c0) & (bin2 < c1)
    out.index_put_((bin1[direct] - r0, bin2[direct] - c0), counts[direct], accumulate=True)
    mirror = (bin2 >= r0) & (bin2 < r1) & (bin1 >= c0) & (bin1 < c1) & (bin1 != bin2)
    out.index_put_((bin2[mirror] - r0, bin1[mirror] - c0), counts[mirror], accumulate=True)
    if weights is not None:
        w = torch.as_tensor(weights, dtype=torch.float64, device=device)
        w_cols = w[c0:c1]
        for k in range(0, r1 - r0, _WEIGHT_ROWS):
            block = out[k:k + _WEIGHT_ROWS]
            block *= w[r0 + k:r0 + k + len(block), None] * w_cols[None, :]
    return out if dtype == torch.float64 else out.to(dtype)


class _MatrixSelector:
    def __init__(self, clr: "Cooler", balance: bool, device, dtype):
        self._clr = clr
        self._balance = balance
        self._device = device
        self._dtype = dtype

    def __getitem__(self, key):
        if not isinstance(key, tuple) or len(key) != 2:
            raise TypeError("matrix selector expects [rows, cols] slices")
        r, c = key
        n = self._clr.nbins

        def bounds(s):
            if isinstance(s, slice):
                return s.indices(n)[0], s.indices(n)[1]
            return int(s), int(s) + 1

        r0, r1 = bounds(r)
        c0, c1 = bounds(c)
        return self._clr._fetch_dense(r0, r1, c0, c1, self._balance, self._device, self._dtype)

    @property
    def shape(self):
        return (self._clr.nbins, self._clr.nbins)


class Cooler:
    """Read-side API mirroring the subset of ``cooler.Cooler`` used by the
    reference analysis scripts: bins()/chromnames/extent()/matrix()/pixels()/
    info.  ``matrix()`` gives tensors on a device."""

    def __init__(self, uri: str):
        import h5py

        self.uri = uri
        self._path, self._group = _split_uri(uri)
        with h5py.File(self._path, "r") as f:
            grp = f[self._group]
            self._chrom_names = [
                n.decode() if isinstance(n, bytes) else str(n)
                for n in grp["chroms/name"][:]
            ]
            self._chrom_offset = grp["indexes/chrom_offset"][:]
            self._bin1_offset = grp["indexes/bin1_offset"][:]
            self.nbins = int(grp.attrs.get("nbins", len(grp["bins/start"])))
            self.info = dict(grp.attrs)

    def _open(self):
        import h5py

        return h5py.File(self._path, "r")

    @property
    def chromnames(self):
        return list(self._chrom_names)

    def extent(self, chrom: str) -> tuple[int, int]:
        k = self._chrom_names.index(chrom)
        return int(self._chrom_offset[k]), int(self._chrom_offset[k + 1])

    def bins(self):
        with self._open() as f:
            grp = f[self._group]
            chrom_ids = grp["bins/chrom"][:]
            data = {
                "chrom": np.asarray(self._chrom_names, object)[chrom_ids],
                "start": grp["bins/start"][:],
                "end": grp["bins/end"][:],
            }
            if "bins/weight" in grp:
                data["weight"] = grp["bins/weight"][:]
        return _SliceableFrame(pd.DataFrame(data))

    def pixels(self):
        with self._open() as f:
            grp = f[self._group]
            frame = pd.DataFrame(
                {
                    "bin1_id": grp["pixels/bin1_id"][:],
                    "bin2_id": grp["pixels/bin2_id"][:],
                    "count": grp["pixels/count"][:],
                }
            )
        return _SliceableFrame(frame)

    def pixel_tensors(self, device=None):
        """All pixels as int64 tensors (bin1, bin2, count) on ``device``."""
        device = resolve_device(device)
        with self._open() as f:
            grp = f[self._group]
            return tuple(
                torch.as_tensor(grp[f"pixels/{name}"][:], device=device).to(torch.int64)
                for name in ("bin1_id", "bin2_id", "count")
            )

    def matrix(self, balance=True, device=None, dtype=torch.float64):
        """Dense selector: ``clr.matrix()[r0:r1, c0:c1]`` is a ``dtype``
        tensor on ``device`` (:func:`dense_matrix`)."""
        return _MatrixSelector(self, balance, resolve_device(device), dtype)

    def pixel_slice(self, r0: int, r1: int):
        """(bin1, bin2, count) arrays for pixels whose bin1 lies in [r0, r1).

        Upper-triangular pixels are sorted by bin1, so this is a single
        contiguous HDF5 read via the bin1_offset index — no dense matrix."""
        lo = int(self._bin1_offset[r0])
        hi = int(self._bin1_offset[r1])
        with self._open() as f:
            grp = f[self._group]
            return (
                grp["pixels/bin1_id"][lo:hi],
                grp["pixels/bin2_id"][lo:hi],
                grp["pixels/count"][lo:hi],
            )

    def _fetch_dense(self, r0, r1, c0, c1, balance, device, dtype):
        # The pixels of both orientations lie among those whose bin1 is in
        # [min(r0, c0), max(r1, c1)): one contiguous read.
        lo, hi = min(r0, c0), max(r1, c1)
        b1, b2, ct = self.pixel_slice(lo, max(hi, lo))
        weights = None
        if balance:
            with self._open() as f:
                grp = f[self._group]
                if "bins/weight" not in grp:
                    raise ValueError("no balancing weights; run balance_cooler")
                weights = grp["bins/weight"][:]
        b1, b2, ct = (torch.as_tensor(v, device=device).to(torch.int64) for v in (b1, b2, ct))
        return dense_matrix(b1, b2, ct, (r0, r1), (c0, c1), weights, dtype)


class _SliceableFrame:
    """cooler-style lazy table: supports [:] and [a:b] selection."""

    def __init__(self, frame: pd.DataFrame):
        self._frame = frame

    def __getitem__(self, key):
        if isinstance(key, slice):
            return self._frame.iloc[key].reset_index(drop=True)
        return self._frame[key]

    def __len__(self):
        return len(self._frame)


def _median(values: torch.Tensor) -> torch.Tensor:
    """numpy's median: the middle value, or the mean of the two middle
    values of an even count (``torch.median`` returns the lower one)."""
    ordered = torch.sort(values).values
    k = ordered.numel() // 2
    if ordered.numel() % 2:
        return ordered[k]
    return (ordered[k - 1] + ordered[k]) / 2


def ice_weights(bin1, bin2, counts, n: int, *, max_iters: int = 200,
                tol: float = 1e-5, mad_max: float = 5.0, stats=None):
    """ICE weights of upper-triangle pixels, on the pixels' device.

    Divisive weights w (float64) with ``w_i c_ij w_j`` of unit marginals;
    zero-coverage bins and bins whose log coverage lies more than
    ``mad_max`` MADs from the median are masked (NaN), like cooler's default
    filtering.  ``stats``, when given, receives the number of rounds.
    """
    device = bin1.device
    counts = counts.to(torch.float64)
    off_diagonal = (bin1 != bin2).to(torch.float64)

    def marginals(values):
        marg = torch.zeros(n, dtype=torch.float64, device=device)
        marg.index_add_(0, bin1, values)
        marg.index_add_(0, bin2, values * off_diagonal)
        return marg

    coverage = marginals(counts)
    mask = coverage > 0
    if int(mask.sum()) > 1:
        logc = torch.log(coverage[mask])
        med = _median(logc)
        mad = _median(torch.abs(logc - med)) * 1.4826
        if float(mad) > 0:
            mask_ids = torch.nonzero(mask).squeeze(1)
            mask[mask_ids[torch.abs(logc - med) > mad_max * mad]] = False

    w = mask.to(torch.float64)
    rounds = 0
    for _ in range(max_iters):
        marg = marginals(counts * w[bin1] * w[bin2])
        nz = marg[mask]
        if nz.numel() == 0:
            break
        scale = nz.mean()
        adj = torch.ones(n, dtype=torch.float64, device=device)
        adj[mask] = torch.where(nz > 0, nz / scale, torch.ones_like(nz))
        w = w / torch.sqrt(adj)
        rounds += 1
        if float(torch.abs(nz / scale - 1.0).max()) < tol:
            break

    # Normalize to unit marginals.
    marg = marginals(counts * w[bin1] * w[bin2])
    nzm = marg[mask & (marg > 0)]
    if nzm.numel():
        w = w / torch.sqrt(nzm.mean())
    if stats is not None:
        stats["rounds"] = rounds
    return torch.where(mask, w, torch.full_like(w, float("nan")))


def balance_cooler(
    clr: Cooler,
    store: bool = True,
    max_iters: int = 200,
    tol: float = 1e-5,
    mad_max: float = 5.0,
    device=None,
):
    """ICE balancing with divisive weights (:func:`ice_weights` on
    ``device``); masks zero-coverage and MAD-outlier bins like cooler's
    default filtering.  Returns the weights as a numpy array and, with
    ``store``, writes them to /bins/weight."""
    bin1, bin2, counts = clr.pixel_tensors(device)
    weights = ice_weights(
        bin1, bin2, counts, clr.nbins, max_iters=max_iters, tol=tol, mad_max=mad_max
    ).cpu().numpy()
    if store:
        import h5py

        with h5py.File(clr._path, "r+") as f:
            grp = f[clr._group]
            if "bins/weight" in grp:
                del grp["bins/weight"]
            grp.create_dataset("bins/weight", data=weights)
    return weights
