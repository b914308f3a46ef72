"""Compartment (PC1) profile from a contact matrix, on a torch device.

The port's counterpart of ``genome_cycle_tpu.analysis.pc1``: cooler matrix
-> observed/expected normalization (per-separation cis expected, scalar trans
expected) -> column standardization -> power iteration for the first right
singular vector -> PC1 scaled so its variance equals the explained-variance
ratio; same TSV/JSON outputs and CLI flags.

The matrix is one float32 tensor on the device, normalized in place.  Where
the port's arithmetic differs from the JAX package's numpy:

- the cis expected is summed in float64 per separation, as in the JAX
  package, and cast to the matrix's dtype; the trans expected is summed in
  float64 (the JAX package sums float32 values in float32, then divides in
  float64);
- column means and standard deviations (ddof 0, over the finite entries) are
  accumulated in float64, so a column is dropped as zero-variance exactly
  when all its finite entries are equal;
- after the mean imputation no entry is NaN, so the JAX package's
  ``nansum(weights[:, None] * data, 0)`` is ``data.T @ (data @ v)``: two
  ``torch.mv`` calls a step.  The kept columns are standardized and iterated
  in float64, as the JAX package's iteration runs (its start vector
  ``ones / np.sqrt(dim)`` is float64 under numpy 2): a weak PC1 converges
  slowly, and in float32 the rounding of two devices could stop the
  iteration a step apart, which moves pc1 by about 1e-3 of its largest
  value;
- divisions by a scalar go through a 0-d tensor on the device, a true
  division as numpy's, not a product with the reciprocal.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from .common import invoke_main, remove_none
from .cool import add_device_argument
from .coolio import Cooler

LOG = logging.getLogger()

#: Columns whose moments are accumulated at a time (bounds the float64
#: temporaries of :func:`column_moments`).
_MOMENT_COLUMNS = 2048


def leading_singular_vector(
    data: torch.Tensor, *, tol: float = 1e-4, max_iters: int = 10_000
) -> tuple[torch.Tensor, int, float]:
    """First right singular vector of ``data`` by power iteration on the
    Gram operator v -> normalize(Dᵀ(Dv)), two matrix-vector products a step
    in ``data``'s dtype.  A row that holds a NaN is left out, as the JAX
    package's ``nansum`` leaves it out.  Returns (vector, iterations, final
    max-abs step delta)."""
    nan_rows = torch.isnan(data).any(dim=1)
    if bool(nan_rows.any()):
        data = torch.where(nan_rows[:, None], torch.zeros((), dtype=data.dtype,
                                                          device=data.device), data)
    dim = data.shape[1]
    vec = torch.full((dim,), 1.0 / math.sqrt(dim), dtype=data.dtype, device=data.device)
    delta = math.inf
    step = 0
    for step in range(1, max_iters + 1):
        nxt = torch.mv(data.T, torch.mv(data, vec))
        nxt = nxt / torch.linalg.vector_norm(nxt)
        delta = float(torch.abs(nxt - vec).max())
        vec = nxt
        if delta < tol:
            break
    return vec, step, delta


class OEProfile(NamedTuple):
    """Expected contact frequencies: per-separation within a chromosome
    (a tensor in the matrix's dtype), one scalar across chromosomes."""

    cis_by_separation: torch.Tensor
    trans_mean: float


def _separations(n: int, device) -> torch.Tensor:
    """(n, n) grid of genomic separations |i - j|."""
    idx = torch.arange(n, device=device)
    return torch.abs(idx[:, None] - idx[None, :])


def estimate_expected(matrix: torch.Tensor, chrom_ranges: dict) -> OEProfile:
    """Mean finite contact per separation (cis, upper triangle once) and the
    scalar mean over all finite trans pixels, one pass per chromosome
    block; sums in float64."""
    device = matrix.device
    max_sep = max(end - start for start, end in chrom_ranges.values())
    cis_sum = torch.zeros(max_sep, dtype=torch.float64, device=device)
    cis_cnt = torch.zeros(max_sep, dtype=torch.int64, device=device)
    trans_sum = 0.0
    trans_cnt = 0

    for start, end in chrom_ranges.values():
        rows = matrix[start:end]
        cis = rows[:, start:end]
        n = end - start

        sep = _separations(n, device)
        cis_ok = torch.isfinite(cis)
        keep = cis_ok & torch.ones((n, n), dtype=torch.bool, device=device).triu()
        cis_sum += torch.bincount(sep[keep], weights=cis[keep].double(), minlength=max_sep)
        cis_cnt += torch.bincount(sep[keep], minlength=max_sep)

        # Trans pixels of this row block = all finite entries outside the
        # cis square (counted once per orientation, like a full-row scan).
        row_ok = torch.isfinite(rows)
        zero = torch.zeros((), dtype=matrix.dtype, device=device)
        trans_sum += float(torch.where(row_ok, rows, zero).sum(dtype=torch.float64)) - float(
            torch.where(cis_ok, cis, zero).sum(dtype=torch.float64))
        trans_cnt += int(row_ok.sum()) - int(cis_ok.sum())

    cis_mean = (cis_sum / cis_cnt).to(matrix.dtype)
    return OEProfile(
        cis_by_separation=cis_mean,
        trans_mean=(trans_sum / trans_cnt) if trans_cnt else math.nan,
    )


def oe_normalize(
    matrix: torch.Tensor, chrom_ranges: dict, profile: OEProfile, mask_intra: bool
) -> None:
    """In-place observed/expected division (cis by the separation profile via
    one gathered divide per block, trans by the scalar)."""
    trans = torch.tensor(profile.trans_mean, dtype=matrix.dtype, device=matrix.device)
    for start, end in chrom_ranges.values():
        rows = matrix[start:end]
        rows[:, :start] /= trans
        rows[:, end:] /= trans
        cis = rows[:, start:end]
        if mask_intra:
            cis.masked_fill_(torch.isfinite(cis), 1)
        else:
            cis /= profile.cis_by_separation[_separations(end - start, matrix.device)]


def column_moments(data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and standard deviation (ddof 0) of every column over its finite
    entries, accumulated in float64; NaN for a column without any."""
    means, stds = [], []
    for k in range(0, data.shape[1], _MOMENT_COLUMNS):
        cols = data[:, k:k + _MOMENT_COLUMNS].double()
        ok = torch.isfinite(cols)
        count = ok.sum(0)
        cols = torch.where(ok, cols, torch.zeros((), dtype=cols.dtype, device=cols.device))
        mean = cols.sum(0) / count
        cols = torch.where(ok, cols - mean, torch.zeros((), dtype=cols.dtype, device=cols.device))
        means.append(mean)
        stds.append(torch.sqrt((cols * cols).sum(0) / count))
    return torch.cat(means), torch.cat(stds)


def scatter_to_full(values: torch.Tensor, mask: torch.Tensor, fill=math.nan) -> torch.Tensor:
    """Place ``values`` at the True positions of ``mask``; ``fill`` elsewhere."""
    out = torch.full(mask.shape, fill, dtype=values.dtype, device=values.device)
    out[mask] = values
    return out


def compute_pc1(
    contact_matrix: torch.Tensor,
    chrom_ranges: dict,
    *,
    mask_intra: bool = False,
    use_covariance: bool = False,
    svd_tolerance: float = 1e-4,
    max_iters: int = 10_000,
    timings: dict | None = None,
):
    """Core O/E + PC1 computation on the matrix's device; normalizes
    ``contact_matrix`` in place.  Returns (pc1, ev1, evr, expected): pc1 and
    ev1 tensors, evr a float.  ``timings``, when given, receives the kept
    columns, the power iteration's steps and final delta, and its host-clock
    seconds (the device synchronised on both sides)."""
    expected = estimate_expected(contact_matrix, chrom_ranges)
    data_matrix = contact_matrix
    oe_normalize(data_matrix, chrom_ranges, expected, mask_intra)

    coverages = torch.nansum(data_matrix, dim=0)
    selection = coverages > 0
    if not use_covariance:
        # Zero-variance columns cannot be standardized; drop them with the
        # empty ones.
        _, col_std = column_moments(data_matrix)
        selection &= torch.nan_to_num(col_std) > 0
    data_matrix = data_matrix[:, selection].double()
    data_matrix.masked_fill_(torch.isinf(data_matrix), math.nan)
    mean, _ = column_moments(data_matrix)
    data_matrix -= mean.to(data_matrix.dtype)
    if not use_covariance:
        _, std = column_moments(data_matrix)
        data_matrix /= std.to(data_matrix.dtype)
    # Mean-impute scattered invalid entries (empty expected diagonals on
    # sparse matrices leave NaNs inside otherwise-valid rows).  After
    # centering, the column mean is 0.
    data_matrix.masked_fill_(~torch.isfinite(data_matrix), 0.0)

    LOG.info(
        "Kept %d of %d bins (nonzero coverage%s)",
        data_matrix.shape[1],
        len(selection),
        "" if use_covariance else " and variance",
    )

    _synchronize(data_matrix.device)
    started = time.perf_counter()
    vector, iters, delta = leading_singular_vector(
        data_matrix, tol=svd_tolerance, max_iters=max_iters
    )
    _synchronize(data_matrix.device)
    if timings is not None:
        timings.update(kept=data_matrix.shape[1], power_steps=iters, power_delta=delta,
                       power_seconds=time.perf_counter() - started)
    LOG.info("Power iteration: %d steps, final delta %.2g", iters, delta)

    pc1 = torch.mv(data_matrix, vector)
    ev1 = scatter_to_full(vector, selection)

    # pc1 comes out multiplied by the first singular value; rescale so that
    # var(pc1) equals the explained-variance ratio.
    _, std = column_moments(data_matrix)
    data_var = float(torch.sum(std * std))
    pc1 = pc1 / torch.tensor(math.sqrt(data_var), dtype=pc1.dtype, device=pc1.device)
    evr = float(torch.var(pc1.double(), unbiased=False))
    return pc1, ev1, evr, expected


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(
    *,
    cool: str,
    output: str,
    aux_output: str | None = None,
    mask_intra: bool = False,
    use_covariance: bool = False,
    use_raw: bool = False,
    svd_tolerance: float = 1e-4,
    device=None,
):
    device = resolve_device(device)
    LOG.info("Opening cooler dataset %s", cool)
    clr = Cooler(cool)
    bins = clr.bins()[:]

    LOG.info("Loading contact matrix")
    contact_matrix = clr.matrix(balance=(not use_raw), device=device,
                                dtype=torch.float32)[:, :]
    chrom_ranges = {chrom: clr.extent(chrom) for chrom in clr.chromnames}

    LOG.info("Computing O/E matrix + PC1")
    pc1, ev1, evr, expected = compute_pc1(
        contact_matrix,
        chrom_ranges,
        mask_intra=mask_intra,
        use_covariance=use_covariance,
        svd_tolerance=svd_tolerance,
    )
    LOG.info("Explained variance ratio: %.1f %%", evr * 100)
    write_pc1(output, bins, pc1, ev1, evr, expected, aux_output)


def write_pc1(output: str, bins, pc1, ev1, evr: float, expected: OEProfile,
              aux_output: str | None = None):
    """The PC1 table (the bins' chrom/start/end, then ev1 and pc1) and,
    with ``aux_output``, the JSON of the explained-variance ratio, the cis
    decay profile and the trans expected."""
    # Output contract (columns, separators, NaN spelling, aux keys) follows
    # the reference tool so downstream comparisons are drop-in.
    table = bins[["chrom", "start", "end"]].copy()
    table["ev1"] = ev1.cpu().numpy().astype(np.float64)
    table["pc1"] = pc1.cpu().numpy().astype(np.float64)
    table.to_csv(
        output, sep="\t", float_format="%g", na_rep="nan", index=False
    )

    if aux_output:
        with open(aux_output, "w") as file:
            json.dump(
                {
                    "explained_variance_ratio": float(evr),
                    "cis_decay_profile": np.asarray(
                        expected.cis_by_separation.cpu().numpy(), dtype=float
                    ).tolist(),
                    "trans_contact": expected.trans_mean,
                },
                file,
            )


def chrom_ranges_of(bins) -> dict:
    """{chrom: (first bin, end)} in the order of the bin table, as
    ``Cooler.extent`` gives them for a file written from it."""
    names = list(dict.fromkeys(bins["chrom"].astype(str)))
    ids = bins["chrom"].astype(str).map({name: k for k, name in enumerate(names)}).to_numpy()
    offsets = np.searchsorted(ids, np.arange(len(names) + 1))
    return {name: (int(offsets[k]), int(offsets[k + 1])) for k, name in enumerate(names)}


def pc1_of_trajectories(sources, device=None, stats: dict | None = None):
    """The haploid PC1 of trajectory stores (paths or open stores), as
    ``cool``, ``dephase`` and ``pc1`` with their defaults give it through
    ``.cool`` files, but in memory on ``device``: the merged pixels, ICE,
    the dephased pixels, ICE, the balanced dense haploid map in float32, O/E
    and PC1.  Returns (haploid bins, pc1, ev1, evr, expected), what
    :func:`write_pc1` takes.  ``stats``, when given, receives the counts of
    each step (bins, pixels, contacts, ICE rounds, kept columns, power
    steps) and its host-clock seconds (the device synchronised)."""
    from . import cool, coolio, dephase

    device = resolve_device(device)
    stats = {} if stats is None else stats
    seconds = stats.setdefault("seconds", {})

    def timed(name, fn):
        _synchronize(device)
        started = time.perf_counter()
        out = fn()
        _synchronize(device)
        seconds[name] = time.perf_counter() - started
        return out

    bins, b1, b2, counts = timed("cool", lambda: cool.contact_pixels(sources, device=device))
    stats.update(bins=len(bins), pixels=len(b1), contacts=int(counts.sum()))
    ice = {}
    weights = timed("ice", lambda: coolio.ice_weights(b1, b2, counts, len(bins), stats=ice))
    hap_bins, projection = dephase.project_bins(bins)
    nh = len(hap_bins)
    h1, h2, hcounts = timed("dephase", lambda: coolio.merge_pixels(
        [dephase.dephase_pixels(b1, b2, counts, projection)], nh, device))
    del b1, b2, counts, weights
    hap_ice = {}
    hweights = timed("ice_haploid", lambda: coolio.ice_weights(
        h1, h2, hcounts, nh, stats=hap_ice))
    stats.update(haploid_bins=nh, haploid_pixels=len(h1),
                 ice_rounds=[ice["rounds"], hap_ice["rounds"]])
    matrix = timed("dense", lambda: coolio.dense_matrix(
        h1, h2, hcounts, (0, nh), (0, nh), hweights.cpu().numpy(), torch.float32))
    pc_timings = {}
    pc1, ev1, evr, expected = timed("pc1", lambda: compute_pc1(
        matrix, chrom_ranges_of(hap_bins), timings=pc_timings))
    stats.update(kept=pc_timings["kept"], power_steps=pc_timings["power_steps"])
    return hap_bins, pc1, ev1, evr, expected


def parse_args(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Compute compartment signal")
    parser.add_argument("--svd-tolerance", metavar="1e-4", type=float, default=None)
    parser.add_argument("--use-raw", action="store_true", default=None)
    parser.add_argument("--use-covariance", action="store_true", default=None)
    parser.add_argument("--mask-intra", action="store_true", default=None)
    parser.add_argument("--aux-output", metavar="aux.json", type=str, default=None)
    parser.add_argument("--output", metavar="pc1.tsv", required=True)
    add_device_argument(parser)
    parser.add_argument("cool")
    return remove_none(vars(parser.parse_args(argv)))


if __name__ == "__main__":
    invoke_main(main, parse_args(), LOG)
