"""Neighboring-contact index (NCI) genomic track from an experimental cooler.

The NCI of adjacent bins i, i+1 is the correlation-like ratio

    nci(i) = c[i, i+1] / sqrt(c[i, i] * c[i+1, i+1])

computed on the *raw* (unbalanced) contact matrix: multiplicative bin biases
cancel between numerator and denominator, so no balancing is needed.

Behavioural parity with the reference CLI (src/nci.py, src/pkg/nci/nci.py):
same TSV columns, same bin spans (row i covers input bins i and i+1), same
``--binsize`` mcool resolution handling, same overlap-halving scheme.  The
implementation is different by design: the reference materialises dense
square chunks of the matrix and reads numpy diagonals off them; here the two
needed diagonals are pulled straight out of the cooler's upper-triangular
COO pixel table in one vectorised pass per chromosome — no dense matrix is
ever built and no chunk loop is needed.

The port's copy of ``genome_cycle_tpu.analysis.nci`` (host numpy on the COO
diagonals; no device work).
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import pandas as pd

from .coolio import Cooler
from .common import invoke_main, remove_none

LOG = logging.getLogger()


def extract_diagonals(clr: Cooler, start: int, end: int):
    """Main diagonal and first superdiagonal of the raw matrix restricted to
    bins [start, end), scattered from the COO pixel table.  Missing pixels
    read as 0, matching a dense fetch."""
    n = end - start
    diag = np.zeros(n)
    sup = np.zeros(max(n - 1, 0))
    b1, b2, ct = clr.pixel_slice(start, end)
    offset = b2 - b1
    on_main = offset == 0
    np.add.at(diag, b1[on_main] - start, ct[on_main].astype(np.float64))
    on_sup = (offset == 1) & (b2 < end)
    np.add.at(sup, b1[on_sup] - start, ct[on_sup].astype(np.float64))
    return diag, sup


def nci_scores(diag: np.ndarray, sup: np.ndarray) -> np.ndarray:
    """nci(i) = sup[i] / sqrt(diag[i] * diag[i+1]); NaN at zero-read sites."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return sup / np.sqrt(diag[:-1] * diag[1:])


def decimate_overlaps(track: pd.DataFrame) -> pd.DataFrame:
    """Keep every other row so output bins no longer overlap.  When the row
    count is even the stride would drop genomic coverage at the tail, so the
    final row is kept as well, trimmed to begin where the last kept row's
    source bin ends."""
    kept = track.iloc[::2]
    if len(track) % 2 == 0 and len(track) > 0:
        tail = track.iloc[-1:].copy()
        tail["start"] = track["end"].iloc[-2]
        kept = pd.concat([kept, tail])
    return kept.reset_index(drop=True)


def make_nci_track(clr: Cooler, chrom: str, *, halve: bool = False) -> pd.DataFrame:
    lo, hi = clr.extent(chrom)
    nbins = hi - lo
    if nbins == 0:
        return pd.DataFrame({"chrom": chrom, "start": [], "end": [], "score": []})

    bins = clr.bins()[lo:hi]
    starts = bins["start"].to_numpy()
    ends = bins["end"].to_numpy()
    if nbins == 1:
        # A single-bin chromosome has no neighbouring pair: one NaN row
        # spanning the lone bin (reference fallback branch).
        return pd.DataFrame(
            {"chrom": chrom, "start": starts, "end": ends, "score": np.nan}
        )

    diag, sup = extract_diagonals(clr, lo, hi)
    track = pd.DataFrame(
        {
            "chrom": chrom,
            # Row i spans the coalesced region of input bins i and i+1.
            "start": starts[:-1],
            "end": ends[1:],
            "score": nci_scores(diag, sup),
        }
    )
    return decimate_overlaps(track) if halve else track


def main(*, cool: str, output: str, binsize: int | None = None, halve: bool = True):
    """Build a genome-wide NCI track.  With --binsize the matrix at
    resolution binsize/2 is read from an .mcool container, so that halving
    yields the requested output binsize (reference src/nci.py:16-64)."""
    uri = f"{cool}::/resolutions/{binsize // 2}" if binsize is not None else cool
    clr = Cooler(uri)
    tracks = []
    for chrom in clr.chromnames:
        LOG.info("NCI for %s", chrom)
        tracks.append(make_nci_track(clr, chrom, halve=halve))
    table = pd.concat(tracks, ignore_index=True)
    table.to_csv(output, sep="\t", index=False, float_format="%g")


def parse_args() -> dict:
    parser = argparse.ArgumentParser(description="Compute NCI track from Hi-C")
    parser.add_argument("--binsize", type=int, default=None)
    parser.add_argument("--no-halve", dest="halve", action="store_false", default=None)
    parser.add_argument("--output", required=True)
    parser.add_argument("cool")
    return remove_none(vars(parser.parse_args()))


if __name__ == "__main__":
    invoke_main(main, parse_args(), LOG)
