"""Diploid -> haploid contact-map aggregation.

The port's counterpart of ``genome_cycle_tpu.analysis.dephase``: chain names
"chrN:a"/"chrN:b" fold onto one haploid "chrN" (each chain's k-th bin onto
the chromosome's k-th bin), superposed pixels merge by summation, the virtual
"nucleoli" chain is dropped, unrecognized chain names are skipped with a
warning, and the result is re-balanced unless --no-balancing.

The projection table ``haploid_id[diploid_bin] -> int`` (-1 for dropped
bins) is compiled on the host with pandas (:func:`project_bins`, as in the
JAX package); the gather through it, the drop of unmapped pixels, the
re-orientation, the merge and the balancing run on a torch device.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import pandas as pd
import torch

from .. import resolve_device
from .common import invoke_main, remove_none
from .cool import add_device_argument
from .coolio import Cooler, balance_cooler, create_cooler

LOG = logging.getLogger()
VIRTUAL_CHAINS = {"nucleoli"}


def split_chain_names(names: pd.Series) -> tuple[pd.Series, pd.Series]:
    """Chain name column -> (chromosome prefix, copy suffix); suffix is NaN
    for names without a ':' separator (those are not chain copies)."""
    parts = names.astype(str).str.split(":", n=1, expand=True)
    if parts.shape[1] < 2:
        parts[1] = np.nan
    return parts[0], parts[1]


def project_bins(
    input_bins: pd.DataFrame, virtual: set[str] = VIRTUAL_CHAINS
) -> tuple[pd.DataFrame, np.ndarray]:
    """Compile the haploid bin table and the dense diploid->haploid bin-id
    projection.

    The haploid chromosome layout is the canonical (first-seen) copy of each
    chromosome, in input order, relabeled without its suffix.  Every other
    copy projects positionally: its k-th bin lands on the chromosome's k-th
    bin.  Virtual and unrecognized chains project to -1.
    """
    names = input_bins["chrom"].astype(str)
    chroms, suffixes = split_chain_names(names)
    mappable = suffixes.notna() & ~names.isin(virtual)

    for name in names[~mappable].unique():
        if name not in virtual:
            LOG.warning("Skipping unrecognized chain: %s", name)

    # Canonical copy per chromosome = the first chain carrying it.
    chain_order = list(dict.fromkeys(names[mappable]))
    canonical: dict[str, str] = {}
    for chain in chain_order:
        canonical.setdefault(chain.split(":", 1)[0], chain)

    is_canonical = names.isin(set(canonical.values()))
    output_bins = (
        input_bins.loc[is_canonical]
        .assign(chrom=chroms[is_canonical])
        .reset_index(drop=True)
    )

    # First haploid bin id of each chromosome.
    chrom_first = (
        pd.Series(np.arange(len(output_bins)), index=output_bins["chrom"])
        .groupby(level=0, sort=False)
        .min()
    )
    # Positional offset of each diploid bin within its chain.
    within_chain = input_bins.groupby(names, sort=False).cumcount().to_numpy()

    base = chroms.map(chrom_first).to_numpy(dtype=float)
    projection = np.where(
        mappable.to_numpy() & np.isfinite(base),
        np.nan_to_num(base, nan=0.0).astype(np.int64) + within_chain,
        -1,
    ).astype(np.int64)
    return output_bins, projection


def dephase_pixels(bin1, bin2, counts, projection) -> dict:
    """Gather both pixel endpoints through the projection table; drop pixels
    touching unmapped bins; restore upper-triangular orientation.  On the
    pixels' device; returns a pixel chunk for :func:`.coolio.merge_pixels`."""
    table = torch.as_tensor(np.asarray(projection), dtype=torch.int64, device=bin1.device)
    b1, b2 = table[bin1], table[bin2]
    keep = (b1 >= 0) & (b2 >= 0)
    b1, b2 = b1[keep], b2[keep]
    return {
        "bin1_id": torch.minimum(b1, b2),
        "bin2_id": torch.maximum(b1, b2),
        "count": counts[keep],
    }


def main(*, output: str, input: str, no_balancing: bool = False, device=None):
    device = resolve_device(device)
    LOG.info("Opening cool dataset: %s", input)
    clr = Cooler(input)
    input_bins = clr.bins()[:]
    output_bins, projection = project_bins(input_bins)
    LOG.info(
        "Inferred chromosomes: %s", ", ".join(output_bins["chrom"].unique())
    )
    LOG.info("Bins reduced: %d -> %d", len(input_bins), len(output_bins))

    bin1, bin2, counts = clr.pixel_tensors(device)
    LOG.info("Dephasing %d pixels", len(bin1))
    create_cooler(
        output,
        output_bins,
        [dephase_pixels(bin1, bin2, counts, projection)],
        assembly=clr.info.get("genome-assembly"),
        device=device,
    )
    if not no_balancing:
        LOG.info("Balancing contact matrix")
        balance_cooler(Cooler(output), store=True, device=device)


def parse_args(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Aggregate homologous contacts")
    parser.add_argument("--no-balancing", action="store_true", default=None)
    parser.add_argument("--output", metavar="out.cool", required=True)
    add_device_argument(parser)
    parser.add_argument("input", metavar="in.cool")
    return remove_none(vars(parser.parse_args(argv)))


if __name__ == "__main__":
    invoke_main(main, parse_args(), LOG)
