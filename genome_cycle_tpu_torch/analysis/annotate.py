"""Build the chains.tsv simulation input from an NCI track + cytoBand file.

Pipeline parity with the reference tool (src/annotate.py): NCI scores are
smoothed per chromosome (centered rolling mean), robust-z-scored against a
median/MAD normalizer, and thresholded at ±tristate into A/B/u chromatin
types with per-bead force parameters A=(1,0), B=(0,1), u=(.5,.5).  Cytoband
categories contribute anor/bnor/cen tags and a fallback classification for
bins with undefined NCI.  The emitted chain design is diploid with chrX/chrY
special-casing: chrX:a is normalized against its own score distribution (the
genome-wide normalizer excludes chrX), chrX:b is forced all-B to model the
inactive X, and a chrY yields only a chrY:b copy (no Barr body then).

Implementation notes (original to this framework): bead typing is fully
vectorized — a numpy ``select`` over the z-score and category arrays replaces
the reference's per-bead Python loops, and tag strings are composed by array
concatenation.  The reference's typing loop (src/annotate.py:78-90) is also
in a broken editing state: a stray duplicated line calls
determine_chromatin_type without its required tags argument (TypeError at
runtime) and would override tag-aware parameters with tag-blind ones.  We
implement the evident intent — the tag-aware type drives both the tag letter
and the parameters — and pin it with tests (SURVEY.md §2.10).

The port's copy of ``genome_cycle_tpu.analysis.annotate`` (host code).
"""

from __future__ import annotations

import argparse
import logging
from typing import NamedTuple

import numpy as np
import pandas as pd

from .common import invoke_main, remove_none
from .cyto import CytoCat, attach_cyto_category, load_cyto_band

LOG = logging.getLogger()

# Normalization schemes, per chain copy.
SCHEME_GENOME = "genome-wide"
SCHEME_OWN = "single-chrom"
SCHEME_ALL_B = "all-b"

# Chromatin type codes index these tables.
TYPE_A, TYPE_B, TYPE_U = 0, 1, 2
TYPE_LETTERS = np.array(["A", "B", "u"])
TYPE_PARAMS = np.array([[1.0, 0.0], [0.0, 1.0], [0.5, 0.5]])

# Tag prefix per cytoband category (index = CytoCat code); NOR depends on
# whether the chain's NOR is activated, filled in per chain.  "het" is
# informational in the reference and dropped from its output, so it is never
# emitted here.
_CEN_TAG = "cen,"


class ChainSpec(NamedTuple):
    name: str
    chrom: str
    scheme: str
    activate_nor: bool = False


def plan_diploid_chains(
    chrom_names: list[str], active_nor_patterns: list[str]
) -> list[ChainSpec]:
    """Two copies (:a then :b) of every autosome, with the sex-chromosome
    rules above.  Order: all :a chains, then all :b chains."""
    autosomes = [c for c in chrom_names if c not in ("chrX", "chrY")]
    has_x = "chrX" in chrom_names
    has_y = "chrY" in chrom_names

    def wants_nor(name: str) -> bool:
        return any(name.endswith(pat) for pat in active_nor_patterns)

    plan: list[ChainSpec] = []
    for copy in ("a", "b"):
        for chrom in autosomes:
            name = f"{chrom}:{copy}"
            plan.append(ChainSpec(name, chrom, SCHEME_GENOME, wants_nor(name)))
        if copy == "a" and has_x:
            plan.append(ChainSpec("chrX:a", "chrX", SCHEME_OWN))
        if copy == "b":
            if has_y:
                plan.append(ChainSpec("chrY:b", "chrY", SCHEME_GENOME))
            elif has_x:
                plan.append(ChainSpec("chrX:b", "chrX", SCHEME_ALL_B))
    return plan


def mad_normalizer(values: np.ndarray) -> tuple[float, float]:
    """Robust location/scale: median center, MAD scaled to match a normal
    distribution's standard deviation (1.4826 = 1/Φ⁻¹(3/4))."""
    center = np.nanmedian(values)
    return center, 1.4826 * np.nanmedian(np.abs(values - center))


def classify_beads(
    z: np.ndarray, cat_codes: np.ndarray, activate_nor: bool, tristate: float
) -> np.ndarray:
    """Vectorized chromatin typing: threshold the z-score where it is
    defined, fall back to the cytogenetic category where it is NaN
    (centromere → B; NOR → A when activated else B; otherwise u)."""
    scored = np.select([z > tristate, z < -tristate], [TYPE_A, TYPE_B], TYPE_U)
    nor_type = TYPE_A if activate_nor else TYPE_B
    fallback = np.select(
        [cat_codes == int(CytoCat.CEN), cat_codes == int(CytoCat.NOR)],
        [TYPE_B, nor_type],
        TYPE_U,
    )
    return np.where(np.isnan(z), fallback, scored)


def compose_tags(
    cat_codes: np.ndarray, types: np.ndarray, activate_nor: bool
) -> np.ndarray:
    """Per-bead tag strings: optional category tag, then the type letter."""
    nor_tag = ("anor," if activate_nor else "bnor,")
    prefix = np.select(
        [cat_codes == int(CytoCat.CEN), cat_codes == int(CytoCat.NOR)],
        [_CEN_TAG, nor_tag],
        "",
    )
    return np.char.add(prefix.astype(str), TYPE_LETTERS[types])


def smooth_scores(scores: pd.Series, window: int) -> np.ndarray:
    """Centered rolling mean with partial windows at chromosome edges."""
    return scores.rolling(window=window, center=True, min_periods=1).mean().values


def annotate_chain(
    chain: ChainSpec,
    track: pd.DataFrame,
    genome_normalizer: tuple[float, float],
    tristate: float,
    smooth_window: int,
) -> pd.DataFrame:
    scores = smooth_scores(track["score"], smooth_window)
    if chain.scheme == SCHEME_OWN:
        center, scale = mad_normalizer(scores)
    elif chain.scheme == SCHEME_ALL_B:
        # -inf z-score forces B wherever the score is defined; NaN scores
        # still take the cytogenetic fallback (reference semantics).
        center, scale = np.inf, 1.0
    else:
        center, scale = genome_normalizer

    with np.errstate(invalid="ignore"):
        z = (scores - center) / scale
    cat_codes = np.array([int(c) for c in track["cat"].values], dtype=np.int8)
    types = classify_beads(z, cat_codes, chain.activate_nor, tristate)

    return pd.DataFrame(
        {
            "chain": chain.name,
            "start": track["start"].values,
            "end": track["end"].values,
            "A": TYPE_PARAMS[types, 0],
            "B": TYPE_PARAMS[types, 1],
            "tags": compose_tags(cat_codes, types, chain.activate_nor),
        }
    )


def main(
    *,
    tristate: float = 0,
    activate_nor: list[str] = [],
    extend_nor: bool = False,
    smooth_window: int = 10,
    output_filename: str,
    nci_filename: str,
    band_filename: str,
):
    nci_table = pd.read_csv(nci_filename, sep="\t")
    band_table = load_cyto_band(band_filename)
    beads = attach_cyto_category(nci_table, band_table, extend_nor=extend_nor)

    chains = plan_diploid_chains(list(beads["chrom"].unique()), activate_nor)

    # The genome-wide normalizer is computed on the raw (unsmoothed) scores
    # of every chromosome except chrX, whose skewed distribution would bias
    # the autosomal A/B threshold.
    genome_normalizer = mad_normalizer(
        beads.loc[beads["chrom"] != "chrX", "score"].values
    )

    by_chrom = {chrom: grp for chrom, grp in beads.groupby("chrom", sort=False)}
    tracks = [
        annotate_chain(
            chain, by_chrom[chain.chrom], genome_normalizer, tristate, smooth_window
        )
        for chain in chains
    ]
    table = pd.concat(tracks, ignore_index=True)
    table.to_csv(output_filename, sep="\t", float_format="%g", index=False)


def parse_args() -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tristate", type=float)
    parser.add_argument("--activate-nor", type=str)
    parser.add_argument("--extend-nor", action="store_true", default=None)
    parser.add_argument("--smooth-window", type=int)
    parser.add_argument("--nci", dest="nci_filename", required=True)
    parser.add_argument("--band", dest="band_filename", required=True)
    parser.add_argument("--output", dest="output_filename", required=True)
    args = vars(parser.parse_args())
    if args.get("activate_nor"):
        args["activate_nor"] = args["activate_nor"].split(",")
    return remove_none(args)


if __name__ == "__main__":
    invoke_main(main, parse_args(), LOG)
