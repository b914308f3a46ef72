"""Cytogenetic-band classification of genomic bins.

The chain designer needs to know, for every NCI bin, whether it falls in a
heterochromatic Giemsa band, a centromere, or an rDNA stalk (NOR).  This
module turns a UCSC ``cytoBand.txt`` table into that per-bin category track.

Behavior matches the reference pipeline (``src/pkg/annotate/cyto.py`` in
snsinfu/3d-genome-cycle): a bin is categorized only when a band fully
contains it, gpos bands of any intensity count as heterochromatin, ``acen``
is centromere, ``stalk`` is NOR, and the optional NOR-arm extension promotes
the entire short arm of a stalk-bearing chromosome to NOR.  The machinery is
original: instead of an in-memory SQL join plus per-chromosome Python loops,
bins and bands meet in a single ``pandas.merge_asof`` pass and the arm
extension is a grouped cumulative-max scan.

The port's copy of ``genome_cycle_tpu.analysis.cyto`` (host code).
"""

from __future__ import annotations

import enum
import logging

import numpy as np
import pandas as pd

LOG = logging.getLogger(__name__)


class CytoCat(enum.IntEnum):
    """Structural category of a genomic bin, ordered by priority none < het
    < cen < nor (the integer codes are internal; rows carry the enum)."""

    NONE = 0
    HET = 1
    CEN = 2
    NOR = 3


# Stain keyword -> category.  Giemsa-positive bands of every recorded
# intensity are treated as heterochromatic; gneg/gvar/other stains fall
# through to NONE.
_STAIN_CODES: dict[str, int] = {"acen": int(CytoCat.CEN), "stalk": int(CytoCat.NOR)}
for _level in (25, 33, 50, 66, 75, 100):
    _STAIN_CODES[f"gpos{_level}"] = int(CytoCat.HET)

#: Column layout of UCSC cytoBand.txt (goldenPath/hg38/database/cytoBand.txt.gz).
BAND_COLUMNS = ("chrom", "start", "end", "name", "stain")


def load_cyto_band(filename: str) -> pd.DataFrame:
    """Read a UCSC cytoBand table (tab-separated, headerless)."""
    return pd.read_table(filename, header=None, names=list(BAND_COLUMNS))


def _containing_band_codes(bins: pd.DataFrame, bands: pd.DataFrame) -> np.ndarray:
    """Category code of the band fully containing each bin (0 when none).

    Bands tile each chromosome without overlap, so the candidate band for a
    bin is the last one starting at or before the bin's start; an as-of merge
    keyed on ``start`` and grouped by chromosome finds it in one pass, and a
    containment check on the end coordinate validates the hit.
    """
    lookup = bands.loc[:, ["chrom", "start", "end"]].copy()
    lookup["code"] = np.array(
        [_STAIN_CODES.get(s, 0) for s in bands["stain"]], dtype=np.int8
    )

    probe = bins.loc[:, ["chrom", "start", "end"]].copy()
    probe["order"] = np.arange(len(probe))

    hits = pd.merge_asof(
        probe.sort_values("start", kind="stable"),
        lookup.sort_values("start", kind="stable"),
        on="start",
        by="chrom",
        suffixes=("", "_band"),
    ).sort_values("order", kind="stable")

    contained = (hits["end"] <= hits["end_band"]).fillna(False).to_numpy()
    codes = hits["code"].fillna(0).to_numpy(dtype=np.int8)
    return np.where(contained, codes, np.int8(0))


def attach_cyto_category(
    nci_table: pd.DataFrame,
    band_table: pd.DataFrame,
    extend_nor: bool = False,
) -> pd.DataFrame:
    """Append a ``cat`` column of :class:`CytoCat` to an NCI bin table."""
    result = nci_table.reset_index(drop=True).copy()
    codes = _containing_band_codes(result, band_table)
    result["cat"] = [CytoCat(int(c)) for c in codes]

    per_chrom_cen = pd.Series(codes == int(CytoCat.CEN)).groupby(
        result["chrom"].to_numpy(), sort=False
    )
    for chrom, any_cen in per_chrom_cen.any().items():
        if not any_cen:
            LOG.warning("No centromere was identified on %s", chrom)
    if not (codes == int(CytoCat.NOR)).any():
        LOG.warning("No NOR was identified")

    return do_extend_nor(result) if extend_nor else result


def do_extend_nor(table: pd.DataFrame) -> pd.DataFrame:
    """Promote the whole p-arm to NOR on stalk-bearing chromosomes.

    The rDNA repeats sit on the short arm of the acrocentric chromosomes;
    when any stalk band was seen before the centromere, the model treats
    everything upstream of the first centromeric bin as nucleolus-organizing.
    Implemented as two grouped scans: a cumulative max marks rows at or after
    each chromosome's first centromere, and a grouped ``any`` finds p-arms
    that carry a NOR.
    """
    chrom_key = table["chrom"].to_numpy()
    cat = pd.Series(table["cat"].to_numpy(object, copy=True))

    past_cen = (cat == CytoCat.CEN).groupby(chrom_key, sort=False).cummax()
    p_arm = ~past_cen
    arm_has_nor = (
        (p_arm & (cat == CytoCat.NOR))
        .groupby(chrom_key, sort=False)
        .transform("max")
    )
    cat[p_arm & arm_has_nor] = CytoCat.NOR
    return table.assign(cat=cat.to_numpy())
