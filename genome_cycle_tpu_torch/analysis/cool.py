"""Aggregate simulated contact samples into a cooler matrix.

The port's counterpart of ``genome_cycle_tpu.analysis.cool``: one or more
trajectory stores (ensemble replicas) contribute their COO contact dumps to a
single ``.cool`` dataset whose bin table is reconstructed from the embedded
``chains.tsv`` source, trailing nucleolar particles are exposed as a virtual
chromosome, an optional frame selection restricts which sampled windows
contribute, and the matrix is iteratively balanced at the end.

The stores are read through the port's store views, so a source is a
trajectory's path (an HDF5 file or a directory store) or an open store of
any backend.  The pixel merge and the balancing run on a torch
device (:mod:`.coolio`).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import logging
import re

import numpy as np
import pandas as pd

from .. import resolve_device
from ..store import open_store
from .common import invoke_main, remove_none
from .coolio import Cooler, balance_cooler, merge_pixels, write_cooler

LOG = logging.getLogger()

#: Virtual chromosome name carrying the trailing nucleolar particles, so
#: nucleolus-associated contacts survive into the matrix.  ``dephase`` trims
#: this chain when producing the haploid, experiment-comparable map.
NUCLEOLAR_CHAIN = "nucleoli"

_STAGE = "interphase"


def _opened(source):
    """A path opens read-only (and closes after); an open store is used as
    it is and left open."""
    if isinstance(source, str):
        return open_store(source, "r")
    return contextlib.nullcontext(source)


def bin_table(source) -> pd.DataFrame:
    """Bin table of a trajectory store (a path or an open store).

    Chain beads keep the genomic intervals recorded in the chains.tsv text
    embedded at prepare time (homologs stay distinct chains, exactly as the
    simulation saw them); every particle beyond the chain ranges is a
    nucleolar bead and becomes one fixed-width bin of the virtual
    :data:`NUCLEOLAR_CHAIN`.
    """
    with _opened(source) as store:
        types, _ = store.load_particle_types(_STAGE)
        total_particles = len(types)
        chain_span = max(c.end for c in store.load_chain_assignments(_STAGE))
        chains_tsv = store.load_chains_source()

    chains = pd.read_csv(io.StringIO(chains_tsv), sep="\t")
    genomic = (
        chains.iloc[:chain_span]
        .loc[:, ["chain", "start", "end"]]
        .rename(columns={"chain": "chrom"})
        .astype({"start": np.int64, "end": np.int64})
    )

    width = int((chains["end"] - chains["start"]).max())
    edges = width * np.arange(total_particles - chain_span + 1, dtype=np.int64)
    virtual = pd.DataFrame(
        {"chrom": NUCLEOLAR_CHAIN, "start": edges[:-1], "end": edges[1:]}
    )
    return pd.concat([genomic, virtual], ignore_index=True)


def _frame_steps(steps: list[int], selection) -> list[int]:
    """Steps of the sampled frames, optionally sliced."""
    if selection is None:
        return steps
    chosen: list[int] = []
    for sl in selection:
        chosen.extend(steps[sl])
    return chosen


def iter_contact_chunks(sources, selection=None):
    """Stream contact COO chunks (dicts of numpy columns) across all input
    stores (paths or open stores; an open store's stage is set to
    interphase).

    Only window-boundary frames carry a contacts dataset; other frames are
    skipped silently.  A file that cannot be opened is skipped with a
    warning so one broken ensemble member does not sink the merge.
    """
    for source in sources:
        LOG.info("Ingesting from %s", source)
        try:
            opened = _opened(source)
        except OSError as err:
            LOG.warning(">> Skipping: %s", err)
            continue
        with opened as store:
            store.set_stage(_STAGE)
            for step in _frame_steps(store.load_steps(), selection):
                coo = store.load_contacts(step)
                if coo is None:
                    continue
                yield {"bin1_id": coo[:, 0], "bin2_id": coo[:, 1], "count": coo[:, 2]}


def contact_pixels(sources, selection=None, device=None):
    """The merged contact map of ``sources`` on ``device``: the bin table
    (from the first source) and the sorted upper-triangle pixels
    (:func:`.coolio.merge_pixels`)."""
    bins = bin_table(sources[0])
    return (bins,) + merge_pixels(iter_contact_chunks(sources, selection), len(bins), device)


def main(*, output: str, frames=None, input_sims: list, no_balancing=False, device=None):
    device = resolve_device(device)
    bins, bin1, bin2, counts = contact_pixels(input_sims, frames, device)
    LOG.info("Bins: %d", len(bins))
    write_cooler(output, bins, bin1, bin2, counts)
    if not no_balancing:
        LOG.info("Balancing contact matrix")
        balance_cooler(Cooler(output), store=True, device=device)


_RANGE_TOKEN = re.compile(r"^(\d+)(-(\d*))?$")


def parse_frame_ranges(spec: str) -> list[slice]:
    """Frame-selection grammar: ``"100,200-300,400-"`` selects frame 100,
    frames 200..300 inclusive, and everything from 400 on."""
    selection: list[slice] = []
    for token in spec.split(","):
        m = _RANGE_TOKEN.match(token.strip())
        if m is None:
            raise ValueError(f"bad frame range {token!r}")
        first = int(m.group(1))
        if m.group(2) is None:
            selection.append(slice(first, first + 1))
        elif m.group(3) == "":
            selection.append(slice(first, None))
        else:
            selection.append(slice(first, int(m.group(3)) + 1))
    return selection


def add_device_argument(parser: argparse.ArgumentParser):
    parser.add_argument(
        "--device", default=None,
        help="torch device of the numerics (default: the first CUDA card; "
        "'cpu' must be asked for explicitly)",
    )


def parse_args(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Collect contact samples from simulation trajectories"
    )
    parser.add_argument(
        "--output", metavar="sim.cool", required=True,
        help="cooler dataset to create",
    )
    parser.add_argument(
        "--frames", metavar="300-500,600",
        help="restrict to these sampled frames (see parse_frame_ranges)",
    )
    parser.add_argument(
        "--no-balancing", action="store_true", default=None,
        help="skip matrix balancing",
    )
    add_device_argument(parser)
    parser.add_argument(
        "input_sims", metavar="sim.h5", nargs="+",
        help="trajectory stores (ensemble replicas merge)",
    )
    options = vars(parser.parse_args(argv))
    if options.get("frames"):
        options["frames"] = parse_frame_ranges(options["frames"])
    return remove_none(options)


if __name__ == "__main__":
    invoke_main(main, parse_args(), LOG)
