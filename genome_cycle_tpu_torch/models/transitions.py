"""Structure transitions between stages (host-side, numpy/scipy).

Re-design of ``stage_transition/`` (SURVEY.md §2.6):

- :func:`transition_interphase`: telophase coarse structure -> spline-refined
  interphase initial structure at /stages/relaxation/0/positions.
- :func:`transition_prometaphase`: final interphase frame -> coarse-grained
  chromatids + displaced sisters at /stages/prometaphase/0/positions
  (implicitly models S/G2/prophase replication).
- :func:`transition_cycle`: across two trajectory files — target chromatids
  of the previous metaphase plate become the next cycle's anaphase initial
  structure (the cell-cycle memory hand-off).
"""

from __future__ import annotations

import numpy as np

from ..store import SimulationStore
from ..utils.spline import resample_chain


def transition_interphase(store: SimulationStore, log=print):
    """transition_interphase.cpp:44-84."""
    log("Refining structure... ")
    telophase_design = store.load_anatelophase_design()
    interphase_design = store.load_interphase_design()

    store.set_stage("telophase")
    steps = store.load_steps()
    if not steps:
        raise RuntimeError("no telophase frames to refine")
    telophase_positions = store.load_positions(steps[-1])

    n = interphase_design.particle_count
    interphase_positions = np.zeros((n, 3))

    for telo_chain, inter_chain in zip(
        telophase_design.chains, interphase_design.chains
    ):
        interphase_positions[inter_chain.start : inter_chain.end] = resample_chain(
            telophase_positions[telo_chain.start : telo_chain.end],
            inter_chain.end - inter_chain.start,
        )

    # Nucleolar particles start exactly at their NOR bead position
    # (transition_interphase.cpp:76-78).
    for nor, nuc in interphase_design.nucleolar_bonds:
        interphase_positions[nuc] = interphase_positions[nor]

    store.set_stage("relaxation")
    store.save_positions(0, interphase_positions)
    log("OK")


def transition_prometaphase(store: SimulationStore, log=print):
    """transition_prometaphase.cpp:44-105."""
    log("Coarse-graining structure... ")
    config = store.load_config()
    interphase_design = store.load_interphase_design()
    prometaphase_design = store.load_prometaphase_design()

    store.set_stage("interphase")
    steps = store.load_steps()
    if not steps:
        raise RuntimeError("no interphase frames to coarse-grain")
    interphase_positions = store.load_positions(steps[-1])

    n = prometaphase_design.particle_count
    prometaphase_positions = np.zeros((n, 3))

    m = config.mitotic_phase
    spindle_axis = np.asarray(m.spindle_axis)
    sister_displacement = (
        -m.sister_separation * spindle_axis / np.linalg.norm(spindle_axis)
    )
    cg = m.coarse_graining

    for chrom_index, source_chain in enumerate(interphase_design.chains):
        target_index, sister_index = prometaphase_design.sister_chromatids[chrom_index]
        target_chain = prometaphase_design.chains[target_index]
        sister_chain = prometaphase_design.chains[sister_index]
        coarse_length = target_chain.end - target_chain.start
        source_length = source_chain.end - source_chain.start

        for offset in range(coarse_length):
            source_start = source_chain.start + cg * offset
            source_end = min(source_start + cg, source_start + source_length)
            centroid = interphase_positions[source_start:source_end].mean(axis=0)
            prometaphase_positions[target_chain.start + offset] = centroid
            prometaphase_positions[sister_chain.start + offset] = (
                centroid + sister_displacement
            )

    store.set_stage("prometaphase")
    store.save_positions(0, prometaphase_positions)
    log("OK")


def transition_cycle(prev: SimulationStore, next_store: SimulationStore, log=print):
    """transition_cycle.cpp:25-76: daughter-cell hand-off across files."""
    log("Copying into a daughter cell... ")
    metaphase_design = prev.load_prometaphase_design()
    anaphase_design = next_store.load_anatelophase_design()
    config = next_store.load_config()

    prev.set_stage("prometaphase")
    steps = prev.load_steps()
    if not steps:
        raise RuntimeError("no prometaphase frames in the previous cycle")
    metaphase_positions = prev.load_positions(steps[-1])

    n = anaphase_design.particle_count
    anaphase_positions = np.zeros((n, 3))

    # The target chromatid's pole becomes the new origin.
    displacement = -np.asarray(config.mitotic_phase.spindle_axis)

    for chrom_index, anaphase_chain in enumerate(anaphase_design.chains):
        target_index, _ = metaphase_design.sister_chromatids[chrom_index]
        metaphase_chain = metaphase_design.chains[target_index]
        length = metaphase_chain.end - metaphase_chain.start
        anaphase_positions[anaphase_chain.start : anaphase_chain.start + length] = (
            metaphase_positions[metaphase_chain.start : metaphase_chain.end]
            + displacement
        )

    next_store.set_stage("anaphase")
    next_store.save_positions(0, anaphase_positions)
    log("OK")
