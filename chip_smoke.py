#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``; without a card it exits non-zero and
prints no result.  It

1. names the card (``nvidia-smi``) and the torch/CUDA versions;
2. builds the port's CUDA sources from ``genome_cycle_tpu_torch/csrc`` into
   ``build/``, one ``nvcc`` a source, all at once, and prints what ``ptxas``
   says about their kernels: the pair-force kernel (``ab_pair_forces.cu``);
   the contact tick (``contact_tick.cu``); the rest of a step — bonds, wall,
   update — and the update alone (``step_rest.cu``); the mitotic stages'
   chunk of steps (``mitotic_chunk.cu``); the cell layout (``cell_layout.cu``);
3. holds the kernel's wrapper against its plain PyTorch version on the card:
   at 300 beads, at inputs made for the kernel's control flow, and at three
   structures of the main path's 59,610 particles; checks that two launches
   give the same bits; and times the kernel; the layout kernels
   (``cell_layout.cu``) against their plain version, bit for bit, after G1
   and on the ensemble's four replicas stacked, both timed; then phase "step
   kernels": the tick (also forced to overflow and run again) with the
   half-stencil candidates a row, mean and largest, the rest kernel with its
   wall reaction and the nucleolar rows, the update kernel and the fused G1
   launch against their plain versions at the same three structures and on
   the ensemble's four replicas stacked, timed beside their bounds; 200 G1
   steps at T = 0 through the kernels against the plain composition, step
   for step; and the device kernels a G1 step, a
   relaxation step and a tick start (``torch.profiler``); phase "graph": a
   G1 step as one replay of its CUDA graph against the eager step, in turns,
   at 59,610 and 4 x 59,610 beads, by host clock and CUDA events, the two
   runs equal to the bit;
4. drives the port's main path at full width, a whole cell cycle of the
   diploid hg38 nucleus at 100 kb per bead through the entry points the CLI
   command ``cycles`` chains — ``run_prepare``, ``run_anatelophase``,
   ``transition_interphase``, ``run_interphase`` (59,610 particles),
   ``transition_prometaphase``, ``run_prometaphase``, all on the card — with
   the depth cut (``CONFIG`` below), and checks what every stage wrote and
   that the mitotic stages launched the chunk kernel once a
   ``sampling_interval`` and wrote each frame but a stage's last while the
   next chunk ran, and the update kernel only in the relaxation, and
   that at least 99 % of the G1 steps ran as CUDA graph replays; then
   phase "mitotic kernel": the chunk kernel against its plain version at the
   three mitotic phases' start structures of that cycle (576, 576 and 1,152
   beads), timed against the eager step and the
   plain version in turns, and the T > 0 statistics of the kernel's runs
   against the eager step's (see MITOTIC_TOLERANCE);
5. hands the metaphase over to a second cell (``transition_cycle``), runs a
   short anaphase there and checks that it started from the hand-off;
6. runs an ensemble of four replicas of the nucleus (4 x 59,610 particles,
   ``run_ensemble_interphase``) in lock-step after a short anatelophase each,
   checks every replica's trajectory and that the pair kernel was launched once
   a step for all four, holds the kernel on the replica-stacked layout against
   its plain version and against four single-replica launches, and times it
   against them in turns;
7. phase "analysis": the analysis chain on the ensemble's contact windows, on
   the card — ``cool`` over the four replicas (59,610 bins), ICE,
   ``dephase`` (30,860 haploid bins), ICE, the dense float32 haploid map,
   O/E and PC1 — each step held against the same function on the host (PC1
   on the first three chromosomes' block), timed, the power step against its
   bound;
8. phase "shards": the multi-device paths as two ranks that share the card
   (gloo; NCCL across cards cannot run on one card), from the main cycle's
   relaxed structure, each against the single-device run: (a) one halo
   step's forces and wall reaction; (b) the first tick's window; (c) 2,000
   G1 steps through ``run_interphase(mesh=...)``, statistics within 1 %; the
   replicated-position engine (one step's forces, then 200 steps); the
   ensemble over the ranks against one process; every rank's local layout
   (padded rows, home range) against the plain pair force; the kernel's
   launches on every rank;
9. phase "store": the port's CLI as a user runs it (``prepare``,
   ``anatelophase``, ``transition interphase``, ``interphase``, each its own
   process) into a directory store, which needs no h5py; the interphase is
   killed (SIGKILL) once its first checkpoint is complete and run again: it
   must resume there and write every G1 frame and window once;
10. phase "gate": the port's statistical gate against the C++ surrogate
   (``tests/test_torch_correlation.py``, both configurations, each replica
   set in one stacked run through the kernels, one pair-kernel and one
   rest-kernel launch a step for all replicas; the surrogate built with
   ``g++``);
11. prints the card line, a ``{"kernels": [...]}`` line and, last, the result
   line ``{"ok": true, "device": {...}}``.

Any failed phase ends the run with a non-zero exit code.

    python3 chip_smoke.py --production [--g1-steps N | --seconds S] [--output DIR]

runs instead the reference-default cell cycle (``examples/config_production.json``,
59,610 particles, seed 1) through ``python -m genome_cycle_tpu_torch.production``
into a scratch directory, keeps ``summary.json``, ``pc1.tsv``, ``aux.json``
and the log in ``--output`` (default ``build/production/``), and checks the
trajectory (every stage's frames, 701 G1 frames and 71 windows at full depth), each window's
counts against its ticks' events, the kernels against their plain versions
at late-G1 structures (the chunk kernel at the mitotic phases' start
structures), the launches, and the counts against the JAX package's run of
the same workload.  ``--g1-steps`` cuts the G1 (the only cut; the JAX counts then do not
apply); ``--seconds`` cuts it to what fits that many seconds, by a short
calibration run.  At full depth it needs an hour or more of the card.
"""

import argparse
import dataclasses
import io
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import pandas as pd
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

CHAINS = os.path.join(ROOT, "examples", "hg38_chains_100kb.tsv")
# Depth cut from the production schedule's 200,000 anaphase, 50,000 telophase,
# 10,000 relaxation, 700,000 G1 and 400,000 prometaphase steps; every other
# field at its default, the width (59,610 particles, 576 coarse beads, 1,152
# with sisters) uncut.  The kinetochore fibers relax in 10,000 steps (decay
# rate 1, timestep 1e-4), so 40,000 anaphase steps bring the chromosomes to
# the pole; the packing well acts on every bead ten times faster.
CONFIG = {"mitotic_phase": {"anaphase_steps": 40000, "telophase_steps": 10000,
                            "prometaphase_steps": 10000},
          "interphase": {"steps": 10000, "relaxation_steps": 2000,
                         "contactmap_output_window": 5}}
# The second cell runs only far enough to show that it started from the
# hand-off.
CONFIG_NEXT = {"mitotic_phase": {"anaphase_steps": 2000, "telophase_steps": 1000}}
# The ensemble: four replicas, seeds SEED + 10 + k, each from a short
# anatelophase of its own; a window every two G1 frames.  6,000 telophase
# steps pack the beads to within about 1.9 of the origin, as CONFIG's 10,000
# do (after 1,000 the farthest lies 3.7 out, the wall at 2.0), and the
# relaxation is as long as CONFIG's: with 4,000 and 1,000 a bead of one
# replica still lay outside the wall's margin when G1 began.
REPLICAS = 4
CONFIG_ENSEMBLE = {"mitotic_phase": {"anaphase_steps": 2000, "telophase_steps": 6000},
                   "interphase": {"steps": 4000, "relaxation_steps": 2000,
                                  "contactmap_output_window": 2}}
# Phase "shards": two ranks that share the one card.  G1 from the main cycle's
# relaxed structure (no relaxation of its own), a frame and a window every
# 1,000 steps; the ensemble over the ranks 2 replicas of 400 steps, a frame
# every 100; the replicated-position engine 200 steps.  The replicated
# engine's and the ensemble's positions lie within TWIN_FACTOR times the
# distance float32 rounding alone puts between two single-process runs over
# the same steps (the twin: the same run on a layout whose blocks sum each
# bead's pair terms in another order), measured in the same call; each of
# the ensemble's windows differs in at most 1 % of rows from the same
# replica's window in the one-process ensemble, run in either order of the
# replicas (at T = 1 the two orders alone put 1.03 % of a window's rows
# apart in 400 steps, and the ranks' run matched one of them to the row).
SHARD_RANKS = 2
CONFIG_SHARDS = {"interphase": {"steps": 2000, "relaxation_steps": 0,
                                "contactmap_output_window": 1}}
CONFIG_SHARDS_ENSEMBLE = {"interphase": {"steps": 400, "relaxation_steps": 0,
                                         "sampling_interval": 100,
                                         "contactmap_output_window": 2}}
REPLICATED_STEPS = 200
TWIN_FACTOR = 10.0
# Phase "store": the port's CLI into a directory store, the interphase killed
# (SIGKILL) once its first checkpoint is complete and run again.  The
# ensemble's mitotic and relaxation depths: after 1,000 telophase and 1,000
# relaxation steps a bead still lay 1.6 scaled radii outside the wall when G1
# began.
CONFIG_STORE = {"mitotic_phase": {"anaphase_steps": 2000, "telophase_steps": 6000},
                "interphase": {"steps": 6000, "relaxation_steps": 2000,
                               "contactmap_output_window": 2}}
STORE_RESUME_STEP = 2000
# The hand-written kernels whose launches the port counts
# (``launch.<kernel>``, ``genome_cycle_tpu_torch/utils/tracing.py``).
KERNELS = ("ab_pair_forces", "contact_tick", "step_rest", "bd_update", "mitotic_chunk",
           "cell_layout")
# Runs a module as ``python -m`` does, then prints the launches of the pair
# kernel and of the step kernels in that process (the counts a subprocess
# cannot hand back otherwise).
LAUNCHER = ("import json, runpy, sys\n"
            "from genome_cycle_tpu_torch.utils import tracing\n"
            "sys.argv = sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n"
            "finally:\n"
            "    counts = {k: tracing.counters().get('launch.' + k, 0)\n"
            f"              for k in {KERNELS!r}}}\n"
            "    print(f\"launches {counts.pop('ab_pair_forces')}\", flush=True)\n"
            "    print('step kernel launches ' + json.dumps(counts), flush=True)\n")
# `--production`: the reference defaults (examples/config_production.json)
# into a scratch directory outside the output directory, which keeps
# summary.json, pc1.tsv, aux.json and the log.  G1 frames whose structures the
# kernel is held at (core scale 0.93, 1.00, 1.00); a cut G1 takes 100,000, its
# middle and its end.
PRODUCTION_CONFIG = os.path.join(ROOT, "examples", "config_production.json")
PRODUCTION_OUTPUT = os.path.join(ROOT, "build", "production")
PRODUCTION_G1_STEPS = 700000
LATE_G1_FRAMES = (100000, 350000, 700000)
# `--production --seconds S` cuts the G1 to the deepest multiple of 10,000
# steps that lets the whole script end within S seconds, from the rates of a
# short calibration run on this card and host (CALIBRATION_CONFIG), each
# taken at RATE_MARGIN of its reading: the anaphase and telophase at the
# slower of their two rates, the prometaphase, the relaxation and the G1 at
# theirs.
# PRODUCTION_OVERHEAD_S is held back beyond that for the processes, the
# analysis, the checks (58 s in one run) and the host's drift: a run whose
# plan held nothing back (the G1 at its calibrated rate, which it kept) was
# stopped 50,000 prometaphase steps short.  The production process itself is stopped CHECK_SECONDS before S.
CALIBRATION_CONFIG = {"mitotic_phase": {"anaphase_steps": 2000, "telophase_steps": 6000,
                                        "prometaphase_steps": 6000},
                      "interphase": {"steps": 2000, "relaxation_steps": 2000}}
RATE_MARGIN = 0.85
PRODUCTION_OVERHEAD_S = 300
CHECK_SECONDS = 90
MIN_G1_STEPS = 200000
# The JAX package's run of the same workload (BASELINE.md:184-190): counts,
# not times.  At full depth the port's must lie within JAX_COUNT_SPREAD.
JAX_RUN = {"coo_rows": 227e6, "pixels": 25.1e6, "contact_events": 14.1e9,
           "haploid_map_bins": 30795, "largest_window_rows": 5.8e6, "grid_bound": 5.0}
JAX_COUNT_SPREAD = 0.10
SEED = 1
EXPECTED_PARTICLES = 59610
EXPECTED_COARSE = 576
# hg38 at 100 kb: one canonical copy of each of 24 chromosomes.
EXPECTED_HAPLOID_BINS = 30860

# Limits of the analysis phase, the card against the host.  Pixels must be
# equal.  ICE weights: float64 sums in another order (relative 1e-9), or a
# round apart at the stopping test (tol 1e-5: 1e-5).  PC1: float32 products
# in another order, the iteration stopping at 1e-4 (one step apart at most).
ANALYSIS_WEIGHT_RTOL = 1e-9
ANALYSIS_WEIGHT_RTOL_APART = 1e-5
ANALYSIS_PC1_TOLERANCE = 1e-3
ANALYSIS_MARGINAL_SPREAD = 0.01

# Limits of the mitotic checks.
BOND_LENGTH_BAND = 0.2        # mean chain-bond length within bond_length +- 20 %
ARRIVAL_FRACTION = 0.1        # mean kinetochore-pole distance, end over start
PACKING_MARGIN = 0.75         # beads within telophase_packing_radius + margin
COHESION_BAND = 0.5           # sister distance within +- 50 % of its balance

# Published peaks of one H100 SXM: float32 outside the tensor cores, HBM.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Operations the function needs: the distance test for every ordered candidate
# of the 27-cell stencil (3 differences, r2 in 5, the comparison's product), and
# the two softcore terms, the mixing and the accumulation only for the pairs in
# reach.  35 for every candidate is the count of a kernel that skips nothing.
OPS_DISTANCE_TEST = 9
OPS_IN_REACH = 26
OPS_PER_CANDIDATE = OPS_DISTANCE_TEST + OPS_IN_REACH

FORCE_TOLERANCE = 1e-4   # max|dF| <= tol * max(|F|, 1): sums run in another order
ENERGY_TOLERANCE = 1e-5  # relative


def phase(name, message):
    print(f"[{name}] {message}", flush=True)


def fail(name, message):
    print(f"[{name}] FAILED: {message}", flush=True)
    sys.exit(1)


def time_ms(fn, repeats):
    """Mean milliseconds of ``fn`` on the card by CUDA events, after a warm-up.

    The card first spins for a few milliseconds, so that the host queues the
    calls ahead of it: the events then span the device's work, not the host's
    launch rate, which for a kernel of tens of microseconds is the slower."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(8_000_000)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def kernel_params(core_scale, icfg):
    a_d = icfg.a_core_diameter * core_scale
    b_d = icfg.b_core_diameter * core_scale
    return (icfg.a_core_repulsion, 1.0 / (a_d * a_d),
            icfg.b_core_repulsion, 1.0 / (b_d * b_d))


class Errors:
    """Largest force error seen by `compare`: absolute, and over
    max(|F|, 1) of its input, which is what FORCE_TOLERANCE bounds."""
    max_abs = 0.0
    max_rel = 0.0


def compare(name, layout, params, pk, errors):
    """The kernel against the plain version on the same layout, and against
    itself: two launches must give the same bits.  Fails beyond the stated
    tolerances; `errors` takes the kernel's."""
    f_k, e_k = pk.ab_pair_forces(layout, params, with_energy=True)
    f_again, e_again = pk.ab_pair_forces(layout, params, with_energy=True)
    f_only, _ = pk.ab_pair_forces(layout, params, with_energy=False)
    f_only_again, _ = pk.ab_pair_forces(layout, params, with_energy=False)
    torch.cuda.synchronize()
    f_p, e_p = pk.ab_pair_forces_reference(layout, params, with_energy=True)
    torch.cuda.synchronize()
    if not (torch.equal(f_k, f_again) and torch.equal(e_k, e_again)
            and torch.equal(f_only, f_only_again)):
        fail(name, "two launches of the kernel on one layout differ")
    if not torch.equal(f_k, f_only):
        fail(name, "force-only and force+energy kernels disagree")
    fmax = float(f_p.abs().max())
    e_p = float(e_p)
    e = float(e_k)
    err = float((f_k - f_p).abs().max())
    e_rel = abs(e - e_p) / max(abs(e_p), 1e-30) if e_p else abs(e)
    phase(name, f"kernel: n={layout.n} max|dF|={err:.3e} max|F|={fmax:.3e} "
                f"E={e:.6e} plain E={e_p:.6e} rel={e_rel:.2e}")
    if not np.isfinite(err) or err > FORCE_TOLERANCE * max(fmax, 1.0):
        fail(name, f"kernel: force error {err} beyond {FORCE_TOLERANCE} * max(|F|, 1)")
    if not e_rel <= ENERGY_TOLERANCE:
        fail(name, f"kernel: energy differs by {e_rel} relative, limit {ENERGY_TOLERANCE}")
    errors.max_abs = max(errors.max_abs, err)
    errors.max_rel = max(errors.max_rel, err / max(fmax, 1.0))


def small_inputs(pk, device):
    """The inputs of the JAX package's kernel test: 300 random beads at core
    scales 0.5 and 1.0, and four beads in the corner cells of the grid."""
    rng = np.random.default_rng(1234)
    n = 300
    x = torch.as_tensor(rng.uniform(-0.9, 0.9, (n, 3)), dtype=torch.float32, device=device)
    af = torch.as_tensor(rng.uniform(0, 1, n), dtype=torch.float32, device=device)
    layout = pk.build_cell_layout(x, af, 1.0 - af, bound=1.2, cell=0.3)
    cases = []
    for core_scale in (0.5, 1.0):
        a_d, b_d = 0.3 * core_scale, 0.24 * core_scale
        cases.append((f"300 beads, core scale {core_scale}", layout,
                      (2.5, 1 / (a_d * a_d), 2.5, 1 / (b_d * b_d))))
    corners = torch.tensor(
        [[-1.15, -1.15, -1.15], [1.15, 1.15, 1.15], [1.15, -1.15, 1.15],
         [-1.1, -1.1, -1.1]], dtype=torch.float32, device=device)
    ones = torch.ones(4, device=device)
    full = (2.5, 1 / 0.09, 2.5, 1 / 0.0576)
    cases.append(("boundary cells", pk.build_cell_layout(
        corners, ones, torch.zeros(4, device=device), bound=1.2, cell=0.3), full))

    # Made for the kernel's control flow: one cell with more beads than a
    # block owns and more than one tile of candidates beside spread beads, a
    # grid that is a single cell, a single bead.
    def layout_of(x, bound):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        af = torch.as_tensor(rng.uniform(0, 1, len(x)), dtype=torch.float32, device=device)
        return pk.build_cell_layout(x, af, 1.0 - af, bound=bound, cell=0.3)

    crowd = np.concatenate([rng.uniform(0.02, 0.27, (3000, 3)),
                            rng.uniform(-1.1, 1.1, (300, 3))])
    cases.append(("3,000 beads in one cell beside 300", layout_of(crowd, 1.2), full))
    cases.append(("single-cell grid", layout_of(rng.uniform(-0.1, 0.1, (700, 3)), 0.1), full))
    cases.append(("one bead", layout_of(np.zeros((1, 3)), 1.2), full))
    return cases


def open_store(workdir, name, config, seed):
    """``run_prepare`` of the production nucleus with ``config`` into an HDF5
    file, or into a ``MemoryStore`` (same schema, no file) without h5py."""
    from genome_cycle_tpu_torch.models.prepare import run_prepare
    from genome_cycle_tpu_torch.store import MemoryStore, SimulationStore

    config_path = os.path.join(workdir, name + ".json")
    with open(config_path, "w") as f:
        json.dump(config, f)
    try:
        import h5py  # noqa: F401
        target = os.path.join(workdir, name + ".h5")
    except ImportError:
        target = MemoryStore()
    run_prepare(target, config_path, CHAINS, seed=seed, log=lambda m: phase("prepare", m))
    return SimulationStore(target) if isinstance(target, str) else target


def prepare_nucleus(workdir, device, timings=None):
    """The production nucleus up to the start of the relaxation, by the
    port's own stages at ``CONFIG``'s depth: prepare, anaphase and telophase
    on ``device``, transition to interphase.  Returns (store, config)."""
    from genome_cycle_tpu_torch.models.anatelophase import run_anatelophase
    from genome_cycle_tpu_torch.models.transitions import transition_interphase

    run_log = lambda m: phase("run", m.replace("\t", " "))
    store = open_store(workdir, "cell_0", CONFIG, SEED)
    run_anatelophase(store, log=run_log, device=device, timings=timings)
    transition_interphase(store, log=run_log)
    return store, store.load_config()


def time_in_turns(first, second, repeats):
    """Mean milliseconds of two functions timed first, second, second, first,
    so that a drift of the card's clock falls on both alike."""
    a1, b1 = time_ms(first, repeats), time_ms(second, repeats)
    b2, a2 = time_ms(second, repeats), time_ms(first, repeats)
    return 0.5 * (a1 + a2), 0.5 * (b1 + b2)


def stage_frames(store, stage, steps, interval, n):
    """The frames of a mitotic stage: at the expected steps, of the expected
    shape, finite.  Returns them as a list."""
    store.set_stage(stage)
    found = store.load_steps()
    if found != list(range(0, steps + 1, interval)):
        fail("check", f"{stage} frames {found}")
    frames = [store.load_positions(step) for step in found]
    for step, x in zip(found, frames):
        if x.shape != (n, 3) or not np.isfinite(x).all():
            fail("check", f"{stage} positions at step {step}: shape {x.shape} or not finite")
    return frames


def check_bond_length(stage, x, chains, m):
    """Mean distance of consecutive beads of a chain against bond_length."""
    lengths = np.concatenate([
        np.linalg.norm(np.diff(x[c.start:c.end], axis=0), axis=1) for c in chains])
    mean = float(lengths.mean())
    phase("check", f"{stage}: mean chain-bond length {mean:.4f} "
                   f"(bond_length {m.bond_length} +- {BOND_LENGTH_BAND:.0%}), longest {lengths.max():.3f}")
    if abs(mean - m.bond_length) > BOND_LENGTH_BAND * m.bond_length:
        fail("check", f"{stage}: mean chain-bond length {mean}")


def check_anatelophase(store, m):
    """Anaphase: the kinetochores arrive at the shifted pole.  Telophase: the
    packing well holds every bead."""
    design = store.load_anatelophase_design()
    n = design.particle_count
    kinetochores = [c.kinetochore for c in design.chains if c.kinetochore is not None]
    pole = np.asarray(m.anaphase_spindle_shift)
    anaphase = stage_frames(store, "anaphase", m.anaphase_steps, m.sampling_interval, n)
    start, end = (float(np.linalg.norm(x[kinetochores] - pole, axis=1).mean())
                  for x in (anaphase[0], anaphase[-1]))
    phase("check", f"anaphase: {n} beads, {len(kinetochores)} kinetochores; mean "
                   f"kinetochore-pole distance {start:.3f} -> {end:.3f} "
                   f"({end / start:.4f} of its start, limit {ARRIVAL_FRACTION})")
    if not end < ARRIVAL_FRACTION * start:
        fail("check", "the kinetochores did not arrive at the pole")
    check_bond_length("anaphase", anaphase[-1], design.chains, m)
    telophase = stage_frames(store, "telophase", m.telophase_steps, m.sampling_interval, n)
    if not np.array_equal(telophase[0], anaphase[-1]):
        fail("check", "telophase does not start from the last anaphase frame")
    reach = float(np.linalg.norm(telophase[-1], axis=1).max())
    phase("check", f"telophase: farthest bead {reach:.3f} from the origin (packing radius "
                   f"{m.telophase_packing_radius} + {PACKING_MARGIN}), from "
                   f"{np.linalg.norm(telophase[0], axis=1).max():.3f} at its start")
    if reach > m.telophase_packing_radius + PACKING_MARGIN:
        fail("check", "a telophase bead lies outside the packing well")
    check_bond_length("telophase", telophase[-1], design.chains, m)
    return telophase[-1]


def check_prometaphase(store, m):
    """Sister kinetochores stay together under the pull of the two fibers,
    and each faces its own pole."""
    design = store.load_prometaphase_design()
    n = design.particle_count
    frames = stage_frames(store, "prometaphase", m.prometaphase_steps, m.sampling_interval, n)
    x = frames[-1]
    pairs = [(design.chains[t], design.chains[s]) for t, s in design.sister_chromatids]
    pairs = [(t, s) for t, s in pairs if t.kinetochore is not None and s.kinetochore is not None]
    target = x[[t.kinetochore for t, _ in pairs]]
    sister = x[[s.kinetochore for _, s in pairs]]
    target_pole, sister_pole = design.pole_positions
    distance = float(np.linalg.norm(target - sister, axis=1).mean())
    # Each fiber pulls its kinetochore with K |r - pole|, K = decay rate x
    # chain length / mobility; the cohesion spring (bond_spring) carries it.
    pull = np.asarray([
        m.kfiber_decay_rate_prometaphase * (t.end - t.start) / m.core_mobility
        * np.linalg.norm(target_pole) for t, _ in pairs])
    balance = m.sister_separation + float(pull.mean()) / m.bond_spring
    nearer = float((np.linalg.norm(sister - target_pole, axis=1)
                    - np.linalg.norm(target - target_pole, axis=1)).mean())
    phase("check", f"prometaphase: {n} beads, {len(pairs)} sister pairs; mean sister-kinetochore "
                   f"distance {distance:.4f} (sister_separation {m.sister_separation}, with the "
                   f"fibers' pull over the cohesion spring {balance:.4f} +- {COHESION_BAND:.0%}); "
                   f"targets nearer the target pole than their sisters by {nearer:.4f} on average; "
                   f"plate at y = {x[:, 1].mean():.3f}")
    if abs(distance - balance) > COHESION_BAND * balance:
        fail("check", f"sister kinetochores {distance} apart")
    if not nearer > 0:
        fail("check", "target kinetochores do not face the target pole")
    check_bond_length("prometaphase", x, design.chains, m)
    return x


def check_hand_off(prev, nxt, m):
    """The second cell's anaphase starts from the first cell's target
    chromatids, moved by -spindle_axis, not from rods."""
    metaphase = prev.load_prometaphase_design()
    design = nxt.load_anatelophase_design()
    prev.set_stage("prometaphase")
    last = prev.load_positions(prev.load_steps()[-1])
    want = np.zeros((design.particle_count, 3))
    for k, chain in enumerate(design.chains):
        source = metaphase.chains[int(metaphase.sister_chromatids[k][0])]
        want[chain.start:chain.end] = last[source.start:source.end] - np.asarray(m.spindle_axis)
    frames = stage_frames(nxt, "anaphase", CONFIG_NEXT["mitotic_phase"]["anaphase_steps"],
                          m.sampling_interval, design.particle_count)
    error = float(np.abs(frames[0] - want).max())
    moved = float(np.abs(frames[-1] - frames[0]).max())
    phase("check", f"hand-off: frame 0 of the second cell's anaphase is the first cell's target "
                   f"chromatids - spindle_axis to {error:.2e}; the anaphase moved them by "
                   f"up to {moved:.3f}")
    if error > 1e-3 or not moved > 0:
        fail("check", "the second cell did not start from the hand-off")


def check_output(store, model_n, icfg):
    steps, relax_steps = icfg.steps, icfg.relaxation_steps
    window_steps = icfg.sampling_interval * icfg.contactmap_output_window
    store.set_stage("relaxation")
    frames = store.load_steps()
    if frames != list(range(0, relax_steps + 1, icfg.relaxation_sampling_interval)):
        fail("check", f"relaxation frames {frames}")
    relaxed = store.load_positions(frames[-1])
    store.set_stage("interphase")
    frames = store.load_steps()
    if frames != list(range(0, steps + 1, icfg.sampling_interval)):
        fail("check", f"G1 frames {frames}")
    for step in frames:
        x = store.load_positions(step)
        ctx = store.load_interphase_context(step)
        axes = np.asarray(ctx.wall_semiaxes)
        if x.shape != (model_n, 3) or not np.isfinite(x).all():
            fail("check", f"positions at step {step}: shape {x.shape} or not finite")
        if not (np.isfinite(axes).all() and (axes > 0).all()):
            fail("check", f"semiaxes at step {step}: {axes}")
        # Scaled radius 1 is the wall; 0.5 outside it along the shortest axis.
        reach = np.sqrt(np.sum((x / (axes + 0.5)) ** 2, axis=1)).max()
        if reach > 1.0:
            fail("check", f"a bead lies {reach:.3f} scaled radii out at step {step}")
        if not np.isfinite(ctx.mean_energy):
            fail("check", f"mean energy at step {step} is {ctx.mean_energy}")
    for step in range(0, steps + 1, window_steps):
        coo = store.load_contacts(step)
        if coo is None or len(coo) == 0:
            fail("check", f"no contact window at step {step}")
        i, j, count = (coo[:, k].astype(np.int64) for k in range(3))
        key = (i << 32) | j
        if not ((i < j).all() and (count >= 1).all() and (np.diff(key) > 0).all()
                and j.max() < model_n and i.min() >= 0):
            fail("check", f"contact window at step {step} is malformed")
        phase("check", f"contact window at step {step}: {len(coo)} pairs, "
                       f"{int(count.sum())} events")
    if store.load_checkpoint() is not None:
        fail("check", "checkpoint not cleared at the end of the stage")
    return relaxed, store.load_positions(frames[-1]), ctx


def run_ensemble(workdir, device, run_log):
    """The ensemble phase on the card: R replicas of the nucleus, each through
    a short anatelophase and the transition, then their interphase in
    lock-step.  The kernel's launch count is read around the lock-step run
    alone.  Returns what the checks and the timings need."""
    from genome_cycle_tpu_torch.models.anatelophase import run_anatelophase
    from genome_cycle_tpu_torch.models.transitions import transition_interphase
    from genome_cycle_tpu_torch.parallel.ensemble import run_ensemble_interphase

    stores = []
    for k in range(REPLICAS):
        store = open_store(workdir, f"rep_{k}", CONFIG_ENSEMBLE, SEED + 10 + k)
        run_anatelophase(store, log=run_log, device=device)
        transition_interphase(store, log=run_log)
        store.set_stage("telophase")
        telophase = store.load_positions(store.load_steps()[-1])
        store.set_stage("relaxation")
        phase("ensemble", f"replica {k}: telophase beads within "
                          f"{np.linalg.norm(telophase, axis=1).max():.3f} of the origin, the "
                          f"relaxation's start within "
                          f"{np.linalg.norm(store.load_positions(0), axis=1).max():.3f}")
        stores.append(store)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    counted = kernel_launches()
    final = run_ensemble_interphase(stores, log=run_log, device=device, timings=timings)
    launches = kernel_launches(counted)["ab_pair_forces"]
    peak_bytes = torch.cuda.max_memory_allocated()

    config = stores[0].load_config()
    icfg = config.interphase
    n = stores[0].load_interphase_design().particle_count
    design = stores[0].load_interphase_design()
    steps = icfg.relaxation_steps + icfg.steps
    phase("ensemble", f"{REPLICAS} replicas of {n} particles, {REPLICAS * n} beads in lock-step; "
                      f"kernel launches over the lock-step run: {launches} for {steps} steps")
    if launches != steps:
        fail("ensemble", f"the pair kernel was launched {launches} times in {steps} steps: "
                         "not once a step for all replicas")
    finals, semiaxes = [], []
    for k, store in enumerate(stores):
        _, x_final, ctx = check_output(store, n, icfg)
        semiaxes.append(ctx.wall_semiaxes)
        if not np.allclose(final[k], x_final, rtol=1e-4, atol=1e-4):
            fail("ensemble", f"replica {k}: returned positions differ from its last stored frame")
        phase("ensemble", f"replica {k}: frames, windows, positions and semiaxes are sound; "
                          f"final wall semiaxes {tuple(round(v, 4) for v in ctx.wall_semiaxes)}")
        finals.append(x_final)
    apart = min(float(np.abs(finals[a] - finals[b]).max())
                for a in range(REPLICAS) for b in range(a))
    phase("ensemble", f"final positions of any two replicas differ by up to {apart:.4f} at least")
    if not apart > 1e-2:
        fail("ensemble", "two replicas ended in the same structure")
    return dict(final=np.stack(finals), semiaxes=np.asarray(semiaxes, np.float32),
                launches=launches, peak_bytes=peak_bytes,
                timings=timings, config=config, n=n, design=design, stores=stores)


def check_ensemble_kernel(ensemble, device, pk, errors):
    """The kernel on the replica-stacked layout of the ensemble's last frame:
    against its plain version (`compare`), against a launch for each replica
    on its own layout over the same grid, and timed against those launches in
    turns.  Returns the entry for the kernels line."""
    from genome_cycle_tpu_torch.models.interphase import EngineSettings, InterphaseModel

    config = ensemble["config"]
    icfg = config.interphase
    model = InterphaseModel.from_design(ensemble["design"], config, EngineSettings(), device)
    x = torch.as_tensor(ensemble["final"], dtype=torch.float32, device=device)
    model.update_bound(float(x.abs().max()))
    core, _ = model.scales(icfg.steps * icfg.timestep)
    params = kernel_params(core, icfg)
    stacked = model.cell_layout(x)
    singles = [model.cell_layout(x[k]) for k in range(REPLICAS)]
    compare(f"kernel: {REPLICAS} x {ensemble['n']:,} beads stacked after G1", stacked, params,
            pk, errors)
    f_stacked = pk.ab_pair_forces(stacked, params)[0].reshape(x.shape)
    f_single = torch.stack([pk.ab_pair_forces(layout, params)[0] for layout in singles])
    torch.cuda.synchronize()
    diff = float((f_stacked - f_single).abs().max())
    fmax = float(f_single.abs().max())
    phase("ensemble", f"stacked layout ({stacked.shape[0]} x {stacked.shape[1]} x "
                      f"{stacked.shape[2]} cells) against {REPLICAS} single-replica launches: "
                      f"max|dF| = {diff:.3e}, max|F| = {fmax:.3e}, "
                      f"equal to the bit: {torch.equal(f_stacked, f_single)}")
    if not np.isfinite(diff) or diff > FORCE_TOLERANCE * max(fmax, 1.0):
        fail("ensemble", f"stacked and single-replica forces differ by {diff}")

    def single_launches():
        for layout in singles:
            pk.ab_pair_forces(layout, params)

    single_ms, ms = time_in_turns(single_launches, lambda: pk.ab_pair_forces(stacked, params), 20)
    plain_ms = time_ms(lambda: pk.ab_pair_forces_reference(stacked, params), 2)
    candidates = pk.candidate_pairs(stacked)
    in_reach = pk.pairs_in_reach(stacked, params)
    ops_ms = (OPS_DISTANCE_TEST * candidates + OPS_IN_REACH * in_reach) / PEAK_FP32_FLOPS * 1e3
    bytes_ms = (44 * stacked.n + 4 * stacked.num_cells) / PEAK_BYTES_PER_S * 1e3
    phase("time", f"ensemble after G1: {stacked.n} beads, {candidates} candidate pairs, "
                  f"{in_reach} in reach, in {stacked.num_cells} cells; one stacked launch "
                  f"{ms:.4f} ms, {REPLICAS} single-replica launches {single_ms:.4f} ms "
                  f"({single_ms / ms:.2f} times); plain {plain_ms:.2f} ms, bound "
                  f"{max(ops_ms, bytes_ms):.5f} ms ({ops_ms:.5f} operations, {bytes_ms:.5f} bytes)")
    return dict(ms=ms, single_replica_launches_ms=single_ms, plain_ms=plain_ms,
                candidates=candidates, pairs_in_reach=in_reach,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                cells=stacked.num_cells, beads=stacked.n, replicas=REPLICAS,
                max_abs_diff_single=diff, launches=ensemble["launches"])


def synchronized(fn):
    """``fn()`` and its host-clock seconds, the card synchronised on both
    sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def balanced_spread(b1, b2, counts, weights):
    """std/mean of the balanced marginals over the unmasked bins (a masked
    bin's NaN weight counts as 0, as ``nansum`` over the balanced map)."""
    w = torch.nan_to_num(weights.to(b1.device), nan=0.0)
    values = counts.double() * w[b1] * w[b2]
    marg = torch.zeros(len(w), dtype=torch.float64, device=b1.device)
    marg.index_add_(0, b1, values)
    marg.index_add_(0, b2, values * (b1 != b2))
    marg = marg[torch.isfinite(weights.to(b1.device))]
    return float(marg.std(unbiased=False) / marg.mean())


def check_weights(name, got, want, rounds, want_rounds):
    """ICE weights on the card against the host's: the same masked bins,
    relative ANALYSIS_WEIGHT_RTOL when both took the same number of rounds,
    ANALYSIS_WEIGHT_RTOL_APART when they stopped a round apart."""
    got, want = got.cpu().numpy(), want.numpy()
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        fail("analysis", f"{name}: the card and the host mask other bins")
    ok = np.isfinite(want)
    rel = float(np.max(np.abs(got[ok] - want[ok]) / np.abs(want[ok]))) if ok.any() else 0.0
    limit = ANALYSIS_WEIGHT_RTOL if rounds == want_rounds else ANALYSIS_WEIGHT_RTOL_APART
    phase("analysis", f"{name}: {rounds} rounds on the card, {want_rounds} on the host; "
                      f"{int(ok.sum())} of {len(ok)} bins unmasked; weights max relative "
                      f"difference {rel:.3e} (limit {limit})")
    if abs(rounds - want_rounds) > 1 or not rel <= limit:
        fail("analysis", f"{name}: ICE weights differ from the host's")


def run_analysis(stores, device, card):
    """Phase "analysis": the chain a user runs after an ensemble, ``cool``
    over all replicas -> ICE -> ``dephase`` -> ICE -> the dense haploid map
    -> O/E and PC1, on the card, from the replicas' stores (their contact
    windows, no file in between).  Each step is held against the same
    function on the host; PC1 on the haploid block of the first three
    chromosomes.  Returns the numbers the summary prints."""
    from genome_cycle_tpu_torch.analysis import cool, coolio, dephase, pc1

    if torch.backends.cuda.matmul.allow_tf32:
        fail("analysis", "TF32 is on: float32 products must run in full float32")
    cpu = torch.device("cpu")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds = {}

    (bins, b1, b2, counts), seconds["cool"] = synchronized(
        lambda: cool.contact_pixels(stores, device=device))
    n = len(bins)
    if n != EXPECTED_PARTICLES:
        fail("analysis", f"{n} bins, expected {EXPECTED_PARTICLES}")
    host = cool.contact_pixels(stores, device=cpu)
    if not all(torch.equal(a.cpu(), b) for a, b in zip((b1, b2, counts), host[1:])):
        fail("analysis", "merged pixels differ between the card and the host")
    phase("analysis", f"cool: {len(stores)} replicas, {n} bins, {len(b1)} pixels, "
                      f"{int(counts.sum())} contacts; equal to the host's merge")

    ice = {}
    weights, seconds["ice"] = synchronized(
        lambda: coolio.ice_weights(b1, b2, counts, n, stats=ice))
    host_ice = {}
    check_weights("ICE, diploid", weights,
                  coolio.ice_weights(*host[1:], n, stats=host_ice),
                  ice["rounds"], host_ice["rounds"])
    spreads = [balanced_spread(b1, b2, counts, weights)]

    hap_bins, projection = dephase.project_bins(bins)
    nh = len(hap_bins)
    if nh != EXPECTED_HAPLOID_BINS:
        fail("analysis", f"{nh} haploid bins, expected {EXPECTED_HAPLOID_BINS}")

    def dephased(pixels, where):
        chunk = dephase.dephase_pixels(*pixels, projection)
        return coolio.merge_pixels([chunk], nh, where)

    (h1, h2, hcounts), seconds["dephase"] = synchronized(
        lambda: dephased((b1, b2, counts), device))
    host_hap = dephased(host[1:], cpu)
    if not all(torch.equal(a.cpu(), b) for a, b in zip((h1, h2, hcounts), host_hap)):
        fail("analysis", "dephased pixels differ between the card and the host")
    phase("analysis", f"dephase: {n} -> {nh} bins, {len(h1)} pixels; equal to the host's")
    del b1, b2, counts, host

    hap_ice = {}
    hweights, seconds["ice_haploid"] = synchronized(
        lambda: coolio.ice_weights(h1, h2, hcounts, nh, stats=hap_ice))
    host_hap_ice = {}
    check_weights("ICE, haploid", hweights,
                  coolio.ice_weights(*host_hap, nh, stats=host_hap_ice),
                  hap_ice["rounds"], host_hap_ice["rounds"])
    spreads.append(balanced_spread(h1, h2, hcounts, hweights))
    phase("analysis", f"balanced marginals over the unmasked bins, std/mean: diploid "
                      f"{spreads[0]:.3e}, haploid {spreads[1]:.3e} "
                      f"(limit {ANALYSIS_MARGINAL_SPREAD})")
    if not max(spreads) < ANALYSIS_MARGINAL_SPREAD:
        fail("analysis", "the balanced marginals are not flat")

    matrix, seconds["dense"] = synchronized(lambda: coolio.dense_matrix(
        h1, h2, hcounts, (0, nh), (0, nh), hweights, torch.float32))
    ranges = pc1.chrom_ranges_of(hap_bins)
    block_end = list(ranges.values())[2][1]
    block = matrix[:block_end, :block_end].clone()
    phase("analysis", f"dense haploid map: {tuple(matrix.shape)} float32, "
                      f"{matrix.numel() * 4 / 1e9:.2f} GB")

    pc_timings = {}
    (pc, ev1, evr, _), seconds["pc1"] = synchronized(
        lambda: pc1.compute_pc1(matrix, ranges, timings=pc_timings))
    del matrix
    peak = torch.cuda.max_memory_allocated()
    kept = pc_timings["kept"]
    ev1_host = ev1.cpu().numpy()
    pc_host = pc.cpu().numpy()
    keep = np.isfinite(ev1_host)
    norm = float(np.linalg.norm(ev1_host[keep]))
    phase("analysis", f"pc1: {kept} of {nh} columns kept, {pc_timings['power_steps']} power "
                      f"steps (final delta {pc_timings['power_delta']:.2e}), explained variance "
                      f"ratio {evr:.6f}, |ev1| over the kept bins {norm:.8f}")
    if not (0 < evr <= 1 and abs(norm - 1) <= 1e-5 and np.isfinite(pc_host[keep]).all()):
        fail("analysis", "PC1 out of its bounds (0 < evr <= 1, |ev1| = 1, finite)")

    # PC1 of the first three chromosomes' block, card against host.
    block_ranges = dict(list(ranges.items())[:3])
    got_t, want_t = {}, {}
    got = pc1.compute_pc1(block, block_ranges, timings=got_t)
    want = pc1.compute_pc1(block.cpu(), block_ranges, timings=want_t)
    d_ev1, d_pc1, d_evr = analysis_differences(got, want)
    phase("analysis", f"pc1 of {', '.join(block_ranges)} ({block_end} bins): card and host "
                      f"differ by {d_ev1:.2e} in ev1, {d_pc1:.2e} of max|pc1| in pc1, "
                      f"{d_evr:.2e} relative in evr; {got_t['power_steps']} and "
                      f"{want_t['power_steps']} power steps (limit {ANALYSIS_PC1_TOLERANCE}, "
                      "steps one apart)")
    if (max(d_ev1, d_pc1, d_evr) > ANALYSIS_PC1_TOLERANCE
            or abs(got_t["power_steps"] - want_t["power_steps"]) > 1):
        fail("analysis", "PC1 on the card differs from the host's")

    # The chains' A - B factor of each haploid bin, averaged over its copies.
    chains = pd.read_csv(io.StringIO(stores[0].load_chains_source()), sep="\t")
    ab = np.zeros(n)
    ab[:len(chains)] = (chains["A"] - chains["B"]).to_numpy()[:n]
    mapped = projection >= 0
    ab_hap = (np.bincount(projection[mapped], weights=ab[mapped], minlength=nh)
              / np.maximum(np.bincount(projection[mapped], minlength=nh), 1))
    ok = keep & np.isfinite(pc_host)
    corr = abs(float(np.corrcoef(pc_host[ok], ab_hap[ok])[0, 1]))
    phase("analysis", f"|corr(PC1, A - B of the chains)| over the kept bins: {corr:.4f} "
                      "(no threshold: a run this short need not form compartments)")

    step_ms = pc_timings["power_seconds"] / pc_timings["power_steps"] * 1e3
    bound_ms = 2 * 8 * nh * kept / PEAK_BYTES_PER_S * 1e3
    # The step's two products apart, on a float64 matrix of the same shape:
    # D v reads rows, Dᵀ w the same memory through the transpose.
    probe = torch.randn(nh, kept, dtype=torch.float64, device=device)
    v = torch.randn(kept, dtype=torch.float64, device=device)
    w = torch.randn(nh, dtype=torch.float64, device=device)
    mv_ms = time_ms(lambda: torch.mv(probe, v), 20)
    mv_t_ms = time_ms(lambda: torch.mv(probe.T, w), 20)
    del probe
    for name, label in (("cool", "cool (merge)"), ("ice", "ICE, diploid"),
                        ("dephase", "dephase (gather + merge)"), ("ice_haploid", "ICE, haploid"),
                        ("dense", "dense haploid map"), ("pc1", "O/E + PC1")):
        phase("time", f"analysis {label}: {seconds[name] * 1e3:.1f} ms (host clock around a "
                      "synchronize)")
    phase("time", f"analysis power step: {step_ms:.4f} ms over {pc_timings['power_steps']} "
                  f"steps, bound {bound_ms:.4f} ms (2 x 8 x {nh} x {kept} bytes / 3.35 TB/s; "
                  f"{bound_ms / step_ms:.3f} of it); peak device memory of the phase "
                  f"{peak / 2**20:.1f} MiB; {card}")
    phase("time", f"analysis power step's products alone (CUDA events, 20 launches): D v "
                  f"{mv_ms:.4f} ms, D^T w {mv_t_ms:.4f} ms, each bound "
                  f"{bound_ms / 2:.4f} ms")
    return dict(seconds=seconds, bins=n, haploid_bins=nh, pixels=len(h1), kept=kept,
                ice_rounds=(ice["rounds"], hap_ice["rounds"]),
                power_steps=pc_timings["power_steps"], power_step_ms=step_ms,
                power_bound_ms=bound_ms, mv_ms=mv_ms, mv_t_ms=mv_t_ms, peak_bytes=peak,
                evr=evr, ab_corr=corr)


def analysis_differences(got, want):
    """Card against host PC1 results: max|d ev1| (sign-aligned unit
    vectors), max|d pc1| over max|pc1|, |d evr| over evr."""
    ev1, ev1_want = got[1].cpu().numpy(), want[1].numpy()
    pc, pc_want = got[0].cpu().numpy(), want[0].numpy()
    ok = np.isfinite(ev1_want)
    if not np.array_equal(np.isfinite(ev1), ok):
        fail("analysis", "PC1 on the card keeps other columns than the host's")
    sign = 1.0 if np.dot(ev1[ok], ev1_want[ok]) >= 0 else -1.0
    return (float(np.abs(sign * ev1[ok] - ev1_want[ok]).max()),
            float(np.abs(sign * pc - pc_want).max() / np.abs(pc_want).max()),
            abs(got[2] - want[2]) / want[2])


def chain_statistics(x, chains):
    """Radius of gyration and the second moment of the chain-bond length."""
    bonds = np.concatenate([np.diff(x[c.start:c.end], axis=0) for c in chains])
    centred = x - x.mean(axis=0)
    return (float(np.sqrt(np.mean(np.sum(centred ** 2, axis=1)))),
            float(np.mean(np.sum(bonds ** 2, axis=1))))


def pair_set_difference(got, want):
    """Rows of the two windows' pair sets that are in one only."""
    a = {(int(i), int(j)) for i, j in got[:, :2]}
    b = {(int(i), int(j)) for i, j in want[:, :2]}
    return len(a ^ b)


def run_shards(workdir, design, config, x_relaxed, device):
    """Phase "shards": the multi-device paths of the port as SHARD_RANKS
    ranks that share this one card (gloo, tensors staged through the host),
    each held against the single-device run; see the module docstring.
    Returns what the kernels line and the rate lines need."""
    from genome_cycle_tpu_torch.models.interphase import (
        EngineSettings, InterphaseModel, WindowAccumulator, design_arrays, run_interphase,
    )
    from genome_cycle_tpu_torch.ops import pair_kernels as pk
    from genome_cycle_tpu_torch.parallel import mesh as mesh_ops, ranks
    from genome_cycle_tpu_torch.parallel.ensemble import run_ensemble_interphase
    from genome_cycle_tpu_torch.store import MemoryStore

    ranks_n = SHARD_RANKS
    devices = [device] * ranks_n
    backend = mesh_ops.backend_for(devices)
    phase("shards", f"{ranks_n} ranks on {', '.join(map(str, devices))}, backend {backend} "
                    "(the ranks share one card: collectives staged through host memory)")
    phase("shards", "NCCL across cards was not run: the ranks share one card")
    icfg = config.interphase
    arrays = design_arrays(design, icfg)
    settings = EngineSettings()
    model = InterphaseModel(icfg, arrays, settings, device)
    x0 = torch.as_tensor(x_relaxed, dtype=torch.float32, device=device)
    model.update_bound(float(x0.abs().max()))
    semi0 = np.asarray(icfg.wall_semiaxes_init, np.float32)
    n = model.n

    def stores(name, seeds, stage_config=CONFIG_SHARDS):
        """Prepared stores of the nucleus whose relaxation starts from the
        main cycle's relaxed structure; a path where there is h5py (the ranks
        open it), else the MemoryStore itself."""
        made = []
        for k, seed in enumerate(seeds):
            store = open_store(workdir, f"{name}_{k}", stage_config, seed)
            store.set_stage("relaxation")
            store.save_positions(0, x_relaxed)
            if isinstance(store, MemoryStore):
                made.append(store)
            else:
                store.close()
                made.append(os.path.join(workdir, f"{name}_{k}.h5"))
        return made

    def opened(target):
        from genome_cycle_tpu_torch.store import SimulationStore
        return SimulationStore(target) if isinstance(target, str) else target

    cfg = stores("halo", [SEED])[0]
    cfg_single = stores("single", [SEED])[0]
    ens_seeds = [SEED + 20 + k for k in range(ranks_n)]       # a replica a rank
    ens = stores("replica", ens_seeds, CONFIG_SHARDS_ENSEMBLE)
    ens_single = stores("replica_single", ens_seeds, CONFIG_SHARDS_ENSEMBLE)
    # The twin: the same replicas in one process in the other order, so
    # that each sits elsewhere in the stacked layout.
    ens_twin = stores("replica_twin", ens_seeds[::-1], CONFIG_SHARDS_ENSEMBLE)
    seed = opened(cfg).load_interphase_design().seed
    icfg_shards = opened(cfg).load_config().interphase
    tick = icfg.contactmap_update_interval
    config_tick = dataclasses.replace(config, interphase=dataclasses.replace(
        icfg, steps=tick, sampling_interval=tick, contactmap_output_window=1))

    t0 = time.perf_counter()
    tasks = [
        ("forces", ranks.halo_forces, (icfg, arrays, settings, x_relaxed, semi0, 1, model.bound)),
        ("replicated forces", ranks.sharded_forces, (icfg, arrays, settings, x_relaxed, semi0, 1,
                                                     model.bound)),
        ("tick", ranks.halo_g1, (1, config_tick, design, x_relaxed, semi0, [seed], settings,
                                 model.bound)),
        ("replicated", ranks.sharded_steps, (icfg, arrays, settings, x_relaxed, semi0, seed,
                                             REPLICATED_STEPS, model.bound)),
        ("ensemble", ranks.ensemble, (ens, settings)),
        ("interphase", ranks.interphase, (cfg, settings)),
    ]
    results = mesh_ops.spawn(ranks.run_tasks, ranks_n, devices, backend, tasks)
    seconds = time.perf_counter() - t0
    for r in results:
        foreign = sorted({m for task in r.values() for m in task["foreign_modules"]})
        if foreign:
            fail("shards", f"rank {r['forces']['rank']} loaded {foreign}")

    # (a) one step's assembled forces and reaction at the same positions.
    core, bond = model.scales(0.0)
    semi_t = torch.as_tensor(semi0, device=device)
    f_single, reaction, _ = model._assemble_forces(x0, core, bond, semi_t)
    forces = results[0]["forces"]
    f_single = f_single.cpu().numpy()
    fmax = float(np.abs(f_single).max())
    err = float(np.abs(forces["forces"] - f_single).max())
    r_err = float(np.abs(forces["reaction"] - reaction.cpu().numpy()).max())
    phase("shards", f"(a) halo step's forces against the single step at the relaxed structure: "
                    f"max|dF| {err:.3e}, max|F| {fmax:.3e}; reaction {forces['reaction']} "
                    f"against {reaction.cpu().numpy()} (max diff {r_err:.3e}); own beads "
                    + ", ".join(str(r["forces"]["own"]) for r in results))
    if not err <= FORCE_TOLERANCE * max(fmax, 1.0) or not r_err <= FORCE_TOLERANCE * max(
            float(reaction.abs().max()), 1.0):
        fail("shards", "(a) the halo step's forces or reaction differ from the single step")
    # Each rank's local layout (padded rows and all), rebuilt here on the
    # card, against the plain pair force: the full range, and a home range
    # from past 0 into the padding (these launches do not count).
    kernel_err = 0.0
    local_layouts = []
    for r in results:
        local = r["forces"]
        layout = pk.CellLayout(**{k: torch.as_tensor(v, device=device)
                                  if isinstance(v, np.ndarray) else v
                                  for k, v in local["layout"].items()})
        local_layouts.append(layout)
        real = int(layout.cell_start[-1])
        for begin, end in ((0, None), (real // 3, layout.n)):
            f_k, e_k = pk.ab_pair_forces(layout, local["params"], begin=begin, end=end,
                                         per_bead=True)
            f_p, e_p = pk.ab_pair_forces_reference(layout, local["params"], begin=begin, end=end,
                                                   per_bead=True)
            inside = torch.zeros(layout.n, dtype=torch.bool, device=device)
            inside[layout.order[begin:real]] = True
            diff, max_force = float((f_k - f_p).abs().max()), float(f_p.abs().max())
            outside = float(f_k[~inside].abs().max()) if (~inside).any() else 0.0
            energy, plain_energy = float(e_k.sum()), float(e_p.sum())
            phase("shards", f"rank {local['rank']}: local layout of {layout.n} rows ({real} real), "
                            f"home range [{begin}, {end or 'real end'}): kernel against plain "
                            f"max|dF| {diff:.3e} (max|F| {max_force:.3e}), rows outside the range "
                            f"max|F| {outside}, energy {energy:.6e} against {plain_energy:.6e}")
            if diff > FORCE_TOLERANCE * max(max_force, 1.0) or outside != 0.0 \
                    or abs(energy - plain_energy) > ENERGY_TOLERANCE * abs(plain_energy):
                fail("shards", "the kernel on a rank's local layout disagrees with its plain version")
            kernel_err = max(kernel_err, diff)

    # (b) the first tick's window, and the drift after its steps.
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    window = WindowAccumulator(n, None, device)
    carry = model.g1_chunk((x0, generator, semi_t), 0, tick, window)
    single_window = window.take()
    halo_tick = results[0]["tick"]
    tick_window = halo_tick["store"].load_contacts(tick)
    differ = pair_set_difference(tick_window, single_window)
    drift_tick = float(np.abs(halo_tick["final"] - carry[0].cpu().numpy()).max())
    phase("shards", f"(b) first tick ({tick} steps, T = {icfg.temperature}): {len(tick_window)} "
                    f"pairs against {len(single_window)} single, {differ} rows in one set only; "
                    f"positions {drift_tick:.3e} apart after {tick} steps; halo "
                    f"{results[0]['tick']['timings']['halo']}")
    if differ > 0.01 * len(single_window) or not len(single_window):
        fail("shards", "(b) the halo tick's pair set differs from the single run's")

    # (c) G1 through run_interphase(mesh=...) against the single run.
    interphase_results = [r["interphase"] for r in results]
    single_store = opened(cfg_single)
    single_timings = {}
    run_interphase(single_store, log=lambda m: None, device=device, timings=single_timings)
    halo_store = opened(interphase_results[0]["store"] or cfg)
    _, x_halo, _ = check_output(halo_store, n, icfg_shards)
    _, x_single, _ = check_output(single_store, n, icfg_shards)
    stats_halo = chain_statistics(x_halo, design.chains)
    stats_single = chain_statistics(x_single, design.chains)
    apart = float(np.abs(x_halo - x_single).max())
    steps = icfg_shards.steps
    phase("shards", f"(c) {steps} G1 steps at T = {icfg_shards.temperature}: radius of gyration "
                    f"{stats_halo[0]:.6f} sharded, {stats_single[0]:.6f} single; bond-length "
                    f"second moment {stats_halo[1]:.6e} sharded, {stats_single[1]:.6e} single; "
                    f"positions {apart:.3e} apart after {steps} steps")
    for got, want in zip(stats_halo, stats_single):
        if not abs(got - want) <= 0.01 * abs(want):
            fail("shards", "(c) the sharded run's statistics differ from the single run's by over 1 %")
    # A chunk whose statistics fail runs again, widened: its steps launch
    # the kernel again.  Every rank counts them.
    for line in interphase_results[0]["log"]:
        if line.startswith("halo:"):
            phase("shards", f"(c) {line}")
    frames = len(halo_store.load_steps())
    expected, rerun = [], []
    for r in interphase_results:
        own_frames = frames - 1 + (2 if r["shard"] == 0 else 0)   # energy passes
        rerun.append(r["timings"]["g1_steps_run_again"])
        expected.append(steps + rerun[-1] + own_frames)
    launches = [r["launches"] for r in interphase_results]
    phase("shards", f"(c) pair-kernel launches by rank: {launches}, expected {expected} "
                    f"({steps} steps + {rerun} steps run again + the frames whose energy the "
                    "rank summed: rank 0 also frame 0 of the relaxation and of G1); final halo "
                    f"{interphase_results[0]['timings']['halo']}")
    if launches != expected:
        fail("shards", "the pair kernel was not launched once a step and once a frame on every rank")
    halo_g1 = interphase_results[0]["timings"]
    rate_halo = halo_g1["g1_steps"] / halo_g1["g1_seconds"]
    rate_single = single_timings["g1_steps"] / single_timings["g1_seconds"]

    # The replicated-position engine against the single run: one step's
    # forces at the same positions, where the two can differ only in the
    # order of float32 sums, and why (a home range's launch against a
    # launch over all rows), then REPLICATED_STEPS steps against the single
    # run and its twin.
    rep_forces = results[0]["replicated forces"]
    rep_err = float(np.abs(rep_forces["forces"] - f_single).max())
    rep_rows = int((rep_forces["forces"] != f_single).any(axis=1).sum())
    rep_r_err = float(np.abs(rep_forces["reaction"] - reaction.cpu().numpy()).max())
    layout0 = model.cell_layout(x0)
    params0 = model.pair_kernel_params(core)
    full = pk.ab_pair_forces(layout0, params0)[0]
    cut_rows = 0
    for r in results:
        begin, end = r["replicated forces"]["home"]
        part = pk.ab_pair_forces(layout0, params0, begin=begin, end=end)[0]
        home = layout0.order[begin:end]
        cut_rows += int((part[home] != full[home]).any(dim=1).sum())
    phase("shards", f"replicated engine, step 1 at the relaxed structure: max|dF| {rep_err:.3e} "
                    f"(max|F| {fmax:.3e}) in {rep_rows} of {n} beads; reaction max diff "
                    f"{rep_r_err:.3e}; the pair kernel over each home range against one launch "
                    f"over all rows: {cut_rows} beads differ (blocks of the kernel cut where the "
                    f"home range starts, home ranges {rep_forces['home']} and "
                    f"{results[1]['replicated forces']['home']})")
    if not rep_err <= FORCE_TOLERANCE * max(fmax, 1.0) or not rep_r_err <= FORCE_TOLERANCE * max(
            float(reaction.abs().max()), 1.0):
        fail("shards", "the replicated engine's forces or reaction differ from the single step")
    generator.manual_seed(int(seed))
    window = WindowAccumulator(n, None, device)
    carry = model.g1_chunk((x0, generator, semi_t), 0, REPLICATED_STEPS, window)
    # The twin: the single run on a grid shifted by a third of a cell.
    twin_model = InterphaseModel(icfg, arrays, settings, device)
    twin_model.bound = model.bound + 1.0
    generator.manual_seed(int(seed))
    twin = twin_model.g1_chunk((x0, generator, semi_t), 0, REPLICATED_STEPS,
                               WindowAccumulator(n, None, device))
    twin_apart = float((twin[0] - carry[0]).abs().max())
    replicated = results[0]["replicated"]
    rep_apart = float(np.abs(replicated["positions"] - carry[0].cpu().numpy()).max())
    rep_differ = pair_set_difference(replicated["window"], window.take())
    rep_launches = [r["replicated"]["launches"] for r in results]
    phase("shards", f"replicated engine, {REPLICATED_STEPS} steps: positions {rep_apart:.3e} from "
                    f"the single run, its twin {twin_apart:.3e} (limit {TWIN_FACTOR:g} times "
                    f"that), windows differ in {rep_differ} rows; home ranges "
                    f"{[r['replicated']['home'] for r in results]}; launches {rep_launches}")
    if not rep_apart <= TWIN_FACTOR * twin_apart:
        fail("shards", f"the replicated engine lies {rep_apart} from the single run")
    if rep_launches != [REPLICATED_STEPS] * ranks_n:
        fail("shards", "the replicated engine did not launch the pair kernel once a step on every rank")

    # The ensemble over the ranks against the same replicas in one process.
    singles = [opened(t) for t in ens_single]
    run_ensemble_interphase(singles, log=lambda m: None, device=device)
    twins = [opened(t) for t in ens_twin]
    run_ensemble_interphase(twins, log=lambda m: None, device=device)
    twin_worst = 0.0
    for k, theirs in enumerate(singles):
        twin = twins[len(twins) - 1 - k]
        for store in (theirs, twin):
            store.set_stage("interphase")
        for step in theirs.load_steps():
            twin_worst = max(twin_worst, float(np.abs(twin.load_positions(step)
                                                      - theirs.load_positions(step)).max()))
    worst = 0.0
    window_rows = []
    for r in results:
        for k, target in r["ensemble"]["stores"].items():
            mine, theirs, twin = opened(target), singles[k], twins[len(twins) - 1 - k]
            mine.set_stage("interphase")
            theirs.set_stage("interphase")
            if mine.load_steps() != theirs.load_steps():
                fail("shards", f"ensemble replica {k}: frames {mine.load_steps()}")
            for step in theirs.load_steps():
                worst = max(worst, float(np.abs(mine.load_positions(step)
                                                - theirs.load_positions(step)).max()))
                a, b = mine.load_contacts(step), theirs.load_contacts(step)
                if (a is None) != (b is None):
                    fail("shards", f"ensemble replica {k}: window at step {step} differs")
                if a is None:
                    continue
                differ = pair_set_difference(a, b)
                differ_twin = pair_set_difference(a, twin.load_contacts(step))
                window_rows.append((k, step, differ, differ_twin, len(b)))
                if min(differ, differ_twin) > 0.01 * len(b):
                    fail("shards", f"ensemble replica {k}: window at step {step} differs in "
                                   f"{differ} of {len(b)} rows from the one-process "
                                   f"ensemble, in {differ_twin} from its twin")
    ens_launches = [r["ensemble"]["launches"] for r in results]
    ens_steps = CONFIG_SHARDS_ENSEMBLE["interphase"]["steps"]
    phase("shards", f"ensemble of {ranks_n} over {ranks_n} ranks, {ens_steps} G1 steps: every frame within "
                    f"{worst:.3e} of the one-process ensemble, its twin (the replicas in the other "
                    f"order) within {twin_worst:.3e} (limit {TWIN_FACTOR:g} times that); "
                    f"windows (replica, step, rows apart from the one-process ensemble, from its "
                    f"twin, rows; at most 1 % from one of them): {window_rows}; "
                    f"launches {ens_launches}")
    if not worst <= TWIN_FACTOR * twin_worst:
        fail("shards", f"the ensemble over ranks lies {worst} from the one-process ensemble")
    if ens_launches != [ens_steps] * ranks_n:
        fail("shards", "the ensemble over ranks did not launch the pair kernel once a step")

    phase("rate", f"halo G1 with {ranks_n} ranks sharing one card, gloo, host-staged (not a "
                  f"scaling figure): {rate_halo:.2f} steps/s, {rate_halo * n:.4g} bead-steps/s; "
                  f"the single run in this phase {rate_single:.2f} steps/s")
    # The kernel on rank 0's local layout (own beads + two bands, padded),
    # timed as the other shapes are.
    local = results[0]["forces"]
    layout = local_layouts[0]
    params = tuple(local["params"])
    ms = time_ms(lambda: pk.ab_pair_forces(layout, params), 20)
    plain_ms = time_ms(lambda: pk.ab_pair_forces_reference(layout, params), 2)
    candidates = pk.candidate_pairs(layout)
    in_reach = pk.pairs_in_reach(layout, params)
    real = int(layout.cell_start[-1])
    ops_ms = (OPS_DISTANCE_TEST * candidates + OPS_IN_REACH * in_reach) / PEAK_FP32_FLOPS * 1e3
    bytes_ms = (44 * real + 4 * layout.num_cells) / PEAK_BYTES_PER_S * 1e3
    phase("time", f"rank 0's local layout: {layout.n} rows, {real} of them beads "
                  f"({local['own']} own), {candidates} candidate pairs, {in_reach} in reach; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {max(ops_ms, bytes_ms):.5f} ms "
                  f"({ops_ms:.5f} operations, {bytes_ms:.5f} bytes)")
    phase("time", f"phase shards: {time.perf_counter() - t0:.1f} s, of it the ranks {seconds:.1f} s")
    return dict(launches=launches, replicated_launches=rep_launches, ensemble_launches=ens_launches,
                kernel_max_abs_err=kernel_err, rate=rate_halo, single_rate=rate_single,
                seconds=seconds, rerun_steps=rerun,
                local_layout=dict(ms=ms, plain_ms=plain_ms, bound_ms=max(ops_ms, bytes_ms),
                                  bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                                  candidates=candidates, pairs_in_reach=in_reach,
                                  rows=layout.n, beads=real, own=local["own"],
                                  cells=layout.num_cells, launches=launches))


def run_gate(device):
    """Phase "gate": the port's statistical gate against the C++ surrogate
    (``tests/test_torch_correlation.py``), both configurations, each as one
    stacked run of all its replicas through the kernel, with the surrogate
    built by ``g++`` into ``build/``.  Returns the gated numbers."""
    gxx = shutil.which("g++")
    if gxx is None:
        fail("gate", "no g++ to build the C++ surrogate")
    version = subprocess.run([gxx, "--version"], capture_output=True, text=True,
                             check=True).stdout.splitlines()[0]
    phase("gate", f"g++: {version}")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_correlation as gate
    from genome_cycle_tpu_torch.ops import _build

    exe = _build.build_dir() / "surrogate_ref"
    exe.parent.mkdir(parents=True, exist_ok=True)
    gate.build_surrogate(exe)
    results = {}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_gate_")
    try:
        for name, run in (("chain", gate.contact_map_gate), ("nucleolus", gate.nucleolus_gate)):
            counted = kernel_launches()
            try:
                numbers, seconds = synchronized(
                    lambda: run(exe, pathlib.Path(tempfile.mkdtemp(dir=workdir)), device))
            except AssertionError:
                fail("gate", f"{name}: {traceback.format_exc().splitlines()[-2].strip()}")
            since = kernel_launches(counted)
            launches, rest_launches = since["ab_pair_forces"], since["step_rest"]
            phase("gate", f"{name}: " + ", ".join(f"{k} {v:.5g}" for k, v in numbers.items())
                          + f"; {launches} pair-kernel and {rest_launches} rest-kernel launches "
                          f"for {gate.STEPS} steps of "
                          f"{gate.REPLICAS if name == 'chain' else gate.NUC_REPLICAS} "
                          f"replicas; {seconds:.1f} s, surrogate runs included")
            if launches != gate.STEPS or rest_launches != gate.STEPS:
                fail("gate", f"{name}: {launches} pair-kernel and {rest_launches} rest-kernel "
                             "launches, not one of each a step for all replicas")
            results[name] = dict(numbers, seconds=seconds, launches=launches,
                                 rest_launches=rest_launches)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return results


def cli_process(args, log_path, **popen):
    """``python -m genome_cycle_tpu_torch.<args>`` from the repository's root,
    its output into ``log_path``; the last line it prints is the pair kernel's
    launch count in that process (``LAUNCHER``)."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    log = open(log_path, "a")
    return subprocess.Popen([sys.executable, "-c", LAUNCHER, *args], cwd=ROOT, env=env,
                            stdout=log, stderr=subprocess.STDOUT, **popen), log


def run_cli(args, log_path, timeout):
    """Run a port command to its end; returns its launch count.  Fails with
    the end of its log if it fails."""
    process, log = cli_process(args, log_path)
    try:
        code = process.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        process.kill()
        process.wait()
        code = "killed at its time limit"
    finally:
        log.close()
    text = pathlib.Path(log_path).read_text()
    if code != 0:
        tail = "\n".join(text.splitlines()[-30:])
        fail("store", f"`{' '.join(args)}` exited {code}; its log ends\n{tail}")
    return int(re.findall(r"^launches (\d+)$", text, re.M)[-1])


def logged_step_launches(log_path):
    """The step kernels' launches a ``LAUNCHER`` process printed last."""
    text = pathlib.Path(log_path).read_text()
    return json.loads(re.findall(r"^step kernel launches (.*)$", text, re.M)[-1])


def run_store_phase(workdir):
    """Phase "store": the port's CLI as a user runs it, on the card, into a
    directory store (no h5py); the interphase killed with SIGKILL as soon as
    its first checkpoint is complete, then run again to its end.  Returns the
    numbers the summary prints."""
    from genome_cycle_tpu_torch.store import DirectoryStore, quantize_positions

    t0 = time.perf_counter()
    config_path = os.path.join(workdir, "store.json")
    with open(config_path, "w") as f:
        json.dump(CONFIG_STORE, f)
    cell = os.path.join(workdir, "cell") + "/"
    logs = [os.path.join(workdir, f"{name}.log") for name in ("prepare", "killed", "resumed")]
    cli = "genome_cycle_tpu_torch.cli"
    run_cli([cli, "prepare", "-s", str(SEED), "-o", cell, config_path, CHAINS], logs[0], 300)
    run_cli([cli, "anatelophase", cell], logs[0], 600)
    run_cli([cli, "transition", "interphase", cell], logs[0], 300)
    if not os.path.isfile(os.path.join(cell, "metadata", "config.txt")):
        fail("store", f"no directory store at {cell}")

    # The checkpoint's step is written last: once it is there, the snapshot
    # is whole.
    marker = os.path.join(cell, "stages", "interphase", ".checkpoint", "step.npy")
    process, log = cli_process([cli, "interphase", cell], logs[1])
    try:
        deadline = time.perf_counter() + 900
        while not os.path.exists(marker):
            if process.poll() is not None or time.perf_counter() > deadline:
                fail("store", f"no checkpoint appeared (exit {process.poll()}); log ends\n"
                              + "\n".join(pathlib.Path(logs[1]).read_text().splitlines()[-20:]))
            time.sleep(0.02)
        process.kill()
        code = process.wait()
    finally:
        if process.poll() is None:
            process.kill()
            process.wait()
        log.close()
    with DirectoryStore(cell, "r") as store:
        store.set_stage("interphase")
        checkpoint = store.load_checkpoint()
        frames_killed = store.load_steps()
    phase("store", f"interphase killed (exit {code}) at its first checkpoint, step "
                   f"{checkpoint['step']}; G1 frames stored then {frames_killed}")
    if checkpoint["step"] != STORE_RESUME_STEP:
        fail("store", f"first checkpoint at step {checkpoint['step']}, expected {STORE_RESUME_STEP}")

    launches = run_cli([cli, "interphase", cell], logs[2], 900)
    text = pathlib.Path(logs[2]).read_text()
    resumed = f"resuming interphase from checkpoint at step {STORE_RESUME_STEP}" in text
    with DirectoryStore(cell, "r") as store:
        config = store.load_config()
        icfg = config.interphase
        n = store.load_interphase_design().particle_count
        _, x_final, ctx = check_output(store, n, icfg)
        store.set_stage("interphase")
        frames = store.load_steps()
        windows = [step for step in frames if store.load_contacts(step) is not None]
        start = store.load_positions(STORE_RESUME_STEP)
    same_start = np.array_equal(quantize_positions(checkpoint["positions"]), start)
    window_steps = icfg.sampling_interval * icfg.contactmap_output_window
    # A launch a step of the relaxation (again) and of G1 from the
    # checkpoint, and one for the energy of each frame this process wrote.
    run_again = icfg.relaxation_steps + icfg.steps - STORE_RESUME_STEP
    energies = (icfg.relaxation_steps // icfg.relaxation_sampling_interval + 1
                + (icfg.steps - STORE_RESUME_STEP) // icfg.sampling_interval)
    phase("store", f"run again: resume logged at step {STORE_RESUME_STEP}: {resumed}; G1 frames "
                   f"{frames}; windows at {windows}; the checkpoint's positions quantized equal "
                   f"the stored frame at {STORE_RESUME_STEP}: {same_start}; pair-kernel launches "
                   f"{launches} (expected {run_again} steps, the relaxation again and G1 from "
                   f"{STORE_RESUME_STEP}, + {energies} frames); checkpoint cleared; "
                   f"{time.perf_counter() - t0:.1f} s")
    if not resumed:
        fail("store", "the interphase run again did not resume from its checkpoint")
    if frames != list(range(0, icfg.steps + 1, icfg.sampling_interval)):
        fail("store", f"G1 frames {frames}")
    if windows != list(range(0, icfg.steps + 1, window_steps)):
        fail("store", f"windows at {windows}")
    if not same_start:
        fail("store", "the resumed G1 did not start from the stored frame of its checkpoint")
    if launches != run_again + energies:
        fail("store", f"{launches} pair-kernel launches in the resumed run")
    return dict(seconds=time.perf_counter() - t0, launches=launches, frames=len(frames),
                windows=len(windows))


def kernel_at(label, layout, params, pk, errors, n):
    """The kernel held against its plain version on ``layout``
    (:func:`compare`) and timed beside it; returns its entry for the
    kernels line."""
    compare(f"kernel: {label}", layout, params, pk, errors)
    candidates = pk.candidate_pairs(layout)
    in_reach = pk.pairs_in_reach(layout, params)
    ms = time_ms(lambda: pk.ab_pair_forces(layout, params), 20)
    plain_ms = time_ms(lambda: pk.ab_pair_forces_reference(layout, params), 2)
    ops_ms = (OPS_DISTANCE_TEST * candidates + OPS_IN_REACH * in_reach) / PEAK_FP32_FLOPS * 1e3
    bytes_ms = (44 * n + 4 * layout.num_cells) / PEAK_BYTES_PER_S * 1e3
    phase("time", f"{label}: {candidates} candidate pairs, {in_reach} in reach "
                  f"({in_reach / candidates:.4f} of them), in {layout.num_cells} cells; kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {max(ops_ms, bytes_ms):.5f} ms "
                  f"({ops_ms:.5f} operations, {bytes_ms:.5f} bytes)")
    return dict(ms=ms, plain_ms=plain_ms, candidates=candidates, pairs_in_reach=in_reach,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                cells=layout.num_cells)


def check_layout_kernel(label, model, x, pk):
    """The layout kernels (``csrc/cell_layout.cu``) against their plain
    version on the model's grid at positions ``x``: every field equal to the
    bit; both timed by CUDA events over 20 launches.  The bound: positions
    and factors read once, order, ids, positions, factors and the cell starts
    written once, over 3.35 TB/s.  Returns the entry for the kernels line."""
    args = (x, model.af, model.bf, model.bound, model.cell)
    got = pk.build_cell_layout(*args)
    want = pk.build_cell_layout_reference(*args)
    torch.cuda.synchronize()
    for field in pk.CellLayout._fields:
        a, b = getattr(got, field), getattr(want, field)
        same = (a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
                if torch.is_tensor(b) else a == b)
        if not same:
            fail("layout", f"{label}: the kernels' {field} differs from the plain version's")
    ms = time_ms(lambda: pk.build_cell_layout(*args), 20)
    plain_ms = time_ms(lambda: pk.build_cell_layout_reference(*args), 20)
    rows, cells = got.n, got.num_cells
    moved = (12 + 8 + 4 + 16 + 8) * rows + 8 * model.af.shape[0] + 4 * (cells + 1)
    bound_ms = moved / PEAK_BYTES_PER_S * 1e3
    phase("layout", f"{label}: {rows} rows, {cells} cells, "
                    f"every field equal to the plain version's; kernels {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms ({plain_ms / ms:.2f} times), bound {bound_ms:.5f} ms "
                    f"({moved} bytes)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", rows=rows,
                cells=cells, bytes=moved)


def layout_kernel_entry(launches, timed):
    """The layout kernels' entry of the kernels line."""
    main = timed["after G1"]
    return {"name": "cell_layout", "route": "cuda",
            "source": "genome_cycle_tpu_torch/csrc/cell_layout.cu",
            "replaces": "JAX: XLA-fused sort and searchsorted, "
                        "genome_cycle_tpu/ops/block_pairs.py (build_structure)",
            "launches": launches, "max_abs_err": 0.0, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shapes": timed}


def fit_g1_steps(seconds, started, device):
    """The deepest G1 (a multiple of 10,000 steps, at most 700,000) that
    lets the production run and its checks end within ``seconds`` of
    ``started``, by the rates of a calibration run here (see
    CALIBRATION_CONFIG); fails when not even MIN_G1_STEPS fit."""
    from genome_cycle_tpu_torch.config import parse_config
    from genome_cycle_tpu_torch.models.anatelophase import run_anatelophase
    from genome_cycle_tpu_torch.models.interphase import run_interphase
    from genome_cycle_tpu_torch.models.prometaphase import run_prometaphase
    from genome_cycle_tpu_torch.models.transitions import (
        transition_interphase, transition_prometaphase,
    )

    workdir = tempfile.mkdtemp(prefix="chip_smoke_calibration_")
    try:
        timings = {}
        store = open_store(workdir, "calibration", CALIBRATION_CONFIG, SEED)
        run_anatelophase(store, log=lambda m: None, device=device, timings=timings)
        transition_interphase(store, log=lambda m: None)
        run_interphase(store, log=lambda m: None, device=device, timings=timings)
        transition_prometaphase(store, log=lambda m: None)
        run_prometaphase(store, log=lambda m: None, device=device, timings=timings)
        store.close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rate = {k: timings[f"{k}_steps"] / timings[f"{k}_seconds"]
            for k in ("anaphase", "telophase", "prometaphase", "relaxation", "g1")}
    with open(PRODUCTION_CONFIG) as f:
        config = parse_config(f.read())
    m, c = config.mitotic_phase, config.interphase
    mitotic = m.anaphase_steps + m.telophase_steps + m.prometaphase_steps
    fixed = ((m.anaphase_steps + m.telophase_steps)
             / (RATE_MARGIN * min(rate["anaphase"], rate["telophase"]))
             + m.prometaphase_steps / (RATE_MARGIN * rate["prometaphase"])
             + c.relaxation_steps / (RATE_MARGIN * rate["relaxation"]))
    left = seconds - (time.perf_counter() - started) - PRODUCTION_OVERHEAD_S - fixed
    steps = min(PRODUCTION_G1_STEPS, int(left * RATE_MARGIN * rate["g1"]) // 10000 * 10000)
    phase("depth", "calibration: " + ", ".join(f"{k} {v:.2f} steps/s" for k, v in rate.items())
                   + f"; {mitotic} mitotic and {c.relaxation_steps} relaxation steps take "
                   f"{fixed:.0f} s at {RATE_MARGIN} of these rates, {left:.0f} s are left of "
                   f"{seconds} s: G1 {steps} steps")
    if steps < MIN_G1_STEPS:
        fail("depth", f"a G1 of {MIN_G1_STEPS} steps does not fit {seconds} s on this host")
    return steps


def print_production_rates(summary):
    """Each stage's and each G1 window's seconds, steps/s and peak device
    memory, as the production run recorded them."""
    for name, entry in summary["stages"].items():
        for key, value in entry.items():
            if isinstance(value, dict) and "steps" in value:
                phase("rate", f"{name}, {key}: {value['steps']} steps in {value['seconds']:.2f} s, "
                              f"{value['steps_per_s']:.2f} steps/s")
        if "seconds" in entry:
            phase("rate", f"{name}: {entry['seconds']:.2f} s wall, peak device memory "
                          f"{entry.get('peak_bytes', 0) / 2**20:.1f} MiB")
    g1 = summary["stages"]["interphase"]
    depth = summary["depth"]
    window_steps = depth["sampling_interval"] * depth["window_frames"]
    ticks = window_steps // depth["tick_interval"]
    for w in g1.get("windows", []):
        rate = f", {window_steps / w['seconds']:.2f} steps/s" if w["seconds"] else ""
        phase("rate", f"window at G1 step {w['step']}: {w['rows']} rows from {w['events']} "
                      f"events ({w['events'] / max(ticks, 1):.0f} a tick), accumulator capacity "
                      f"{w['capacity']}, {w['seconds']:.2f} s since the previous window{rate}")
    analysis = summary["analysis"]
    phase("rate", "analysis: " + ", ".join(f"{k} {v:.3f} s" for k, v in analysis["seconds"].items())
                  + f"; peak device memory {analysis.get('peak_bytes', 0) / 2**20:.1f} MiB")
    steps = {key: value["seconds"] for entry in summary["stages"].values()
             for key, value in entry.items() if isinstance(value, dict) and "steps" in value}
    mitotic = sum(v for k, v in steps.items() if k in ("anaphase", "telophase", "prometaphase"))
    interphase = sum(v for k, v in steps.items() if k in ("relaxation", "g1"))
    phase("rate", f"the cycle's steps: mitotic {mitotic:.1f} s (anaphase, telophase, "
                  f"prometaphase), interphase {interphase:.1f} s (relaxation, G1)")


def production(g1_steps, card, started, device, seconds=None, output=PRODUCTION_OUTPUT):
    """``--production``: ``genome_cycle_tpu_torch.production`` at the
    reference defaults (G1 cut to ``g1_steps`` when that is less than
    700,000) on ``device``, into a scratch directory; then the rates it
    recorded, the kernel at late-G1 structures, and the checks of its
    trajectory, of the windows against their ticks' events and of the
    counts against the JAX run's."""
    from genome_cycle_tpu_torch.models.interphase import EngineSettings, InterphaseModel
    from genome_cycle_tpu_torch.ops import pair_kernels as pk
    from genome_cycle_tpu_torch.store import DirectoryStore

    os.makedirs(output, exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="chip_smoke_production_")
    with open(PRODUCTION_CONFIG) as f:
        config = json.load(f)
    if g1_steps != PRODUCTION_G1_STEPS:
        config.setdefault("interphase", {})["steps"] = g1_steps
    config_path = os.path.join(scratch, "config.json")
    with open(config_path, "w") as f:
        json.dump(config, f)
    phase("depth", f"production: {json.dumps(config)}"
                   + ("" if g1_steps == PRODUCTION_G1_STEPS else
                      f" (G1 cut from {PRODUCTION_G1_STEPS} to {g1_steps} steps)"))
    # Positions of every frame and the windows' rows, at the JAX run's
    # largest window, twice over.
    frames = g1_steps // 1000 + 1 + 11 + 1 + 701
    windows = g1_steps // 10000 + 1
    need = 2 * (frames * EXPECTED_PARTICLES * 12 + windows * JAX_RUN["largest_window_rows"] * 12)
    free = shutil.disk_usage(scratch).free
    phase("store", f"scratch {scratch}: {free / 2**30:.1f} GiB free, {need / 2**30:.1f} GiB wanted")
    if free < need:
        fail("store", f"{free / 2**30:.1f} GiB free under {scratch}, {need / 2**30:.1f} GiB needed")

    run = os.path.join(scratch, "run")
    log_path = os.path.join(output, "production.log")
    try:
        t0 = time.perf_counter()
        limit = 7 * 3600 if seconds is None else seconds - (t0 - started) - CHECK_SECONDS
        launches = run_cli(["genome_cycle_tpu_torch.production", "--output", run,
                            "-s", str(SEED), config_path, CHAINS], log_path, limit)
        wall = time.perf_counter() - t0
        for name in ("summary.json", "pc1.tsv", "aux.json"):
            shutil.copy(os.path.join(run, name), output)
        with open(os.path.join(run, "summary.json")) as f:
            summary = json.load(f)
        phase("production", f"exit 0 after {wall:.1f} s; pair-kernel launches {launches}")
        print_production_rates(summary)
        with DirectoryStore(os.path.join(run, "trajectory"), "r") as store:
            errors = Errors()
            model = InterphaseModel.from_design(store.load_interphase_design(),
                                                store.load_config(), EngineSettings(), device)
            icfg = model.config
            store.set_stage("interphase")
            steps = store.load_steps()
            late = LATE_G1_FRAMES
            if g1_steps != PRODUCTION_G1_STEPS:
                late = (LATE_G1_FRAMES[0], steps[-1] // 2000 * 1000, steps[-1])
            late = sorted(set(late) & set(steps))
            shapes = {}
            step_errors = StepErrors()
            main_step_launches = logged_step_launches(log_path)
            for step in late:
                x = torch.as_tensor(store.load_positions(step), dtype=torch.float32, device=device)
                model.update_bound(float(x.abs().max()))
                ctx = store.load_interphase_context(step)
                label = f"{model.n:,} beads at G1 step {step} (core scale {ctx.core_scale:.4f})"
                shapes[f"G1 step {step}"] = kernel_at(
                    label, model.cell_layout(x), kernel_params(ctx.core_scale, icfg), pk, errors,
                    model.n)
                semi = torch.as_tensor(ctx.wall_semiaxes, dtype=torch.float32, device=device)
                step_timed = check_step_kernels(label, model, x, ctx.core_scale, ctx.bond_scale,
                                                semi, step_errors, time_them=step == late[-1])
            mitotic_timed = check_mitotic_kernel(
                mitotic_starts(store, store.load_config(), device), statistics=False)
            checked = check_production(store, summary, launches, pk)
            phase("production", f"step kernel launches in the production process: "
                                f"{main_step_launches}")
            if main_step_launches["step_rest"] < icfg.relaxation_steps + icfg.steps \
                    or main_step_launches["contact_tick"] < icfg.steps // \
                    icfg.contactmap_update_interval \
                    or main_step_launches["bd_update"] != icfg.relaxation_steps:
                fail("production", "the step kernels were not launched once a step (a tick), "
                                   "or the update kernel beside the relaxation's steps")
            check_chunk_launches("production", main_step_launches,
                                 store.load_config().mitotic_phase)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    phase("time", f"whole script, build included: {time.perf_counter() - started:.1f} s")
    main_shape = shapes[f"G1 step {late[-1]}"]
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "ab_pair_forces",
        "route": "cuda",
        "source": "genome_cycle_tpu_torch/csrc/ab_pair_forces.cu",
        "replaces": "genome_cycle_tpu/ops/pallas_kernels.py:109",
        "launches": launches,
        "max_abs_err": errors.max_abs,
        "max_rel_err": errors.max_rel,
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "shapes": shapes,
        "production": checked,
    }] + step_kernel_entries(main_step_launches, step_errors, step_timed)
        + [mitotic_kernel_entry(main_step_launches["mitotic_chunk"], mitotic_timed)]}),
          flush=True)


def check_production(store, summary, launches, pk):
    """What the production run wrote: every stage's frames, the G1's
    windows against their ticks' events, the launches, and the counts beside
    the JAX run's (held to them at full depth).  Returns the counts."""
    config = store.load_config()
    icfg, m = config.interphase, config.mitotic_phase
    n = store.load_interphase_design().particle_count
    if n != EXPECTED_PARTICLES:
        fail("production", f"{n} particles, expected {EXPECTED_PARTICLES}")
    check_anatelophase(store, m)
    _, _, ctx = check_output(store, n, icfg)
    check_prometaphase(store, m)
    g1 = summary["stages"]["interphase"]
    if g1.get("skipped"):
        fail("production", "the interphase ran in an earlier process: its windows' events are "
                           "not in this summary")
    lost = []
    store.set_stage("interphase")
    for w in g1["windows"]:
        counted = int(store.load_contacts(w["step"])[:, 2].astype(np.int64).sum())
        if counted != w["events"]:
            lost.append((w["step"], counted, w["events"]))
    window_steps = list(range(0, icfg.steps + 1,
                              icfg.sampling_interval * icfg.contactmap_output_window))
    phase("check", f"every window's counts against its ticks' events: {len(g1['windows'])} "
                   f"windows, {len(lost)} differ {lost[:5]}")
    if lost or [w["step"] for w in g1["windows"]] != window_steps:
        fail("production", "a window's counts differ from its ticks' events (or a window is "
                           "missing)")
    relax, g1_steps = icfg.relaxation_steps, icfg.steps
    if launches < relax + g1_steps:
        fail("production", f"{launches} pair-kernel launches for {relax + g1_steps} steps")
    counts = dict(summary["trajectory"], pixels=summary["analysis"]["pixels"],
                  haploid_bins=summary["analysis"]["haploid_bins"],
                  kept=summary["analysis"]["kept"], grid_bound=g1["grid_bound"],
                  final_semiaxes=list(ctx.wall_semiaxes), launches=launches)
    full = g1_steps == PRODUCTION_G1_STEPS
    # A cut G1 projected to full depth at its last window's rows and events
    # (not a comparison: the windows have not settled in every run).
    last, missing = g1["windows"][-1], (PRODUCTION_G1_STEPS - g1_steps) // (
        icfg.sampling_interval * icfg.contactmap_output_window)
    projected = {"coo_rows": counts["coo_rows"] + missing * last["rows"],
                 "contact_events": counts["contact_events"] + missing * last["events"]}
    for key, label in (("coo_rows", "COO rows"), ("pixels", "diploid pixels"),
                       ("contact_events", "contact events"),
                       ("largest_window_rows", "largest window's rows"),
                       ("grid_bound", "final grid bound")):
        ratio = counts[key] / JAX_RUN[key]
        cut = "" if full else "; not comparable: G1 cut" + (
            f" (projected to {PRODUCTION_G1_STEPS} steps at the last window's: "
            f"{projected[key]}, {projected[key] / JAX_RUN[key]:.4f} of the JAX run's)"
            if key in projected else "")
        phase("check", f"{label}: {counts[key]} against the JAX run's {JAX_RUN[key]:.4g} "
                       f"({ratio:.4f} of it){cut}")
        if full and key in ("coo_rows", "pixels", "contact_events") \
                and abs(ratio - 1) > JAX_COUNT_SPREAD:
            fail("production", f"{label} off the JAX run's by more than {JAX_COUNT_SPREAD:.0%}")
    phase("check", f"the JAX run's {JAX_RUN['haploid_map_bins']}-bin haploid map against the "
                   f"port's {counts['haploid_bins']} haploid bins (fixed by the chain table) and "
                   f"the {counts['kept']} columns PC1 keeps")
    counts["projected_to_full_depth"] = None if full else projected
    return counts


# ---- the step kernels: the contact tick, the rest (bonds + wall, with the
# update and the wall ODE in G1) and the update alone ------------------------
#
# Held against their plain versions on the same inputs: the tick's pair sets
# equal (r2 is formed in one fixed order on both sides), also after a forced
# overflow (a capacity of TICK_FORCED_ROWS rows) and its rerun; forces,
# reaction and positions within STEP_TOLERANCE of the largest magnitude of
# the plain version's (the wall's derivatives in closed form against
# autograd, float32 sums in another order), energies ENERGY_TOLERANCE
# relative; STEP_STEPS steps at T = 0 through the kernels, each against the
# plain composition's step from the same state (plain pair force, nucleolar
# terms, bonds, autograd wall, update, wall ODE), positions within
# STEP_TOLERANCE of max|x|; the two whole trajectories within TWIN_FACTOR
# times a twin's distance (see zero_temperature_steps).
STEP_TOLERANCE = 1e-5
STEP_STEPS = 200
TICK_FORCED_ROWS = 4096
# Bytes the rest kernel moves in G1 and the update kernel alone: for each
# bead of each replica its position, force and noise read once and its new
# position written; for each bead once, the rows all replicas share (the
# rest kernel: mobility, two masks, three bond rows, two wall weights, and
# the nucleolar table once; the update: the mobility).  Operations: the
# tick's distance test for each candidate of the half stencil.
STEP_BYTES_PER_REPLICA_BEAD = 12 + 12 + 12 + 12
REST_SHARED_BYTES_PER_BEAD = 4 + 2 + 12 + 8
UPDATE_SHARED_BYTES_PER_BEAD = 4
TICK_BYTES_PER_ROW = 16 + 4 + 8
TICK_BYTES_PER_EVENT = 12
STEP_KERNELS = {
    # name: (source, what it replaces)
    "contact_tick": ("genome_cycle_tpu_torch/csrc/contact_tick.cu",
                     "JAX: XLA-fused, genome_cycle_tpu/ops/block_pairs.py:447 "
                     "(block_contact_events)"),
    "step_rest": ("genome_cycle_tpu_torch/csrc/step_rest.cu",
                  "JAX: XLA-fused, genome_cycle_tpu/models/interphase.py:688 (_bd_step4: "
                  "bonded_forces :425 with ops/bonded.py:40 shift_bond_forces, pair_bond_forces "
                  "and the droplet, ops/wall.py:57 wall_forces, the update, the wall ODE)"),
    "bd_update": ("genome_cycle_tpu_torch/csrc/step_rest.cu",
                  "JAX: XLA-fused, genome_cycle_tpu/ops/integrator.py:32 (bd_update)"),
}


def kernel_launches(since=None):
    """The launches of each of :data:`KERNELS` that the port's wrappers have
    counted in this process, or their increase since the counts ``since``."""
    from genome_cycle_tpu_torch.utils import tracing

    counts = tracing.counters()
    return {k: counts.get("launch." + k, 0) - (since or {}).get(k, 0) for k in KERNELS}


def device_launches(fn, calls):
    """Device kernels (memory copies and sets included) that ``fn`` starts,
    per call, counted by ``torch.profiler`` over ``calls`` calls after one
    unprofiled call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    count = 0
    for event in prof.key_averages():
        if "CUDA" in str(getattr(event, "device_type", "")) and (
                getattr(event, "self_device_time_total", 0)
                or getattr(event, "self_cuda_time_total", 0)):
            count += event.count
    return count / calls


def pair_keys(events):
    """Sorted int64 keys lo << 32 | hi of (E, 3) event rows."""
    ev = events.to(torch.int64)
    return torch.sort((ev[:, 0] << 32) | ev[:, 1]).values


def half_stencil_counts(layout):
    """Candidates (i, j > i) the tick tests, for each real row: the half
    stencil's ranges, the own cell's rows up to i left out."""
    from genome_cycle_tpu_torch.ops.pair_kernels import stencil_ranges

    real = int(layout.cell_start[-1])
    total = sum(count for _, count in stencil_ranges(layout, half=True))[:real]
    rows = torch.arange(real, device=layout.cell_id.device)
    own = rows - layout.cell_start.to(torch.int64)[layout.cell_id[:real].to(torch.int64)]
    return total - (own + 1)


class StepErrors:
    """Largest differences of the step kernels from their plain versions."""

    def __init__(self):
        self.max_abs = {name: 0.0 for name in STEP_KERNELS}


def check_step_kernels(label, model, x, core, bond, semiaxes, step_errors, time_them=False):
    """The tick, the rest kernel, the update kernel and the fused G1 launch
    against their plain versions at positions ``x`` (N, 3) or (R, N, 3),
    with the semiaxes of the structure; see STEP_TOLERANCE.  Fails beyond the
    tolerances.  With ``time_them``, the kernels and their plain versions
    timed, and the bounds of these inputs; returns those."""
    from genome_cycle_tpu_torch.ops import contact, step_rest
    from genome_cycle_tpu_torch.ops.integrator import BDParams, bd_update, bd_update_reference

    c = model.config
    name = f"step kernels: {label}"
    # -- the tick, with a fresh capacity and with one it must outgrow --------
    layout = model.cell_layout(x)
    cutoff = c.contactmap_distance * core
    want = contact.contact_events_reference(layout, cutoff)
    keys = pair_keys(want)
    per_row = half_stencil_counts(layout)
    candidates = int(per_row.sum())
    cell_rows = layout.cell_start[1:] - layout.cell_start[:-1]
    phase(name, f"tick: {candidates} half-stencil candidates over {per_row.numel()} rows, a row "
                f"{candidates / max(per_row.numel(), 1):.1f} on the mean, {int(per_row.max())} "
                f"at most (the 99th percentile "
                f"{float(torch.quantile(per_row.double(), 0.99)):.0f}); the fullest cell holds "
                f"{int(cell_rows.max())} rows")
    for rows in (None, TICK_FORCED_ROWS):
        counted = kernel_launches()
        capacity = contact.EventCapacity(rows)
        got = contact.contact_events(layout, cutoff, capacity=capacity)
        runs = kernel_launches(counted)["contact_tick"]
        equal = torch.equal(pair_keys(got), keys)
        phase(name, f"tick: {len(got)} pairs at cutoff {cutoff:.4f}, the plain search "
                    f"{len(want)}; sets equal: {equal}; capacity {rows or 16 * layout.n} -> "
                    f"{capacity.rows} rows, {runs} launches")
        if not equal:
            fail(name, "the tick kernel's pair set differs from the plain search's")
        if rows is not None and len(want) > rows and runs != 2:
            fail(name, "the forced overflow did not grow the capacity and run again")
    # -- the rest kernel (bonds + wall) into a force buffer -------------------
    # Held against the plain version in float64 on the same inputs: the wall
    # distance is a small difference near the wall, and the plain version in
    # float32 lies up to about 1e-5 of max|F| from it (read here, not held).
    forces0, _ = model.pair_forces_full(x, core)
    bonds, wall = model.bond_rows(bond), model.wall_rows(semiaxes, core)
    if bonds.nucleolar is None:
        fail(name, "the design has no nucleolar rows for the rest kernel to take")
    kernel = [step_rest.rest(x, forces0.clone(), bonds, wall, with_energy=True)
              for _ in range(2)]
    wide = step_rest.rest_reference(x.double(), forces0.double(), bonds,
                                    wall._replace(semiaxes=semiaxes.double()), with_energy=True)
    plain = step_rest.rest_reference(x, forces0, bonds, wall, with_energy=True)
    f_p, r_p = plain.out, plain.reaction
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(kernel[0][:4], kernel[1][:4])):
        fail(name, "two launches of the rest kernel differ")
    f_k, r_k = kernel[0].out, kernel[0].reaction
    e_k = float(kernel[0].bonded_energy + kernel[0].wall_energy)
    e_w = float(wide.bonded_energy + wide.wall_energy)
    fmax, rmax = float(wide.out.abs().max()), float(wide.reaction.abs().max())
    df, dr = float((f_k - wide.out).abs().max()), float((r_k - wide.reaction).abs().max())
    df32 = float((f_p - wide.out).abs().max())
    dr32 = float((r_p - wide.reaction).abs().max())
    e_rel = abs(e_k - e_w) / max(abs(e_w), 1e-30)
    phase(name, f"rest kernel (nucleolar rows live: {bonds.nucleolar.bonds.shape[0]} NOR "
                f"bonds, {bonds.nucleolar.targets.shape[0]} droplet targets) against the plain "
                f"version in float64: max|dF| {df:.3e} of "
                f"max|F| {fmax:.3e} (the plain version in float32: {df32:.3e}); reaction "
                f"{r_k.cpu().numpy().round(3).tolist()}, max diff {dr:.3e} of {rmax:.3e} "
                f"(float32 autograd: {dr32:.3e}); bonded + wall energy {e_k:.6e} against "
                f"{e_w:.6e} (rel {e_rel:.2e}); two launches equal to the bit")
    if not (df <= STEP_TOLERANCE * fmax and dr <= STEP_TOLERANCE * rmax
            and e_rel <= ENERGY_TOLERANCE):
        fail(name, "the rest kernel differs from its plain version beyond the tolerances")
    step_errors.max_abs["step_rest"] = max(step_errors.max_abs["step_rest"], df)
    # -- the update alone, with and without the displacement limit ------------
    generator = torch.Generator(device=x.device)
    generator.manual_seed(5)
    noise = torch.randn(x.shape, generator=generator, device=x.device)
    worst = 0.0
    for spacestep in (None, c.relaxation_spacestep):
        params = BDParams(c.temperature, c.timestep, spacestep)
        got = bd_update(x, f_p, model.mobility, None, params, noise=noise)
        plain = bd_update_reference(x, f_p, model.mobility, None, params, noise=noise)
        dx, xmax = float((got - plain).abs().max()), float(plain.abs().max())
        moved = float((plain - x).abs().max())
        phase(name, f"update kernel (spacestep {spacestep}): max|dx| {dx:.3e}, max|x| "
                    f"{xmax:.3f}, largest move {moved:.3e}")
        if not dx <= STEP_TOLERANCE * xmax:
            fail(name, "the update kernel differs from its plain version")
        worst = max(worst, dx)
    step_errors.max_abs["bd_update"] = max(step_errors.max_abs["bd_update"], worst)
    # -- the fused G1 launch: bonds + wall + update + wall ODE -----------------
    dt = c.timestep
    update = step_rest.UpdateRows(model.mobility, noise, c.temperature, dt, dt * c.wall_mobility,
                                  tuple(c.wall_semiaxes_spring))
    fused = step_rest.rest(x, forces0, bonds, wall, update)
    plain_x = bd_update_reference(x, f_p, model.mobility, None, BDParams(c.temperature, dt),
                                  noise=noise)
    plain_semi = semiaxes + dt * c.wall_mobility * (r_p - model.wall_spring * semiaxes)
    dx = float((fused.out - plain_x).abs().max())
    ds = float((fused.semiaxes - plain_semi).abs().max())
    phase(name, f"fused G1 launch: max|dx| {dx:.3e}, semiaxes max diff {ds:.3e}")
    if not (dx <= STEP_TOLERANCE * float(plain_x.abs().max())
            and ds <= STEP_TOLERANCE * float(plain_semi.abs().max())):
        fail(name, "the fused G1 launch differs from the plain composition")
    step_errors.max_abs["step_rest"] = max(step_errors.max_abs["step_rest"], dx)
    if not time_them:
        return None

    # -- times on the card beside the plain versions, and the bounds ----------
    # The tick kernel alone, queued ahead into a buffer and a counter kept
    # across launches (each launch zeroes the counter first: one memset); the
    # wrapper's latency with its allocations and count read back apart.
    capacity = contact.EventCapacity()
    contact.contact_events(layout, cutoff, capacity=capacity)
    buffer = torch.empty((capacity.rows, 3), dtype=torch.int32, device=x.device)
    count = torch.zeros(1, dtype=torch.int32, device=x.device)
    cutoff2 = float(cutoff) * float(cutoff)

    def tick_kernel():
        count.zero_()
        contact._tick_launch(layout, cutoff2, 0, layout.n, buffer, count)

    tick_ms = time_ms(tick_kernel, 20)
    tick_wrapper_ms = time_ms(
        lambda: contact.contact_events(layout, cutoff, capacity=capacity), 20)
    tick_plain_ms = time_ms(lambda: contact.contact_events_reference(layout, cutoff), 2)
    real = int(layout.cell_start[-1])
    tick_ops = OPS_DISTANCE_TEST * candidates / PEAK_FP32_FLOPS * 1e3
    tick_bytes = ((TICK_BYTES_PER_ROW * real + 4 * layout.num_cells
                   + TICK_BYTES_PER_EVENT * len(want)) / PEAK_BYTES_PER_S * 1e3)
    replicas, n = (1, x.shape[0]) if x.dim() == 2 else (x.shape[0], x.shape[1])
    rest_ms = time_ms(lambda: step_rest.launch_rest(x, forces0, bonds, wall, update), 20)
    rest_plain_ms = time_ms(lambda: step_rest.rest_reference(x, forces0, bonds, wall, update), 5)
    relax = BDParams(c.temperature, dt, c.relaxation_spacestep)
    update_ms = time_ms(lambda: step_rest.launch_update(
        x, f_p, model.mobility, noise, c.temperature, dt, c.relaxation_spacestep), 20)
    update_plain_ms = time_ms(
        lambda: bd_update_reference(x, f_p, model.mobility, None, relax, noise=noise), 5)
    rest_bytes = ((STEP_BYTES_PER_REPLICA_BEAD * replicas + REST_SHARED_BYTES_PER_BEAD) * n
                  + 4 * bonds.nucleolar.table.numel()) / PEAK_BYTES_PER_S * 1e3
    update_bytes = ((STEP_BYTES_PER_REPLICA_BEAD * replicas + UPDATE_SHARED_BYTES_PER_BEAD) * n
                    / PEAK_BYTES_PER_S * 1e3)
    timed = {
        "contact_tick": dict(ms=tick_ms, plain_ms=tick_plain_ms, bound_ms=max(tick_ops, tick_bytes),
                             bound_by="operations" if tick_ops >= tick_bytes else "bytes",
                             events=len(want), half_stencil_candidates=candidates, rows=real,
                             candidates_a_row_mean=candidates / max(real, 1),
                             candidates_a_row_max=int(per_row.max()),
                             wrapper_ms=tick_wrapper_ms),
        "step_rest": dict(ms=rest_ms, plain_ms=rest_plain_ms, bound_ms=rest_bytes,
                          bound_by="bytes", replicas=replicas, beads=n,
                          launch="bonds + nucleolar rows + wall + update + ODE"),
        "bd_update": dict(ms=update_ms, plain_ms=update_plain_ms, bound_ms=update_bytes,
                          bound_by="bytes", replicas=replicas, beads=n,
                          launch="with the displacement limit"),
    }
    phase("time", f"{label}: tick kernel {tick_ms:.4f} ms, its wrapper "
                  f"with the count read back {tick_wrapper_ms:.4f} ms ({len(want)} pairs, {candidates} "
                  f"half-stencil candidates; plain {tick_plain_ms:.2f} ms, bound "
                  f"{max(tick_ops, tick_bytes):.5f} ms); rest kernel, G1 launch {rest_ms:.4f} ms "
                  f"(plain {rest_plain_ms:.3f} ms, bound {rest_bytes:.5f} ms); update kernel "
                  f"with its limit {update_ms:.4f} ms (plain {update_plain_ms:.3f} ms, bound "
                  f"{update_bytes:.5f} ms)")
    return timed


def zero_temperature_steps(model, x0, semiaxes0):
    """STEP_STEPS G1 steps at T = 0 from ``x0`` through the kernels
    (``_bd_step4`` on the card), each held against the plain composition's
    step from the same state (within STEP_TOLERANCE of max|x|); then the
    whole plain trajectory against the kernels' beside a twin, the kernels'
    trajectory on a grid shifted by a third of a cell (the pair sums in
    another order): float32 rounding grows e-fold every few steps at T = 0,
    so two trajectories part whatever computes them, and the plain one may
    lie no further from the kernels' than TWIN_FACTOR times the twin.
    Returns the largest step error over max|x|."""
    from genome_cycle_tpu_torch.models.interphase import ARRAY_FIELDS, InterphaseModel
    from genome_cycle_tpu_torch.ops import pair_kernels as pk
    from genome_cycle_tpu_torch.ops import step_rest

    c = model.config
    if c.temperature != 0:
        raise ValueError("the comparison runs at T = 0")
    dt = c.timestep
    zeros = torch.zeros_like(x0)

    def plain_step(x, semiaxes, step):
        core, bond = model.scales((step - 1) * dt)
        pair, _ = pk.ab_pair_forces_reference(model.cell_layout(x), model.pair_kernel_params(core))
        rest = step_rest.rest_reference(x, pair, model.bond_rows(bond),
                                        model.wall_rows(semiaxes, core), model.update_rows(zeros))
        return rest.out, rest.semiaxes

    twin_model = InterphaseModel(c, {name: getattr(model, name).cpu().numpy()
                                     for name in ARRAY_FIELDS}, model.settings, x0.device)
    twin_model.bound = model.bound + model.cell / 3
    generator = torch.Generator(device=x0.device)
    kernels = twin = (x0, generator, semiaxes0)
    plain = (x0, semiaxes0)
    worst = worst_semi = 0.0
    for step in range(1, STEP_STEPS + 1):
        x_p, semi_p = plain_step(kernels[0], kernels[2], step)
        kernels = model._bd_step4(kernels, step)
        worst = max(worst, float((kernels[0] - x_p).abs().max() / x_p.abs().max()))
        worst_semi = max(worst_semi, float((kernels[2] - semi_p).abs().max()
                                           / semi_p.abs().max()))
        plain = plain_step(*plain, step)
        twin = twin_model._bd_step4(twin, step)
    moved = float((kernels[0] - x0).abs().max())
    apart = float((plain[0] - kernels[0]).abs().max())
    twin_apart = float((twin[0] - kernels[0]).abs().max())
    phase("step kernels", f"{STEP_STEPS} G1 steps at T = 0 from the relaxed structure: each "
                          f"step through the kernels within {worst:.3e} of max|x| of the plain "
                          f"composition's step from the same state, semiaxes within "
                          f"{worst_semi:.3e} (beads moved up to {moved:.4f}); the plain "
                          f"trajectory ends {apart:.3e} from the kernels', their twin on a "
                          f"shifted grid {twin_apart:.3e} (limit {TWIN_FACTOR:g} times that)")
    if not (worst <= STEP_TOLERANCE and worst_semi <= STEP_TOLERANCE) or moved < 1e-4:
        fail("step kernels", "a G1 step through the kernels left the plain composition's")
    if not apart <= TWIN_FACTOR * twin_apart:
        fail("step kernels", "the plain trajectory parts from the kernels' faster than rounding")
    return worst


# A G1 step as one CUDA graph replay against the eager step: GRAPH_STEPS
# steps a turn, GRAPH_TURNS turns each, from one start and seeds.
GRAPH_STEPS = 200
GRAPH_TURNS = 3
# The share of the main path's G1 steps that must run as graph replays.
GRAPH_SHARE = 0.99


def time_graph_step(label, model, x, semiaxes, step0):
    """A G1 step of ``model`` from ``x`` as one replay of its CUDA graph
    (``_bd_step4``) and as the eager step (``_eager_step``), in turns, each
    turn GRAPH_STEPS steps from the same start on generators seeded alike,
    after one untimed step (the capture): host milliseconds a step to
    enqueue them, wall milliseconds a step to their end, and CUDA-event
    milliseconds a step over them.  The two runs must end equal to the bit.
    Returns the medians."""
    replicas = x.shape[0] if x.dim() == 3 else 1
    runs = {"replay": model._bd_step4, "eager": model._eager_step}
    numbers = {name: [] for name in runs}
    ends = {}
    for _ in range(GRAPH_TURNS):
        for name, fn in runs.items():
            gens = [torch.Generator(device=x.device).manual_seed(k + 1) for k in range(replicas)]
            carry = fn((x.clone(), gens if x.dim() == 3 else gens[0], semiaxes.clone()),
                       step0 + 1)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            for k in range(GRAPH_STEPS):
                carry = fn(carry, step0 + 2 + k)
            stop.record()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            numbers[name].append(((t1 - t0) * 1e3 / GRAPH_STEPS, (t2 - t0) * 1e3 / GRAPH_STEPS,
                                  start.elapsed_time(stop) / GRAPH_STEPS))
            ends[name] = (carry[0].clone(), carry[2].clone())
    medians = {name: [float(np.median(column)) for column in zip(*rows)]
               for name, rows in numbers.items()}
    same = all(torch.equal(a, b) for a, b in zip(ends["replay"], ends["eager"]))
    (r_host, r_wall, r_events), (e_host, e_wall, e_events) = medians["replay"], medians["eager"]
    phase("graph", f"{label}: a G1 step as one graph replay {r_host:.4f} ms of host to "
                   f"enqueue, {r_wall:.4f} ms of wall, {r_events:.4f} ms by CUDA events; the "
                   f"eager step {e_host:.4f} / {e_wall:.4f} / {e_events:.4f} ms ({e_wall / r_wall:.2f} "
                   f"times the replay's wall; medians of {GRAPH_TURNS} turns of {GRAPH_STEPS} "
                   f"steps in turns); the two runs equal to the bit: {same}")
    if not same:
        fail("graph", f"{label}: the replays and the eager steps part")
    return dict(replay_host_ms=r_host, replay_wall_ms=r_wall, replay_events_ms=r_events,
                eager_host_ms=e_host, eager_wall_ms=e_wall, eager_events_ms=e_events,
                steps=GRAPH_STEPS, turns=GRAPH_TURNS, equal_to_the_bit=same)


def check_graph_share(name, since):
    """The share of the G1 steps on the card that ran as graph replays in
    the counters' increase ``since``; fails below GRAPH_SHARE."""
    replays = since.get("graph.step_replays", 0)
    eager = since.get("graph.step_eager", 0)
    share = replays / max(replays + eager, 1)
    phase(name, f"G1 steps as CUDA graph replays: graph.step_replays / (replays + eager) = "
                f"{replays} / {replays + eager} = {share:.4f}; graph sets captured "
                f"{since.get('graph.step_captures', 0)}")
    if share < GRAPH_SHARE:
        fail(name, f"{share:.4f} of the G1 steps ran as graph replays, below {GRAPH_SHARE}")
    return dict(replays=replays, eager=eager, share=share,
                captures=since.get("graph.step_captures", 0))


def step_kernel_entries(launches, step_errors, timed, **extra):
    """The step kernels' entries of the kernels line; ``extra`` goes into
    the first one's ``shape``."""
    entries = []
    for name, (source, replaces) in STEP_KERNELS.items():
        t = timed[name]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": step_errors.max_abs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": {k: v for k, v in t.items()
                      if k not in ("ms", "plain_ms", "bound_ms", "bound_by")},
        })
    entries[list(STEP_KERNELS).index("step_rest")]["shape"].update(extra)
    return entries


def step_launch_counts(model, x, semiaxes, step0, generator):
    """Device kernels a G1 step, a relaxation step and a tick start on the
    card, at positions ``x`` (torch.profiler); the G1 steps follow one
    another, as in a run."""
    c = model.config
    state = [(x, generator, semiaxes), step0]

    def g1():
        state[1] += 1
        state[0] = model._bd_step4(state[0], state[1])

    def relax():
        model.relaxation_step((x, generator, semiaxes), 0)

    result = {"g1_step": device_launches(g1, 20), "relaxation_step": device_launches(relax, 20),
              "tick": device_launches(lambda: model.contact_events_tick(x, step0), 5)}
    phase("step kernels", f"device launches: a G1 step {result['g1_step']:.1f}, a relaxation "
                          f"step {result['relaxation_step']:.1f}, a tick (layout and search) "
                          f"{result['tick']:.1f} (torch.profiler)")
    return result



# ---- the mitotic chunk kernel: a phase's sampling_interval steps in one
# launch (csrc/mitotic_chunk.cu) -------------------------------------------------
#
# Held against its plain version (ops/mitotic.py::run_chunk_reference: the
# model's eager forces and the plain update, step after step) at each phase's
# start structure of the cycle: MITOTIC_COLD_STEPS steps at T = 0 in one
# launch within MITOTIC_TOLERANCE (absolute; coordinates of order 1 to 10,
# float32 sums in another order), the plain run's beads moving more than
# MITOTIC_MIN_MOVE in them (so that the tolerance is small beside the motion
# it checks); one step at the phase's temperature on the same standard
# normals within MITOTIC_STEP_TOLERANCE (absolute); the term tables' forces
# (ops/mitotic.py::forces_from_terms_reference) within
# MITOTIC_TABLE_TOLERANCE of max|F| from the model's eager forces, as the CPU
# tests hold them; two launches equal to the bit.  At the
# phase's temperature, MITOTIC_SEEDS runs of MITOTIC_STAT_STEPS steps through
# the kernel and as many through the eager step: the mean kinetochore-pole
# distance, radius of gyration and chain-bond second moment at the end agree
# when |mean_1 - mean_2| <= MITOTIC_SIGMAS * sqrt(se_1^2 + se_2^2), se the
# standard error of a mean over the seeds.
MITOTIC_KERNEL = ("genome_cycle_tpu_torch/csrc/mitotic_chunk.cu",
                  "JAX: XLA-fused lax.scan of model.step over a sampling_interval chunk, "
                  "genome_cycle_tpu/models/anatelophase.py:185 and "
                  "genome_cycle_tpu/models/prometaphase.py:193")
MITOTIC_PHASES = ("anaphase", "telophase", "prometaphase")
MITOTIC_COLD_STEPS = 200
MITOTIC_TOLERANCE = 1e-4
MITOTIC_STEP_TOLERANCE = 1e-5
MITOTIC_MIN_MOVE = 0.05
MITOTIC_TABLE_TOLERANCE = 1e-5
MITOTIC_SEEDS = 8
MITOTIC_STAT_STEPS = 2000
MITOTIC_SIGMAS = 4.0


def check_chunk_launches(name, counts, m):
    """One chunk-kernel launch a ``sampling_interval`` of every mitotic
    phase's steps, and nothing else."""
    chunks = sum(getattr(m, f"{p}_steps") // m.sampling_interval for p in MITOTIC_PHASES)
    phase(name, f"mitotic chunk kernel: {counts['mitotic_chunk']} launches for "
                f"{chunks * m.sampling_interval} mitotic steps ({chunks} chunks of "
                f"{m.sampling_interval})")
    if counts["mitotic_chunk"] != chunks:
        fail(name, f"{counts['mitotic_chunk']} mitotic chunk-kernel launches, expected {chunks}")


def check_frames_overlapped(name, counts, m):
    """Every mitotic frame but a stage's last written while the next chunk
    ran: ``mitotic.frames_overlapped`` one a chunk."""
    chunks = sum(getattr(m, f"{p}_steps") // m.sampling_interval for p in MITOTIC_PHASES)
    overlapped = counts.get("mitotic.frames_overlapped", 0)
    phase(name, f"mitotic frames written while the next chunk ran: {overlapped} of "
                f"{chunks + len(MITOTIC_PHASES)}")
    if overlapped != chunks:
        fail(name, f"{overlapped} mitotic frames overlapped, expected {chunks}")


def mitotic_starts(store, config, device):
    """Each mitotic phase's model and start structure (its frame 0) in
    ``store``, with what the checks need: the phase's terms, chunk, eager
    step, kinetochores and their poles."""
    from genome_cycle_tpu_torch.models.anatelophase import AnatelophaseModel
    from genome_cycle_tpu_torch.models.prometaphase import PrometaphaseModel

    ana = AnatelophaseModel.from_design(store.load_anatelophase_design(), config, device)
    pro = PrometaphaseModel.from_design(store.load_prometaphase_design(), config, device)
    starts = {}
    for stage in MITOTIC_PHASES:
        store.set_stage(stage)
        x = torch.as_tensor(store.load_positions(0), dtype=torch.float32, device=device)
        if stage == "prometaphase":
            starts[stage] = dict(model=pro, x=x, terms=pro.mitotic_terms(), chunk=pro.run_chunk,
                                 step=pro.step, kinetochores=pro.kfiber_kinetochores,
                                 poles=pro.kfiber_poles)
            continue
        telophase = stage == "telophase"
        starts[stage] = dict(
            model=ana, x=x, terms=ana.mitotic_terms(telophase),
            chunk=lambda c, steps, t=telophase: ana.run_chunk(c, steps, t),
            step=lambda c, k, t=telophase: ana.step(c, k, t),
            kinetochores=ana.kinetochores,
            poles=ana.pole.reshape(1, 3).expand(len(ana.kinetochores), 3))
    return starts


def time_chunk(fn):
    """Milliseconds of one call of ``fn`` by CUDA events on the current
    stream: the card's time for a kernel of milliseconds, the host's pace for
    a chunk of eager steps."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def mitotic_observables(x, start):
    """Mean kinetochore-pole distance, radius of gyration and chain-bond
    second moment of positions ``x``."""
    model = start["model"]
    pairs = model.bond_pairs
    bonds = x[pairs[:, 0]] - x[pairs[:, 1]]
    return (float((x[start["kinetochores"]] - start["poles"]).norm(dim=1).mean()),
            float(((x - x.mean(dim=0)) ** 2).sum(dim=1).mean().sqrt()),
            float((bonds * bonds).sum(dim=1).mean()))


def mitotic_statistics(name, start):
    """MITOTIC_SEEDS runs of MITOTIC_STAT_STEPS steps at the phase's
    temperature through the kernel (a chunk a sampling_interval) and through
    the eager step; fails beyond MITOTIC_SIGMAS.  Returns the means and
    standard errors."""
    device = start["x"].device
    m = start["model"].config
    runs = {"kernel": [], "eager": []}
    for seed in range(MITOTIC_SEEDS):
        for label, offset in (("kernel", 1000), ("eager", 2000)):
            generator = torch.Generator(device=device)
            generator.manual_seed(offset + seed)
            carry = (start["x"], generator)
            if label == "kernel":
                for _ in range(MITOTIC_STAT_STEPS // m.sampling_interval):
                    carry = start["chunk"](carry, m.sampling_interval)
            else:
                for k in range(MITOTIC_STAT_STEPS):
                    carry = start["step"](carry, k)
            runs[label].append(mitotic_observables(carry[0], start))
    result = {}
    for column, label in enumerate(("kinetochore_pole_distance", "radius_of_gyration",
                                    "bond_second_moment")):
        a = np.asarray([r[column] for r in runs["kernel"]])
        b = np.asarray([r[column] for r in runs["eager"]])
        se = float(np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b)))
        delta = float(a.mean() - b.mean())
        result[label] = dict(kernel=float(a.mean()), eager=float(b.mean()), delta=delta,
                             se=se, within=abs(delta) <= MITOTIC_SIGMAS * se)
        phase(name, f"T = {m.temperature}: {label} after {MITOTIC_STAT_STEPS} steps, "
                    f"{MITOTIC_SEEDS} seeds: kernel {a.mean():.6f}, eager step {b.mean():.6f}, "
                    f"difference {delta:.3e}, limit {MITOTIC_SIGMAS:g} x {se:.3e}")
        if not result[label]["within"]:
            fail(name, f"{label}: the kernel's mean is off the eager step's by more than "
                       f"{MITOTIC_SIGMAS:g} standard errors")
    return result


def check_mitotic_kernel(starts, statistics=True):
    """The chunk kernel against its plain version at each phase's start
    structure (see MITOTIC_TOLERANCE), timed against the plain version and
    the eager step in turns (CUDA events, a chunk of sampling_interval steps
    each), with its bound; with ``statistics`` also the T > 0 statistics
    against the eager step.  Fails beyond the tolerances.  Returns each
    phase's numbers."""
    from genome_cycle_tpu_torch.ops import mitotic

    results = {}
    for stage, start in starts.items():
        name = f"mitotic kernel: {stage}"
        model, x, terms = start["model"], start["x"], start["terms"]
        m, n = model.config, model.n
        generator = torch.Generator(device=x.device)
        generator.manual_seed(7)
        noise = torch.randn((MITOTIC_COLD_STEPS, n, 3), generator=generator, device=x.device)
        want = mitotic.run_chunk_reference(x, terms.forces, model.mobility, noise, 0.0,
                                           m.timestep)
        got = mitotic.run_chunk(x, terms, model.mobility, noise, 0.0, m.timestep)
        cold = float((got - want).abs().max())
        moved = float((want - x).abs().max())
        one = noise[:1].contiguous()
        got = mitotic.run_chunk(x, terms, model.mobility, one, m.temperature, m.timestep)
        plain = mitotic.run_chunk_reference(x, terms.forces, model.mobility, one,
                                            m.temperature, m.timestep)
        step_err = float((got - plain).abs().max())
        table = mitotic.forces_from_terms_reference(x, terms)
        eager_forces = terms.forces(x)
        table_err = float((table - eager_forces).abs().max() / eager_forces.abs().max())
        chunk_noise = torch.randn((m.sampling_interval, n, 3), generator=generator,
                                  device=x.device)
        twice = [mitotic.run_chunk(x, terms, model.mobility, chunk_noise, m.temperature,
                                   m.timestep) for _ in range(2)]
        torch.cuda.synchronize()
        bitwise = torch.equal(twice[0], twice[1])
        phase(name, f"{n} beads, {terms.table.shape[1]} term slots a bead, "
                    f"{len(terms.sources)} point sources; {MITOTIC_COLD_STEPS} steps at T = 0 "
                    f"in one launch against the plain version: max|dx| {cold:.3e} (limit "
                    f"{MITOTIC_TOLERANCE:g}), beads moved up to {moved:.4f} (at least "
                    f"{MITOTIC_MIN_MOVE:g}); one step at T = {m.temperature} on the same noise: "
                    f"max|dx| {step_err:.3e}; the tables' forces {table_err:.3e} of max|F| "
                    f"from the eager forces (limit {MITOTIC_TABLE_TOLERANCE:g}); two launches "
                    f"of {m.sampling_interval} steps equal to the bit: {bitwise}")
        if not (cold <= MITOTIC_TOLERANCE and step_err <= MITOTIC_STEP_TOLERANCE and bitwise):
            fail(name, "the chunk kernel differs from its plain version (or from itself)")
        if not moved > MITOTIC_MIN_MOVE:
            fail(name, f"the beads moved {moved} in {MITOTIC_COLD_STEPS} steps: too little "
                       f"for the comparison to show a fault")
        if not table_err <= MITOTIC_TABLE_TOLERANCE:
            fail(name, "the term tables' forces differ from the model's eager forces")

        # -- times: the kernel, the eager step as the stage ran it before,
        # the plain version; in turns.
        def kernel():
            mitotic.run_chunk(x, terms, model.mobility, chunk_noise, m.temperature, m.timestep)

        def eager_steps():
            carry = (x, generator)
            for k in range(m.sampling_interval):
                carry = start["step"](carry, k)

        def plain_chunk():
            mitotic.run_chunk_reference(x, terms.forces, model.mobility, chunk_noise,
                                        m.temperature, m.timestep)

        order = [kernel, eager_steps, plain_chunk]
        order[0]()                                  # the eager ones are warm
        times = [[] for _ in order]
        for k in list(range(len(order))) + list(reversed(range(len(order)))):
            times[k].append(time_chunk(order[k]))
        ms, eager_ms, plain_ms = (float(np.mean(t)) for t in times)
        k_steps = m.sampling_interval
        ops_ms = OPS_DISTANCE_TEST * n * n * k_steps / PEAK_FP32_FLOPS * 1e3
        bytes_ms = ((12 * n * k_steps + 12 * n * 2 + 4 * n + 4 * terms.table.numel()
                     + 16 * terms.fiber_spring.numel()) / PEAK_BYTES_PER_S * 1e3)
        bound = max(ops_ms, bytes_ms)
        phase("time", f"mitotic chunk kernel, {stage}, {n} beads, {k_steps} steps a launch: "
                      f"{ms:.4f} ms ({ms / k_steps * 1e3:.3f} us a step); the eager step "
                      f"{eager_ms / k_steps:.4f} ms a step, the plain version "
                      f"{plain_ms / k_steps:.4f} ms a step; bound {bound:.5f} ms a launch "
                      f"({ops_ms:.5f} operations, {bytes_ms:.5f} bytes), the kernel "
                      f"{ms / bound:.1f} times it on {mitotic.CLUSTER} of the card's SMs")
        results[stage] = dict(
            beads=n, steps_per_launch=k_steps, cluster=mitotic.CLUSTER, ms=ms,
            ms_per_step=ms / k_steps, plain_ms=plain_ms,
            eager_step_ms=eager_ms / k_steps, bound_ms=bound,
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            max_abs_err_t0=cold, moved_t0=moved, max_abs_err_one_step=step_err,
            table_rel_err=table_err, bitwise=bitwise,
            statistics=mitotic_statistics(name, start) if statistics else None)
    return results


def mitotic_kernel_entry(launches, results):
    """The chunk kernel's entry of the kernels line: the prometaphase's
    numbers (1,152 beads at the reference's width) in front, every phase's
    under ``shapes``."""
    main = results["prometaphase"]
    return {
        "name": "mitotic_chunk", "route": "cuda", "source": MITOTIC_KERNEL[0],
        "replaces": MITOTIC_KERNEL[1], "launches": launches,
        "max_abs_err": max(max(r["max_abs_err_t0"], r["max_abs_err_one_step"])
                           for r in results.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "steps_per_launch": main["steps_per_launch"], "shapes": results,
    }

def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="smoke test of the port on one CUDA card")
    parser.add_argument("--production", action="store_true",
                        help="instead: the reference-default production cycle at full width "
                        "through genome_cycle_tpu_torch.production, and its checks")
    depth = parser.add_mutually_exclusive_group()
    depth.add_argument("--g1-steps", type=int, default=PRODUCTION_G1_STEPS,
                       help="with --production: cut the G1 to these steps (a multiple of "
                       "10,000; at least 200,000)")
    depth.add_argument("--seconds", type=float, default=None,
                       help="with --production: cut the G1 to the deepest multiple of 10,000 "
                       "steps that lets the script end within these seconds, by the rates "
                       "of a short calibration run")
    parser.add_argument("--output", default=PRODUCTION_OUTPUT,
                        help="with --production: the directory that keeps summary.json, pc1.tsv, "
                        "aux.json and the production log (the trajectory goes to a scratch "
                        "directory, never there)")
    args = parser.parse_args(argv)
    if args.g1_steps % 10000 or not MIN_G1_STEPS <= args.g1_steps <= PRODUCTION_G1_STEPS:
        parser.error("--g1-steps: a multiple of 10,000 from 200,000 to 700,000")
    return args


def main():
    started = time.perf_counter()
    args = parse_args()
    # ---- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    phase("device", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from genome_cycle_tpu_torch.models.anatelophase import run_anatelophase
    from genome_cycle_tpu_torch.models.interphase import (
        EngineSettings, InterphaseModel, design_arrays, run_interphase,
    )
    from genome_cycle_tpu_torch.models.prometaphase import run_prometaphase
    from genome_cycle_tpu_torch.models.transitions import (
        transition_cycle, transition_prometaphase,
    )
    from genome_cycle_tpu_torch.ops import _build
    from genome_cycle_tpu_torch.ops import pair_kernels as pk
    from genome_cycle_tpu_torch.store import MemoryStore
    from genome_cycle_tpu_torch.utils import tracing

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    sources = ("ab_pair_forces", "contact_tick", "step_rest", "mitotic_chunk", "cell_layout")
    _build.build_all(sources)               # one nvcc a source, all at once
    phase("build", f"{', '.join(s + '.cu' for s in sources)} built in "
                   f"{time.perf_counter() - t0:.1f} s into {_build.build_dir()}")
    for source in sources:
        kernel = ""
        for line in _build.build_log(source).splitlines():
            entry = re.search(r"\d(ab_pair_forces_\w+?_kernel)ILb(\d)E", line) or re.search(
                r"\d+(contact_tick_kernel|step_rest_kernel|drift_limit_kernel|bd_update_kernel"
                r"|mitotic_chunk_kernel|cell_id_kernel|cell_scan_kernel|cell_scatter_kernel"
                r"|cell_gather_kernel)",
                line)
            if entry:
                kernel = entry.group(1) + (
                    " with energy" if entry.lastindex == 2 and entry.group(2) == "1" else "")
            elif "registers" in line or "spill" in line or "error" in line.lower():
                phase("build", f"{kernel}: {line.strip()}")
                if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                    fail("build", f"{kernel} spills registers")

    if args.production:
        g1_steps = args.g1_steps
        if args.seconds is not None:
            g1_steps = fit_g1_steps(args.seconds, started, device)
        production(g1_steps, card, started, device, args.seconds, args.output)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0

    # ---- 3a. kernel against its plain version, small inputs ----------------
    errors = Errors()
    for name, layout, params in small_inputs(pk, device):
        compare(f"kernel: {name}", layout, params, pk, errors)

    # ---- 4. main path: one whole cell cycle on the card ----------------------
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    run_log = lambda m: phase("run", m.replace("\t", " "))
    try:
        torch.cuda.reset_peak_memory_stats()
        counted = kernel_launches()
        overlap_before = tracing.counters()
        timings = {}
        phase("depth", f"cut to {json.dumps(CONFIG)}; second cell {json.dumps(CONFIG_NEXT)}")
        store, config = prepare_nucleus(workdir, device, timings)
        phase("store", f"{type(store).__name__}"
                       + ("" if isinstance(store, MemoryStore) else ": HDF5 trajectory file"))
        icfg, m = config.interphase, config.mitotic_phase
        design = store.load_interphase_design()
        n = design.particle_count
        coarse = store.load_anatelophase_design().particle_count
        if (n, coarse) != (EXPECTED_PARTICLES, EXPECTED_COARSE):
            fail("prepare", f"{n} particles and {coarse} coarse beads, expected "
                            f"{EXPECTED_PARTICLES} and {EXPECTED_COARSE}")
        graph_before = tracing.counters()
        final = run_interphase(store, log=run_log, device=device, timings=timings)
        graph_share = check_graph_share("check", tracing.counters_since(graph_before))
        transition_prometaphase(store, log=run_log)
        metaphase = run_prometaphase(store, log=run_log, device=device, timings=timings)
        main_step_launches = kernel_launches(counted)
        launches = main_step_launches["ab_pair_forces"]
        peak_bytes = torch.cuda.max_memory_allocated()

        # ---- what the cycle wrote -------------------------------------------
        telophase = check_anatelophase(store, m)
        store.set_stage("relaxation")
        x_before = store.load_positions(0)
        reach = float(np.linalg.norm(x_before, axis=1).max())
        phase("check", f"relaxation starts from the port's own telophase: {n} particles "
                       f"within {reach:.3f} of the origin (telophase beads within "
                       f"{np.linalg.norm(telophase, axis=1).max():.3f})")
        steps, relax_steps = icfg.steps, icfg.relaxation_steps
        x_relaxed, x_final, ctx = check_output(store, n, icfg)
        if not np.allclose(final, x_final, rtol=1e-4, atol=1e-4):
            fail("check", "returned positions differ from the last stored frame")
        if launches < steps + relax_steps:
            fail("check", f"kernel launched {launches} times on the main path, "
                          f"expected at least {steps + relax_steps}")
        phase("check", f"frames, windows, positions and semiaxes are sound; "
                       f"kernel launches on the main path: {launches}; step kernels "
                       f"{main_step_launches}")
        ticks = (steps // icfg.contactmap_update_interval + 1)
        if main_step_launches["contact_tick"] < ticks \
                or main_step_launches["step_rest"] < steps + relax_steps \
                or main_step_launches["bd_update"] != relax_steps:
            fail("check", f"the step kernels were not launched on the main path: at least "
                          f"{ticks} ticks and {steps + relax_steps} rest launches, and "
                          f"{relax_steps} update launches (the relaxation's only) expected")
        if main_step_launches["cell_layout"] < steps + relax_steps + ticks:
            fail("check", f"the layout kernels were not launched on the main path: at least "
                          f"{steps + relax_steps + ticks} layouts (a step each, a tick each) "
                          f"expected")
        check_chunk_launches("check", main_step_launches, m)
        check_frames_overlapped("check", tracing.counters_since(overlap_before), m)
        x_metaphase = check_prometaphase(store, m)
        if not np.allclose(metaphase, x_metaphase, rtol=1e-4, atol=1e-4):
            fail("check", "returned metaphase positions differ from the last stored frame")
        starts = mitotic_starts(store, config, device)

        # ---- 5. the second cell: hand-off and a short anaphase ---------------
        next_store = open_store(workdir, "cell_1", CONFIG_NEXT, SEED + 1)
        transition_cycle(store, next_store, log=run_log)
        next_timings = {}
        run_anatelophase(next_store, log=run_log, device=device, timings=next_timings)
        check_hand_off(store, next_store, m)
        next_store.close()
        store.close()

        # ---- 6. the ensemble: four replicas in lock-step ---------------------
        phase("depth", f"ensemble of {REPLICAS}: {json.dumps(CONFIG_ENSEMBLE)}")
        ensemble = run_ensemble(workdir, device, run_log)

        # ---- 7. the analysis chain on the ensemble's windows ----------------
        analysis = run_analysis(ensemble["stores"], device, card)
        for replica in ensemble.pop("stores"):
            replica.close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    model = InterphaseModel.from_design(design, config, EngineSettings(), device)

    def layout_of(x_host):
        x = torch.as_tensor(x_host, dtype=torch.float32, device=device)
        model.update_bound(float(x.abs().max()))
        return model.cell_layout(x)

    # ---- 3b. kernel against its plain version, full width --------------------
    p_init = kernel_params(icfg.core_scale_init, icfg)
    compare("kernel: 59,610 beads before relaxation", layout_of(x_before), p_init, pk, errors)
    # ---- 3b (continued): after relaxation, after G1, and the timings --------
    core_final, _ = model.scales(steps * icfg.timestep)
    p_final = kernel_params(core_final, icfg)
    layout_relaxed = layout_of(x_relaxed)
    compare("kernel: 59,610 beads after relaxation", layout_relaxed, p_init, pk, errors)
    layout_final = layout_of(x_final)
    compare("kernel: 59,610 beads after G1", layout_final, p_final, pk, errors)
    layout_timed = {"after G1": check_layout_kernel(
        "59,610 beads after G1", model, torch.as_tensor(x_final, dtype=torch.float32,
                                                         device=device), pk)}

    # The bound counts what these inputs need: the distance test for every
    # candidate, the rest for the pairs in reach.  Beside it, the bound of
    # full arithmetic on every candidate.
    timed = {}
    for label, layout, params in (
        ("before relaxation", layout_of(x_before), p_init),
        ("after relaxation", layout_relaxed, p_init),
        ("after G1", layout_final, p_final),
    ):
        candidates = pk.candidate_pairs(layout)
        in_reach = pk.pairs_in_reach(layout, params)
        ms = time_ms(lambda: pk.ab_pair_forces(layout, params), 20)
        ms_energy = time_ms(lambda: pk.ab_pair_forces(layout, params, True), 20)
        plain_ms = time_ms(lambda: pk.ab_pair_forces_reference(layout, params), 2)
        ops_ms = ((OPS_DISTANCE_TEST * candidates + OPS_IN_REACH * in_reach)
                  / PEAK_FP32_FLOPS * 1e3)
        all_ops_ms = OPS_PER_CANDIDATE * candidates / PEAK_FP32_FLOPS * 1e3
        bytes_ms = (32 * n + 12 * n + 4 * layout.num_cells) / PEAK_BYTES_PER_S * 1e3
        timed[label] = dict(ms=ms, ms_with_energy=ms_energy, plain_ms=plain_ms,
                            candidates=candidates, pairs_in_reach=in_reach,
                            bound_ms=max(ops_ms, bytes_ms),
                            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                            bound_ms_all_candidates=max(all_ops_ms, bytes_ms),
                            cells=layout.num_cells)
        phase("time", f"{label}: {candidates} candidate pairs, {in_reach} in reach, in "
                      f"{layout.num_cells} cells; kernel {ms:.4f} ms (+energy {ms_energy:.4f} ms), "
                      f"plain "
                      f"{plain_ms:.2f} ms, bound {max(ops_ms, bytes_ms):.5f} ms "
                      f"({ops_ms:.5f} operations, {bytes_ms:.5f} bytes; "
                      f"{all_ops_ms:.5f} with every candidate evaluated in full)")
    timed[f"ensemble of {REPLICAS} after G1"] = check_ensemble_kernel(
        ensemble, device, pk, errors)

    # ---- 3c. the step kernels against their plain versions, full width -------
    step_errors = StepErrors()
    semi_init = torch.as_tensor(icfg.wall_semiaxes_init, dtype=torch.float32, device=device)
    semi_final = torch.as_tensor(ctx.wall_semiaxes, dtype=torch.float32, device=device)
    _, bond_final = model.scales(steps * icfg.timestep)
    x_dev = {}
    for label, x_host, core, bond, semi in (
        ("59,610 beads before relaxation", x_before, icfg.core_scale_init, icfg.bond_scale_init,
         semi_init),
        ("59,610 beads after relaxation", x_relaxed, icfg.core_scale_init,
         icfg.bond_scale_init, semi_init),
        ("59,610 beads after G1", x_final, core_final, bond_final, semi_final),
    ):
        x_dev[label] = torch.as_tensor(x_host, dtype=torch.float32, device=device)
        model.update_bound(float(x_dev[label].abs().max()))
        step_timed = check_step_kernels(label, model, x_dev[label], core, bond, semi,
                                        step_errors, time_them=label.endswith("after G1"))
    ens_model = InterphaseModel.from_design(ensemble["design"], ensemble["config"],
                                            EngineSettings(), device)
    x_ens = torch.as_tensor(ensemble["final"], dtype=torch.float32, device=device)
    ens_model.update_bound(float(x_ens.abs().max()))
    layout_timed[f"ensemble of {REPLICAS}"] = check_layout_kernel(
        f"{REPLICAS} x {ensemble['n']:,} beads stacked after G1", ens_model, x_ens, pk)
    ens_icfg = ens_model.config
    ens_core, ens_bond = ens_model.scales(ens_icfg.steps * ens_icfg.timestep)
    ens_timed = check_step_kernels(
        f"{REPLICAS} x {ensemble['n']:,} beads stacked after G1", ens_model, x_ens, ens_core,
        ens_bond, torch.as_tensor(ensemble["semiaxes"], device=device), step_errors,
        time_them=True)
    for name in STEP_KERNELS:
        step_timed[name][f"ensemble of {REPLICAS}"] = ens_timed[name]
    graph_timed = {
        "59,610 beads after G1": time_graph_step(
            "59,610 beads after G1", model, x_dev["59,610 beads after G1"], semi_final, steps),
        f"ensemble of {REPLICAS}": time_graph_step(
            f"{REPLICAS} x {ensemble['n']:,} beads stacked after G1", ens_model, x_ens,
            torch.as_tensor(ensemble["semiaxes"], device=device), ens_icfg.steps),
    }
    cold = InterphaseModel(dataclasses.replace(icfg, temperature=0.0),
                           design_arrays(design, icfg), EngineSettings(), device)
    cold.update_bound(float(x_dev["59,610 beads after relaxation"].abs().max()))
    zero_temperature_steps(cold, x_dev["59,610 beads after relaxation"], semi_init)
    counted = step_launch_counts(model, x_dev["59,610 beads after G1"], semi_final, steps,
                                 torch.Generator(device=device))

    # ---- 3d. the mitotic chunk kernel at the phases' start structures -------
    mitotic_timed = check_mitotic_kernel(starts)
    del starts

    # ---- 8. the multi-device paths, two ranks on this card ------------------
    phase("depth", f"shards: {json.dumps(CONFIG_SHARDS)}; ensemble over the ranks "
                   f"{json.dumps(CONFIG_SHARDS_ENSEMBLE)}")
    shard_dir = tempfile.mkdtemp(prefix="chip_smoke_shards_")
    try:
        shards = run_shards(shard_dir, design, config, x_relaxed, device)
    finally:
        shutil.rmtree(shard_dir, ignore_errors=True)
    errors.max_abs = max(errors.max_abs, shards["kernel_max_abs_err"])
    timed[f"rank 0's local layout, {SHARD_RANKS} ranks"] = shards["local_layout"]

    g1 = timings["g1_seconds"]
    rate = timings["g1_steps"] / g1
    share = [steps * timed[k]["ms"] * 1e-3 / g1 for k in ("after relaxation", "after G1")]
    for stage, beads in (("anaphase", coarse), ("telophase", coarse),
                         ("prometaphase", len(x_metaphase))):
        seconds, count = timings[f"{stage}_seconds"], timings[f"{stage}_steps"]
        phase("rate", f"{stage}: {count / seconds:.2f} steps/s, {beads} beads, over {count} "
                      f"steps ({seconds:.2f} s, host clock around a synchronize)")
    phase("rate", "second cell's anaphase: "
                  f"{next_timings['anaphase_steps'] / next_timings['anaphase_seconds']:.2f} steps/s")
    phase("rate", f"relaxation: {timings['relaxation_steps'] / timings['relaxation_seconds']:.2f} "
                  f"steps/s over {timings['relaxation_steps']} steps")
    phase("rate", f"G1: {rate:.2f} steps/s, {rate * n:.4g} bead-steps/s over "
                  f"{timings['g1_steps']} steps ({g1:.2f} s, host clock around a synchronize)")
    phase("rate", f"G1 share in the pair kernel: {min(share):.4f} to {max(share):.4f} "
                  "(its event time at the first and the last G1 structure times the steps)")
    phase("rate", f"peak device memory allocated: {peak_bytes / 2**20:.1f} MiB")
    beads = REPLICAS * ensemble["n"]
    et = ensemble["timings"]
    for stage, key in (("relaxation", "relaxation"), ("G1", "g1")):
        seconds, count = et[f"{key}_seconds"], et[f"{key}_steps"]
        phase("rate", f"ensemble {stage}: {count / seconds:.2f} steps/s, "
                      f"{count * beads / seconds:.4g} bead-steps/s for {REPLICAS} replicas "
                      f"({beads} beads) over {count} steps ({seconds:.2f} s, host clock around "
                      f"a synchronize); the single run's G1 in this call: {rate:.2f} steps/s, "
                      f"{rate * n:.4g} bead-steps/s")
    phase("rate", f"ensemble: peak device memory allocated "
                  f"{ensemble['peak_bytes'] / 2**20:.1f} MiB")
    phase("rate", f"final wall semiaxes {tuple(round(v, 4) for v in ctx.wall_semiaxes)}, "
                  f"mean energy {ctx.mean_energy:.4f}")

    # ---- 9. the port's CLI into a directory store, killed and resumed ------
    phase("depth", f"store: {json.dumps(CONFIG_STORE)}")
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        stored = run_store_phase(store_dir)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)

    # ---- 10. the statistical gate through the kernel ------------------------
    gate = run_gate(device)

    main_shape = timed["after G1"]
    phase("time", f"whole script, build included: {time.perf_counter() - started:.1f} s "
                  f"(phase analysis {sum(analysis['seconds'].values()):.1f} s on the card, "
                  f"shards {shards['seconds']:.1f} s in the ranks, store {stored['seconds']:.1f} s, "
                  f"gate {gate['chain']['seconds'] + gate['nucleolus']['seconds']:.1f} s)")
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "ab_pair_forces",
        "route": "cuda",
        "source": "genome_cycle_tpu_torch/csrc/ab_pair_forces.cu",
        "replaces": "genome_cycle_tpu/ops/pallas_kernels.py:109",
        "tpu": "ops/pallas_kernels.py::_kernel",
        "launches": launches,
        "launches_ensemble": ensemble["launches"],
        "launches_shards": {"halo": shards["launches"],
                            "replicated": shards["replicated_launches"],
                            "ensemble": shards["ensemble_launches"]},
        "launches_store": stored["launches"],
        "max_abs_err": errors.max_abs,
        "max_rel_err": errors.max_rel,
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "bound_ms_all_candidates": main_shape["bound_ms_all_candidates"],
        "candidates": main_shape["candidates"],
        "library_ms": None,
        "shapes": timed,
        "g1_graph": dict(main_path=graph_share, timed=graph_timed),
    }] + step_kernel_entries(main_step_launches, step_errors, step_timed,
                             device_launches_per_call=counted)
        + [mitotic_kernel_entry(main_step_launches["mitotic_chunk"], mitotic_timed),
           layout_kernel_entry(main_step_launches["cell_layout"], layout_timed)]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
