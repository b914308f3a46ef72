#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``; without a card it exits non-zero and
prints no result.  It

1. names the card (``nvidia-smi``) and the torch/CUDA versions;
2. builds the port's CUDA source from ``genome_cycle_tpu_torch/csrc`` into
   ``build/`` and prints what ``ptxas`` says about its kernels: the pair-force
   kernel the package runs and its first version, kept as a yardstick;
3. holds the kernel's wrapper against its plain PyTorch version on the card
   (and the first version too): at 300 beads, at inputs made for the kernel's
   control flow, and at three structures of the main path's 59,610 particles;
   checks that two launches give the same bits; and times new and first
   version in turns;
4. drives the port's main path at full width, a whole cell cycle of the
   diploid hg38 nucleus at 100 kb per bead through the entry points the CLI
   command ``cycles`` chains — ``run_prepare``, ``run_anatelophase``,
   ``transition_interphase``, ``run_interphase`` (59,610 particles),
   ``transition_prometaphase``, ``run_prometaphase``, all on the card — with
   the depth cut (``CONFIG`` below), and checks what every stage wrote;
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
9. phase "gate": the port's statistical gate against the C++ surrogate
   (``tests/test_torch_correlation.py``, both configurations, each replica
   set in one stacked run through the kernel; the surrogate built with
   ``g++``);
10. prints the card line, a ``{"kernels": [...]}`` line and, last, the result
   line ``{"ok": true, "device": {...}}``.

Any failed phase ends the run with a non-zero exit code.
"""

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
# bead's pair terms in another order), measured in the same call.
SHARD_RANKS = 2
CONFIG_SHARDS = {"interphase": {"steps": 2000, "relaxation_steps": 0,
                                "contactmap_output_window": 1}}
CONFIG_SHARDS_ENSEMBLE = {"interphase": {"steps": 400, "relaxation_steps": 0,
                                         "sampling_interval": 100,
                                         "contactmap_output_window": 2}}
REPLICATED_STEPS = 200
TWIN_FACTOR = 10.0
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
    """The kernel and its first version against the plain version on the same
    layout, and the kernel against itself: two launches must give the same
    bits.  Fails beyond the stated tolerances; `errors` takes the kernel's."""
    f_k, e_k = pk.ab_pair_forces(layout, params, with_energy=True)
    f_again, e_again = pk.ab_pair_forces(layout, params, with_energy=True)
    f_only, _ = pk.ab_pair_forces(layout, params, with_energy=False)
    f_only_again, _ = pk.ab_pair_forces(layout, params, with_energy=False)
    f_1, e_1 = pk._ab_pair_forces_thread_per_bead(layout, params, with_energy=True)
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
    for label, f, e in (("kernel", f_k, float(e_k)), ("first version", f_1, float(e_1))):
        err = float((f - f_p).abs().max())
        e_rel = abs(e - e_p) / max(abs(e_p), 1e-30) if e_p else abs(e)
        phase(name, f"{label}: n={layout.n} max|dF|={err:.3e} max|F|={fmax:.3e} "
                    f"E={e:.6e} plain E={e_p:.6e} rel={e_rel:.2e}")
        if not np.isfinite(err) or err > FORCE_TOLERANCE * max(fmax, 1.0):
            fail(name, f"{label}: force error {err} beyond {FORCE_TOLERANCE} * max(|F|, 1)")
        if not e_rel <= ENERGY_TOLERANCE:
            fail(name, f"{label}: energy differs by {e_rel} relative, limit {ENERGY_TOLERANCE}")
        if label == "kernel":
            errors.max_abs = max(errors.max_abs, err)
            errors.max_rel = max(errors.max_rel, err / max(fmax, 1.0))
    err = float((f_k - f_1).abs().max())
    if err > FORCE_TOLERANCE * max(fmax, 1.0):
        fail(name, f"kernel and first version differ by {err}")


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
    from genome_cycle_tpu_torch.ops import pair_kernels as pk
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
    pk.ab_pair_forces.launches = 0
    final = run_ensemble_interphase(stores, log=run_log, device=device, timings=timings)
    launches = pk.ab_pair_forces.launches
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
    finals = []
    for k, store in enumerate(stores):
        _, x_final, ctx = check_output(store, n, icfg)
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
    return dict(final=np.stack(finals), launches=launches, peak_bytes=peak_bytes,
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


def chrom_ranges(bins):
    """{chrom: (first bin, end)} in the order of the bin table, as
    ``Cooler.extent`` gives them for a file written from it."""
    names = list(dict.fromkeys(bins["chrom"].astype(str)))
    ids = bins["chrom"].astype(str).map({name: k for k, name in enumerate(names)}).to_numpy()
    offsets = np.searchsorted(ids, np.arange(len(names) + 1))
    return {name: (int(offsets[k]), int(offsets[k + 1])) for k, name in enumerate(names)}


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
        fail("analysis", "TF32 is on: the power step must run in float32")
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
    ranges = chrom_ranges(hap_bins)
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
    bound_ms = 2 * 4 * nh * kept / PEAK_BYTES_PER_S * 1e3
    # The step's two products apart, on a matrix of the same shape: D v
    # reads rows, Dᵀ w the same memory through the transpose.
    probe = torch.randn(nh, kept, device=device)
    v, w = torch.randn(kept, device=device), torch.randn(nh, device=device)
    mv_ms = time_ms(lambda: torch.mv(probe, v), 20)
    mv_t_ms = time_ms(lambda: torch.mv(probe.T, w), 20)
    del probe
    for name, label in (("cool", "cool (merge)"), ("ice", "ICE, diploid"),
                        ("dephase", "dephase (gather + merge)"), ("ice_haploid", "ICE, haploid"),
                        ("dense", "dense haploid map"), ("pc1", "O/E + PC1")):
        phase("time", f"analysis {label}: {seconds[name] * 1e3:.1f} ms (host clock around a "
                      "synchronize)")
    phase("time", f"analysis power step: {step_ms:.4f} ms over {pc_timings['power_steps']} "
                  f"steps, bound {bound_ms:.4f} ms (2 x 4 x {nh} x {kept} bytes / 3.35 TB/s; "
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
    for r in results:
        for k, target in r["ensemble"]["stores"].items():
            mine, theirs = opened(target), singles[k]
            mine.set_stage("interphase")
            theirs.set_stage("interphase")
            if mine.load_steps() != theirs.load_steps():
                fail("shards", f"ensemble replica {k}: frames {mine.load_steps()}")
            for step in theirs.load_steps():
                worst = max(worst, float(np.abs(mine.load_positions(step)
                                                - theirs.load_positions(step)).max()))
                a, b = mine.load_contacts(step), theirs.load_contacts(step)
                if (a is None) != (b is None) or (a is not None
                                                  and pair_set_difference(a, b) > 0.01 * len(b)):
                    fail("shards", f"ensemble replica {k}: window at step {step} differs")
    ens_launches = [r["ensemble"]["launches"] for r in results]
    ens_steps = CONFIG_SHARDS_ENSEMBLE["interphase"]["steps"]
    phase("shards", f"ensemble of {ranks_n} over {ranks_n} ranks, {ens_steps} G1 steps: every frame within "
                    f"{worst:.3e} of the one-process ensemble, its twin (the replicas in the other "
                    f"order) within {twin_worst:.3e} (limit {TWIN_FACTOR:g} times that); "
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


def run_gate(device, pk):
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
            before = pk.ab_pair_forces.launches
            try:
                numbers, seconds = synchronized(
                    lambda: run(exe, pathlib.Path(tempfile.mkdtemp(dir=workdir)), device))
            except AssertionError:
                fail("gate", f"{name}: {traceback.format_exc().splitlines()[-2].strip()}")
            launches = pk.ab_pair_forces.launches - before
            phase("gate", f"{name}: " + ", ".join(f"{k} {v:.5g}" for k, v in numbers.items())
                          + f"; {launches} kernel launches for {gate.STEPS} steps of "
                          f"{gate.REPLICAS if name == 'chain' else gate.NUC_REPLICAS} "
                          f"replicas; {seconds:.1f} s, surrogate runs included")
            if launches != gate.STEPS:
                fail("gate", f"{name}: {launches} launches, not one a step for all replicas")
            results[name] = dict(numbers, seconds=seconds, launches=launches)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return results


def main():
    started = time.perf_counter()
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
        EngineSettings, InterphaseModel, run_interphase,
    )
    from genome_cycle_tpu_torch.models.prometaphase import run_prometaphase
    from genome_cycle_tpu_torch.models.transitions import (
        transition_cycle, transition_prometaphase,
    )
    from genome_cycle_tpu_torch.ops import _build
    from genome_cycle_tpu_torch.ops import pair_kernels as pk
    from genome_cycle_tpu_torch.store import MemoryStore

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    log = _build.build_log("ab_pair_forces")
    phase("build", f"ab_pair_forces.cu built in {time.perf_counter() - t0:.1f} s "
                   f"into {_build.build_dir()}")
    kernel = ""
    for line in log.splitlines():
        entry = re.search(r"\d(ab_pair_forces_\w+?_kernel)ILb(\d)E", line)
        if entry:
            kernel = entry.group(1) + (" with energy" if entry.group(2) == "1" else "")
        elif "registers" in line or "spill" in line or "error" in line.lower():
            phase("build", f"{kernel}: {line.strip()}")
            if "ab_pair_forces_cell_kernel" in kernel and "spill" in line \
                    and "0 bytes spill stores, 0 bytes spill loads" not in line:
                fail("build", "the kernel spills registers")

    # ---- 3a. kernel against its plain version, small inputs ----------------
    errors = Errors()
    for name, layout, params in small_inputs(pk, device):
        compare(f"kernel: {name}", layout, params, pk, errors)

    # ---- 4. main path: one whole cell cycle on the card ----------------------
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    run_log = lambda m: phase("run", m.replace("\t", " "))
    try:
        torch.cuda.reset_peak_memory_stats()
        pk.ab_pair_forces.launches = 0
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
        final = run_interphase(store, log=run_log, device=device, timings=timings)
        transition_prometaphase(store, log=run_log)
        metaphase = run_prometaphase(store, log=run_log, device=device, timings=timings)
        launches = pk.ab_pair_forces.launches
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
                       f"kernel launches on the main path: {launches}")
        x_metaphase = check_prometaphase(store, m)
        if not np.allclose(metaphase, x_metaphase, rtol=1e-4, atol=1e-4):
            fail("check", "returned metaphase positions differ from the last stored frame")

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

    # New kernel and first version in turns within this run: two runs may land
    # on two cards.  The bound counts what these inputs need: the distance
    # test for every candidate, the rest for the pairs in reach.  Beside it,
    # the bound of full arithmetic on every candidate.
    first_version = pk._ab_pair_forces_thread_per_bead
    timed = {}
    for label, layout, params in (
        ("before relaxation", layout_of(x_before), p_init),
        ("after relaxation", layout_relaxed, p_init),
        ("after G1", layout_final, p_final),
    ):
        candidates = pk.candidate_pairs(layout)
        in_reach = pk.pairs_in_reach(layout, params)
        previous_ms, ms = time_in_turns(
            lambda: first_version(layout, params), lambda: pk.ab_pair_forces(layout, params), 20)
        previous_energy, ms_energy = time_in_turns(
            lambda: first_version(layout, params, True),
            lambda: pk.ab_pair_forces(layout, params, True), 20)
        plain_ms = time_ms(lambda: pk.ab_pair_forces_reference(layout, params), 2)
        ops_ms = ((OPS_DISTANCE_TEST * candidates + OPS_IN_REACH * in_reach)
                  / PEAK_FP32_FLOPS * 1e3)
        all_ops_ms = OPS_PER_CANDIDATE * candidates / PEAK_FP32_FLOPS * 1e3
        bytes_ms = (32 * n + 12 * n + 4 * layout.num_cells) / PEAK_BYTES_PER_S * 1e3
        timed[label] = dict(ms=ms, ms_with_energy=ms_energy, previous_ms=previous_ms,
                            previous_ms_with_energy=previous_energy, plain_ms=plain_ms,
                            candidates=candidates, pairs_in_reach=in_reach,
                            bound_ms=max(ops_ms, bytes_ms),
                            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                            bound_ms_all_candidates=max(all_ops_ms, bytes_ms),
                            cells=layout.num_cells)
        phase("time", f"{label}: {candidates} candidate pairs, {in_reach} in reach, in "
                      f"{layout.num_cells} cells; kernel {ms:.4f} ms (+energy {ms_energy:.4f} ms), "
                      f"first version {previous_ms:.4f} ms (+energy {previous_energy:.4f} ms), "
                      f"{previous_ms / ms:.2f} times the kernel's; plain "
                      f"{plain_ms:.2f} ms, bound {max(ops_ms, bytes_ms):.5f} ms "
                      f"({ops_ms:.5f} operations, {bytes_ms:.5f} bytes; "
                      f"{all_ops_ms:.5f} with every candidate evaluated in full)")
    timed[f"ensemble of {REPLICAS} after G1"] = check_ensemble_kernel(
        ensemble, device, pk, errors)
    pk.ab_pair_forces.launches = launches  # timing launches do not count

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
    pk.ab_pair_forces.launches = launches  # timing launches do not count

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

    # ---- 9. the statistical gate through the kernel -------------------------
    gate = run_gate(device, pk)
    pk.ab_pair_forces.launches = launches  # the gate's launches do not count

    main_shape = timed["after G1"]
    phase("time", f"whole script, build included: {time.perf_counter() - started:.1f} s "
                  f"(phase analysis {sum(analysis['seconds'].values()):.1f} s on the card, "
                  f"shards {shards['seconds']:.1f} s in the ranks, "
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
        "max_abs_err": errors.max_abs,
        "max_rel_err": errors.max_rel,
        "ms": main_shape["ms"],
        "previous_ms": main_shape["previous_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "bound_ms_all_candidates": main_shape["bound_ms_all_candidates"],
        "candidates": main_shape["candidates"],
        "library_ms": None,
        "shapes": timed,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
