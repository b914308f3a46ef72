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
6. prints the card line, a ``{"kernels": [...]}`` line and, last, the result
   line ``{"ok": true, "device": {...}}``.

Any failed phase ends the run with a non-zero exit code.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
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
SEED = 1
EXPECTED_PARTICLES = 59610
EXPECTED_COARSE = 576

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


def main():
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
    phase("rate", f"final wall semiaxes {tuple(round(v, 4) for v in ctx.wall_semiaxes)}, "
                  f"mean energy {ctx.mean_energy:.4f}")

    main_shape = timed["after G1"]
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "ab_pair_forces",
        "route": "cuda",
        "source": "genome_cycle_tpu_torch/csrc/ab_pair_forces.cu",
        "replaces": "genome_cycle_tpu/ops/pallas_kernels.py:109",
        "tpu": "ops/pallas_kernels.py::_kernel",
        "launches": launches,
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
