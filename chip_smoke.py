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
   control flow, and at the production nucleus' 59,610 particles; checks that
   two launches give the same bits; and times new and first version in turns;
4. drives the port's main path at full width — ``run_prepare`` on the diploid
   hg38 nucleus at 100 kb per bead, a telophase frame seeded here (the port
   has no anaphase/telophase yet), ``transition_interphase``,
   ``run_interphase`` on the card — with the depth cut to 2,000 relaxation
   and 10,000 G1 steps, and checks what it wrote;
5. prints the card line, a ``{"kernels": [...]}`` line and, last, the result
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
# Depth cut from the production schedule's 10,000 relaxation and 700,000 G1
# steps; every other field at its default, the width (59,610 particles) uncut.
CONFIG = {"interphase": {"steps": 10000, "relaxation_steps": 2000,
                         "contactmap_output_window": 5}}
SEED = 1
EXPECTED_PARTICLES = 59610

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


def prepare_nucleus(target, config_path):
    """The production nucleus up to the start of the relaxation: prepare, a
    telophase frame seeded here (the port has no anaphase/telophase yet),
    transition to interphase.  Returns (store, config)."""
    from genome_cycle_tpu_torch.models.prepare import run_prepare
    from genome_cycle_tpu_torch.models.transitions import transition_interphase
    from genome_cycle_tpu_torch.store import SimulationStore

    with open(config_path, "w") as f:
        json.dump(CONFIG, f)
    run_prepare(target, config_path, CHAINS, seed=SEED, log=lambda m: phase("prepare", m))
    store = SimulationStore(target) if isinstance(target, str) else target
    config = store.load_config()
    seed_telophase(store, config.mitotic_phase.telophase_packing_radius)
    transition_interphase(store, log=lambda m: None)
    return store, config


def time_in_turns(first, second, repeats):
    """Mean milliseconds of two functions timed first, second, second, first,
    so that a drift of the card's clock falls on both alike."""
    a1, b1 = time_ms(first, repeats), time_ms(second, repeats)
    b2, a2 = time_ms(second, repeats), time_ms(first, repeats)
    return 0.5 * (a1 + a2), 0.5 * (b1 + b2)


def seed_telophase(store, radius, step_length=0.3):
    """Per coarse chain a random walk confined to the ball of ``radius``,
    written as the only telophase frame."""
    rng = np.random.default_rng(SEED)
    design = store.load_anatelophase_design()
    positions = np.zeros((design.particle_count, 3))
    for chain in design.chains:
        direction = rng.normal(size=3)
        point = direction / np.linalg.norm(direction) * radius * rng.uniform() ** (1 / 3)
        for bead in range(chain.start, chain.end):
            positions[bead] = point
            while True:
                direction = rng.normal(size=3)
                trial = point + step_length * direction / np.linalg.norm(direction)
                if np.linalg.norm(trial) <= radius:
                    point = trial
                    break
    store.set_stage("telophase")
    store.save_positions(0, positions)
    store.append_frame(0)
    return design.particle_count


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

    from genome_cycle_tpu_torch.config import parse_config
    from genome_cycle_tpu_torch.models.interphase import (
        EngineSettings, InterphaseModel, run_interphase,
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

    # ---- 4a. main path: prepare, telophase seed, transition ----------------
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        try:
            import h5py  # noqa: F401
            target = os.path.join(workdir, "cell.h5")
            phase("store", "h5py found: HDF5 trajectory file")
        except ImportError:
            target = MemoryStore()
            phase("store", "no h5py: in-memory store (same schema, no file)")
        store, config = prepare_nucleus(target, os.path.join(workdir, "config.json"))
        icfg = config.interphase
        design = store.load_interphase_design()
        n = design.particle_count
        if n != EXPECTED_PARTICLES:
            fail("prepare", f"{n} particles, expected {EXPECTED_PARTICLES}")
        store.set_stage("relaxation")
        x_before = store.load_positions(0)

        model = InterphaseModel.from_design(design, config, EngineSettings(), device)

        def layout_of(x_host):
            x = torch.as_tensor(x_host, dtype=torch.float32, device=device)
            model.update_bound(float(x.abs().max()))
            return model.cell_layout(x)

        # ---- 3b. kernel against its plain version, full width --------------
        p_init = kernel_params(icfg.core_scale_init, icfg)
        compare("kernel: 59,610 beads before relaxation", layout_of(x_before), p_init,
                pk, errors)

        # ---- 4b. main path: relaxation + G1 on the card ---------------------
        torch.cuda.reset_peak_memory_stats()
        pk.ab_pair_forces.launches = 0
        timings = {}
        final = run_interphase(
            store, log=lambda m: phase("run", m.replace("\t", " ")),
            device=device, timings=timings,
        )
        launches = pk.ab_pair_forces.launches
        peak_bytes = torch.cuda.max_memory_allocated()

        steps, relax_steps = icfg.steps, icfg.relaxation_steps
        x_relaxed, x_final, ctx = check_output(store, n, icfg)
        if not np.allclose(final, x_final, rtol=1e-4, atol=1e-4):
            fail("check", "returned positions differ from the last stored frame")
        if launches < steps + relax_steps:
            fail("check", f"kernel launched {launches} times on the main path, "
                          f"expected at least {steps + relax_steps}")
        phase("check", f"frames, windows, positions and semiaxes are sound; "
                       f"kernel launches on the main path: {launches}")
        store.close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

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
