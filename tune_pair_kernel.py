#!/usr/bin/env python3
"""Times variants of the pair-force kernel's compile-time constants on one GPU.

    python3 tune_pair_kernel.py [--relax-steps 500] [--steps 200] [--out DIR] [--sass]

``genome_cycle_tpu_torch/csrc/ab_pair_forces.cu`` fixes six constants: threads
a block (``kBlock``), least threads a bead (``kLanes``), beads a shared-memory
tile (``kTile``), whether a short segment gives its beads more lanes
(``kWiden``), the unrolling of a lane's loop (``kUnroll``) and the blocks an SM
must hold (``kMinBlocks``, which caps the registers).  The package builds the
source as it stands.  This script writes, for each variant in ``VARIANTS``, a
copy of the source with other values into ``DIR``, builds and loads it itself,
checks it against the source as it stands, and times the bare launch (CUDA
events, 20 launches, all variants twice: in order and in reverse) on the
production nucleus (59,610 particles, from the port's own anaphase and
telophase as ``chip_smoke.py`` runs them) at four inputs: before the relaxation,
after ``--relax-steps`` relaxation steps, after ``--steps`` G1 steps more, and
that last structure at core scale 1, where the most pairs are in reach.  The
kernel's first version (one thread per bead) is timed beside them, bare and
with the indexed copy that un-sorts its result.  ``--sass`` also writes
``cuobjdump``'s listing of the library the package loads.  Prints one JSON
object and writes it to ``DIR/tune_pair_kernel.json`` (default
``build/profile``).  Needs a CUDA card.
"""

import argparse
import contextlib
import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# (threads, lanes, tile, widen, unroll, least blocks an SM); the first is the
# source as it stands.
VARIANTS = (
    (128, 8, 512, 1, 4, 1), (128, 8, 512, 1, 1, 1), (128, 8, 512, 1, 2, 1),
    (128, 8, 512, 1, 8, 1), (128, 8, 512, 0, 4, 1), (128, 4, 512, 1, 4, 1),
    (128, 16, 512, 1, 4, 1), (128, 32, 512, 0, 4, 1), (128, 8, 256, 1, 4, 1),
    (128, 8, 1000, 1, 4, 1), (64, 8, 512, 1, 4, 1), (256, 8, 512, 1, 4, 1),
    (512, 8, 512, 1, 4, 1), (128, 8, 512, 1, 4, 10), (128, 8, 256, 1, 4, 12),
)


NAMES = ("kBlock", "kLanes", "kTile", "kWiden", "kUnroll", "kMinBlocks")


def build_variant(variant, out_dir, _build):
    """A copy of the kernel's source with the constants of `variant`, built
    with the package's flags.  Returns (library, what ptxas printed)."""
    text = (_build.CSRC / "ab_pair_forces.cu").read_text()
    for name, value in zip(NAMES, variant):
        text, found = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
        if found != 1:
            raise RuntimeError(f"the source does not set {name} exactly once")
    stem = pathlib.Path(out_dir) / ("ab_pair_forces_" + "_".join(map(str, variant)))
    stem.with_suffix(".cu").write_text(text)
    log = _build.compile_source(stem.with_suffix(".cu"), stem.with_suffix(".so"))
    return ctypes.CDLL(str(stem.with_suffix(".so"))), log


@contextlib.contextmanager
def loaded_as_the_kernel(library, _build):
    """Within the block the package's launch function reaches `library`
    instead of the one built from the source as it stands."""
    built = _build._libraries["ab_pair_forces"]
    _build._libraries["ab_pair_forces"] = library
    try:
        yield
    finally:
        _build._libraries["ab_pair_forces"] = built


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--relax-steps", type=int, default=500)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    parser.add_argument("--sass", action="store_true",
                        help="also write cuobjdump's listing of the source as it stands")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_pair_kernel: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda")

    import chip_smoke
    from genome_cycle_tpu_torch import convert
    from genome_cycle_tpu_torch.models.interphase import EngineSettings, InterphaseModel
    from genome_cycle_tpu_torch.ops import _build
    from genome_cycle_tpu_torch.ops import pair_kernels as pk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    os.makedirs(args.out, exist_ok=True)
    store, config = chip_smoke.prepare_nucleus(args.out, device)
    c = config.interphase
    store.set_stage("relaxation")
    model = InterphaseModel.from_design(
        store.load_interphase_design(), config, EngineSettings(), device
    )
    state = convert.state_from_numpy(
        store.load_positions(0), c.wall_semiaxes_init, seed=1, device=device
    )

    def layout_now():
        model.update_bound(float(state[0].abs().max()))
        return model.cell_layout(state[0])

    p_init = chip_smoke.kernel_params(c.core_scale_init, c)
    inputs = [("before relaxation", layout_now(), p_init)]
    for s in range(args.relax_steps):
        state = model.relaxation_step(state, s)
    inputs.append((f"after {args.relax_steps} relaxation steps", layout_now(), p_init))
    for step in range(1, args.steps + 1):
        state = model._bd_step4(state, step)
    core, _ = model.scales(args.steps * c.timestep)
    inputs.append((f"after {args.steps} G1 steps, core scale {core:.4f}", layout_now(),
                   chip_smoke.kernel_params(core, c)))
    inputs.append(("the same structure at core scale 1", inputs[-1][1],
                   chip_smoke.kernel_params(1.0, c)))

    as_built = _build.load_library("ab_pair_forces")
    libraries, registers = {}, {}
    for variant in VARIANTS:
        if variant == VARIANTS[0]:
            libraries[variant], log = as_built, _build.build_log("ab_pair_forces")
        else:
            libraries[variant], log = build_variant(variant, args.out, _build)
        # The kernel's two instantiations (force, force + energy): the ones
        # that use shared memory.  Spills are the line before the registers.
        lines = log.splitlines()
        registers[str(variant)] = [
            line.split("Used ")[1].strip() + "; " + lines[k - 1].strip()
            for k, line in enumerate(lines) if "Used" in line and "smem" in line
        ]
    if args.sass:
        # The machine code of the source as it stands, for counting the
        # instructions of a lane's loop.
        cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
        with open(os.path.join(args.out, "ab_pair_forces.sass"), "w") as f:
            subprocess.run(
                [cuobjdump, "-sass", str(_build.library_path("ab_pair_forces"))],
                stdout=f, check=True)

    def launch(variant, layout, params):
        with loaded_as_the_kernel(libraries[variant], _build):
            return pk._launch(layout, params, False)

    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "particles": model.n, "variants": "threads, lanes, tile, widen, unroll, least blocks an SM",
              "ptxas": registers, "inputs": {}}
    for label, layout, params in inputs:
        reference, _ = pk._launch(layout, params, False)
        limit = chip_smoke.FORCE_TOLERANCE * max(float(reference.abs().max()), 1.0)
        times = {str(v): [] for v in VARIANTS}
        for order in (VARIANTS, VARIANTS[::-1]):
            for variant in order:
                forces, _ = launch(variant, layout, params)
                if float((forces - reference).abs().max()) > limit:
                    chip_smoke.fail("tune", f"variant {variant} disagrees at {label}")
                times[str(variant)].append(chip_smoke.time_ms(
                    lambda: launch(variant, layout, params), 20))
        result["inputs"][label] = {
            "candidates": pk.candidate_pairs(layout),
            "pairs_in_reach": pk.pairs_in_reach(layout, params),
            "cells": layout.num_cells,
            "ms": times,
            "first_version_bare_ms": chip_smoke.time_ms(
                lambda: pk._launch(layout, params, False, thread_per_bead=True), 20),
            "first_version_ms": chip_smoke.time_ms(
                lambda: pk._ab_pair_forces_thread_per_bead(layout, params), 20),
            "wrapper_ms": chip_smoke.time_ms(lambda: pk.ab_pair_forces(layout, params), 20),
        }
    text = json.dumps(result, indent=1)
    print(text)
    with open(os.path.join(args.out, "tune_pair_kernel.json"), "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
