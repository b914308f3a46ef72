"""Run one cell of the benchmark once and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell, its configuration, traffic and
metrics are found by name from ``BENCHMARK.json`` (see ``harness.py``).
With ``--trace 0`` the last line carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics and the profiled sub-window's
breakdown.  Without a CUDA card, or with fewer than the cell asks for, the
run fails and prints no result; so it does if the process loaded JAX or
the JAX package.  The numbers compared with the reference close standard
error, each beside its limit, and the result's ``checks``.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")
# PyTorch's intra-op threads in the run's process (None: PyTorch's own
# default, as the program leaves it); PERF.md gives the measurement behind
# the choice.
THREADS = 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="portbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # Every cache of the run lives at a fixed path inside the checkout; the
    # program builds its CUDA sources into build/ beside its package.
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
    if THREADS is not None:
        os.environ["OMP_NUM_THREADS"] = str(THREADS)
    sys.path.insert(0, ROOT)

    import torch

    from portbench.harness import ForbiddenModules, forbidden_modules, load_cell, run_cell

    if THREADS is not None:
        torch.set_num_threads(THREADS)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell.chips} CUDA card(s), this machine has {count}",
              file=sys.stderr)
        return 2
    try:
        import genome_cycle_tpu_torch  # noqa: F401
    except ImportError as error:
        print(f"portbench: the program is not in this checkout ({error})", file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", _T0)
    except ForbiddenModules as error:
        print(f"portbench: the run loaded {error.args[0]}", file=sys.stderr)
        return 3
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    for name, entry in result["checks"].items():
        print(f"check {name} {entry['value']!r} limit {entry['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
