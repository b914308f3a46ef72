"""The control of the comparison that decides ``correct``: the plain
reference computed in bfloat16, the precision below the configuration's
float32, put in the program's place.  It has to fail at least one of the
cell's numbers, where the program's own runs pass them all.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 12

runs the cell once a seed in one process (set-up, a short window at the
cell's own load, the reference check) and prints, a line a seed, the
program's numbers and the control's beside each limit.  The benchmark's own
runs never run it; ``tests/test_portbench_run.py`` keeps it at a size a test
holds.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="portbench/control.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    from portbench.harness import load_cell, run_cell

    if not torch.cuda.is_available():
        print("portbench: the control runs on a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    failed_by_control = True
    for seed in (int(s) for s in args.seeds.split(",")):
        result = run_cell(cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                          log=lambda message: None, control=torch.bfloat16)
        program = {k: v["value"] for k, v in result["checks"].items()}
        limits = {k: v["limit"] for k, v in result["checks"].items()}
        control = result["control"]
        fails = sorted(k for k, v in control.items() if v > limits[k])
        failed_by_control &= bool(fails)
        print(json.dumps({"seed": seed, "correct": result["correct"], "program": program,
                          "control": control, "limits": limits, "control_fails": fails}))
    return 0 if failed_by_control else 1


if __name__ == "__main__":
    sys.exit(main())
