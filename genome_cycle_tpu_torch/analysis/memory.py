"""Compartment memory across consecutive cell cycles, on a torch device.

The port's counterpart of ``examples/memory_analysis.py``, the reference
paper's headline experiment: run N consecutive cycles (``cli cycles -n N``),
derive each cycle's PC1 compartment profile, and measure how strongly the
compartments correlate from one cycle to the next.

    python -m genome_cycle_tpu_torch.analysis.memory [--device D] cell_0.h5 cell_1/ ...

Each trajectory (an HDF5 file or a directory store) gives its haploid PC1
through the chain of ``cool``, ``dephase`` and ``pc1`` with their defaults,
computed in memory on the device (``pc1.pc1_of_trajectories``; no ``.cool``
file, no ``h5py``).  It prints the example's cycle-to-cycle matrix of |r|
(sign-aligned: the sign of PC1 is arbitrary in each run) and its shuffled
control: each adjacent pair again with the second profile bin-permuted,
20 permutations from ``numpy.random.default_rng(0)``, the chance level the
memory signal must exceed.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .cool import add_device_argument
from .pc1 import pc1_of_trajectories

PERMUTATIONS = 20


def profile(trajectory, device=None) -> np.ndarray:
    """The haploid PC1 of one trajectory as float64 (NaN where masked)."""
    _, pc1, _, _, _ = pc1_of_trajectories([trajectory], device)
    return pc1.cpu().numpy().astype(np.float64)


def _abs_r(a: np.ndarray, b: np.ndarray) -> float:
    ok = np.isfinite(a) & np.isfinite(b)
    return abs(float(np.corrcoef(a[ok], b[ok])[0, 1]))


def memory_matrix(profiles) -> tuple[np.ndarray, list[float], list[float]]:
    """(|r| between every two profiles, |r| of each adjacent pair, the
    shuffled control's mean |r| of each adjacent pair)."""
    n = len(profiles)
    matrix = np.asarray([[_abs_r(profiles[i], profiles[j]) for j in range(n)]
                         for i in range(n)])
    rng = np.random.default_rng(0)
    real, control = [], []
    for i in range(n - 1):
        a, b = profiles[i], profiles[i + 1]
        ok = np.isfinite(a) & np.isfinite(b)
        a, b = a[ok], b[ok]
        real.append(abs(float(np.corrcoef(a, b)[0, 1])))
        control.append(np.mean([abs(float(np.corrcoef(a, rng.permutation(b))[0, 1]))
                                for _ in range(PERMUTATIONS)]))
    return matrix, real, control


def main(paths, device=None):
    if len(paths) < 2:
        sys.exit("need at least two cycle trajectories")
    matrix, real, control = memory_matrix([profile(p, device) for p in paths])
    n = len(paths)
    print("\ncycle-to-cycle PC1 correlation (|r|, sign-aligned):")
    print("      " + "  ".join(f"cyc{j}" for j in range(n)))
    for i in range(n):
        print("  ".join([f"cyc{i}"] + [f"{matrix[i, j]:4.2f}" for j in range(n)]))
    print(f"\nadjacent-cycle memory: mean |r| = {np.mean(real):.3f} "
          f"(shuffled-control chance level {np.mean(control):.3f})")
    return matrix, real, control


def parse_args(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="cycle-to-cycle correlation of the compartment (PC1) profile")
    add_device_argument(parser)
    parser.add_argument("paths", metavar="trajectory", nargs="+",
                        help="consecutive cycles' trajectories (.h5 files or directory stores)")
    return vars(parser.parse_args(argv))


if __name__ == "__main__":
    main(**parse_args())
