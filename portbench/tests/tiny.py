"""A tiny cell for the benchmark's CPU tests: two chains of 400 beads (a
centromere each, an active NOR on the first), the stages cut to hundreds of steps,
a frame every 100 steps and a window every 2 frames.  The program runs its
plain versions on the CPU."""

from __future__ import annotations

import json
import os

from portbench import harness


def _params(workload: str) -> dict:
    with open(os.path.join(harness.HERE, "workloads", f"{workload}.json")) as f:
        return json.load(f)


# The parameters and limits of the production cells, so that the faults the
# tests plant are held to the numbers the benchmark decides ``correct`` by.
PARAMS_G1 = _params("g1-100kb")
PARAMS_MITOTIC = _params("mitotic-100kb")
SIMULATION = {
    "mitotic_phase": {"anaphase_steps": 400, "telophase_steps": 200, "prometaphase_steps": 300,
                      "sampling_interval": 100, "logging_interval": 100, "coarse_graining": 10},
    "interphase": {"steps": 100000, "relaxation_steps": 200, "sampling_interval": 100,
                   "relaxation_sampling_interval": 100, "contactmap_output_window": 2,
                   "logging_interval": 100},
}


def chains_text(beads: int = 400) -> str:
    rows = ["chain\tstart\tend\tA\tB\ttags"]
    for c, name in enumerate(["chr21:a", "chr21:b"]):
        for i in range(beads):
            tag = "cen,B" if beads // 2 - 10 <= i < beads // 2 + 10 else ("A" if i % 2 else "B")
            if i == 5 and c == 0:
                tag = "anor,B"
            a, b = (1, 0) if tag.endswith("A") else (0, 1)
            rows.append(f"{name}\t{i * 100000}\t{(i + 1) * 100000}\t{a}\t{b}\t{tag}")
    return "\n".join(rows) + "\n"


def cell(tmp_path, driver: str, replicas: int = 1, metrics=()) -> harness.Cell:
    """The tiny cell of ``driver`` ("g1" or "mitotic"), its chains written
    under ``tmp_path``, reporting ``metrics`` (names of BENCHMARK.json's
    metrics)."""
    chains = os.path.join(str(tmp_path), "tiny.tsv")
    with open(chains, "w") as f:
        f.write(chains_text())
    config = {"simulation": json.loads(json.dumps(SIMULATION)), "chains": chains,
              "replicas": replicas}
    if driver == "g1":
        traffic = {"driver": "g1"}
        params = json.loads(json.dumps(PARAMS_G1))
    else:
        traffic = {"driver": "mitotic",
                   "setup_interphase": {"interphase": {"steps": 200, "relaxation_steps": 100}},
                   "samples": {"anaphase": 2, "telophase": 1, "prometaphase": 2}}
        params = json.loads(json.dumps(PARAMS_MITOTIC))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        benchmark = json.load(f)
    every = benchmark["end_to_end"] + benchmark["per_layer"]
    chosen = [m for m in every if m["name"] in metrics]
    end_to_end = [m for m in chosen if m in benchmark["end_to_end"]]
    per_layer = [m for m in chosen if m in benchmark["per_layer"]]
    return harness.Cell(f"tiny-{driver}", 1, config, traffic, params, end_to_end, per_layer)


def run(cell: harness.Cell, seed: int = 2 ** 31 + 7, seconds: float = 2.0, trace: bool = False,
        control=None) -> dict:
    """One run of a tiny cell on the CPU (the pair force through the plain
    version of the cell layout, as on the card)."""
    import time

    from genome_cycle_tpu_torch.models.interphase import EngineSettings

    return harness.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                            settings=EngineSettings(brute_force_threshold=0),
                            log=lambda message: None, control=control)
