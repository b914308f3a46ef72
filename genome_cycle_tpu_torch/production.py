"""A whole cell cycle and its compartment profile as one restartable command.

    python -m genome_cycle_tpu_torch.production --output RUN_DIR [--device D] [-s SEED] config.json chains.tsv

The counterpart of ``runs/prod_pipeline.sh``: prepare, anaphase + telophase,
transition to interphase, relaxation + G1, transition to prometaphase,
prometaphase, all through the port's own stage functions into the directory
store ``RUN_DIR/trajectory/`` (``store.DirectoryStore``: no ``h5py`` needed),
then the analysis chain in memory on the same device
(``analysis.pc1.pc1_of_trajectories``: cool -> ICE -> dephase -> ICE -> the
balanced haploid map -> O/E + PC1).  It writes

- ``RUN_DIR/pc1.tsv`` and ``RUN_DIR/aux.json``, the files ``pc1 --output
  pc1.tsv --aux-output aux.json`` writes for the same map;
- ``RUN_DIR/summary.json``: each stage's wall seconds, steps, steps/s,
  peak device memory and the increase of the port's counters
  (``utils/tracing.py``: kernel launches, host syncs, reruns, store bytes
  and files) over it (or that it was skipped), each G1 window this process
  wrote (rows, tick events, accumulator capacity, seconds), the trajectory's
  counts (frames, windows, COO rows, contact events, the largest window) and
  the analysis' counts and seconds.

Running the same command again after a kill continues the run: a stage whose
final frame is in the store is skipped, and the interphase resumes from its
checkpoint, running the relaxation again first (as the JAX driver does; it
draws what it drew the first time).  The loop that runs the command again
belongs to the caller, as in ``runs/prod_pipeline.sh``.  A ``RUN_DIR`` that
holds another run (other config, chains or seed) is refused.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import resolve_device
from .store import open_store
from .topology import derive_stage_seeds
from .utils import tracing
from .utils.logging import log_stderr

STORE_NAME = "trajectory"


def store_path(output: str) -> str:
    """The directory store of a run directory."""
    return os.path.join(output, STORE_NAME) + "/"


def _prepared(path: str, config_path: str, chains_path: str, seed) -> bool:
    """Whether ``path`` holds a finished prepare of these inputs; raises
    when it holds another run's."""
    if not os.path.isdir(path):
        return False
    with open_store(path, "r") as store:
        if not all(store._has(f"/stages/{stage}/metadata/seed")
                   for stage in derive_stage_seeds(0)):
            return False
        with open(config_path) as f, open(chains_path) as g:
            same = (store._get_text("/metadata/config_source") == f.read()
                    and store.load_chains_source() == g.read()
                    and (seed is None or store.load_master_seed() == seed))
    if not same:
        raise ValueError(f"{path} holds another run (config, chains or seed differ)")
    return True


def _has_final_frame(store, stage: str, step: int) -> bool:
    store.set_stage(stage)
    return step in store.load_steps()


def _window_counts(store) -> dict:
    """Frames and windows of the stored G1 and the sums over its windows."""
    store.set_stage("interphase")
    steps = store.load_steps()
    rows, events, largest, windows = 0, 0, 0, 0
    for step in steps:
        coo = store.load_contacts(step)
        if coo is None:
            continue
        windows += 1
        rows += len(coo)
        events += int(coo[:, 2].astype(np.int64).sum())
        largest = max(largest, len(coo))
    return dict(frames=len(steps), windows=windows, coo_rows=rows, contact_events=events,
                largest_window_rows=largest)


def run_production(output: str, config_path: str, chains_path: str, seed=None,
                   device=None, log=log_stderr) -> dict:
    """Run (or continue) the pipeline into ``output``; returns the summary
    that it also writes to ``output/summary.json``."""
    from .analysis.pc1 import pc1_of_trajectories, write_pc1
    from .models import transitions
    from .models.anatelophase import run_anatelophase
    from .models.interphase import run_interphase
    from .models.prepare import run_prepare
    from .models.prometaphase import run_prometaphase

    device = resolve_device(device)
    cuda = device.type == "cuda"
    os.makedirs(output, exist_ok=True)
    path = store_path(output)
    stages: dict[str, dict] = {}

    def clock():
        if cuda:
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def stage(name, done, fn):
        """Run stage ``name`` unless ``done``; record its seconds, steps,
        peak device memory (the counts from ``fn``'s timings) and the
        counters' increase."""
        if done:
            log(f"=== {name}: done before, skipped ===")
            stages[name] = {"skipped": True}
            return
        log(f"=== {name} ===")
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        timings = {}
        counts = tracing.counters()
        started = clock()
        fn(timings)
        entry = {"seconds": clock() - started, "counters": tracing.counters_since(counts)}
        for key in [k for k in timings if k.endswith("_seconds")]:
            phase = key[: -len("_seconds")]
            steps = timings[phase + "_steps"]
            entry[phase] = dict(seconds=timings[key], steps=steps,
                                steps_per_s=steps / timings[key] if timings[key] else None)
        for key in ("windows", "grid_bound"):
            if key in timings:
                entry[key] = timings[key]
        if cuda:
            entry["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        stages[name] = entry

    prepared = _prepared(path, config_path, chains_path, seed)
    stage("prepare", prepared,
          lambda t: run_prepare(path, config_path, chains_path, seed, log=log))
    with open_store(path) as store:
        config = store.load_config()
        m, c = config.mitotic_phase, config.interphase
        stage("anatelophase", _has_final_frame(store, "telophase", m.telophase_steps),
              lambda t: run_anatelophase(store, log=log, device=device, timings=t))
        store.set_stage("relaxation")
        stage("transition interphase", store.check_positions(0),
              lambda t: transitions.transition_interphase(store, log=log))
        g1_done = _has_final_frame(store, "interphase", c.steps)
        if g1_done:
            store.clear_checkpoint()
        stage("interphase", g1_done,
              lambda t: run_interphase(store, log=log, device=device, timings=t))
        store.set_stage("prometaphase")
        stage("transition prometaphase", store.check_positions(0),
              lambda t: transitions.transition_prometaphase(store, log=log))
        stage("prometaphase", _has_final_frame(store, "prometaphase", m.prometaphase_steps),
              lambda t: run_prometaphase(store, log=log, device=device, timings=t))
        trajectory = _window_counts(store)
        seed_used = store.load_master_seed()
        particles = store.load_interphase_design().particle_count

        log("=== analysis: cool -> ICE -> dephase -> ICE -> dense map -> O/E + PC1 ===")
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        analysis = {}
        bins, pc1, ev1, evr, expected = pc1_of_trajectories([store], device, analysis)
    if cuda:
        analysis["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    analysis["explained_variance_ratio"] = evr
    write_pc1(os.path.join(output, "pc1.tsv"), bins, pc1, ev1, evr, expected,
              os.path.join(output, "aux.json"))

    summary = dict(
        store=path, device=str(device),
        card=torch.cuda.get_device_name(device) if cuda else None,
        seed=int(seed_used), particles=particles,
        depth=dict(anaphase=m.anaphase_steps, telophase=m.telophase_steps,
                   relaxation=c.relaxation_steps, g1=c.steps,
                   prometaphase=m.prometaphase_steps,
                   sampling_interval=c.sampling_interval,
                   window_frames=c.contactmap_output_window,
                   tick_interval=c.contactmap_update_interval),
        stages=stages, trajectory=trajectory, analysis=analysis,
    )
    with open(os.path.join(output, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    log(f"=== done: {trajectory['frames']} G1 frames, {trajectory['windows']} windows, "
        f"{trajectory['coo_rows']} COO rows, {trajectory['contact_events']} contact events; "
        f"{analysis['pixels']} pixels, {analysis['haploid_bins']} haploid bins, "
        f"{analysis['kept']} kept by PC1 ===")
    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="genome_cycle_tpu_torch.production",
        description="a whole cell cycle into a directory store, then its PC1 "
        "profile; running it again continues a killed run",
    )
    parser.add_argument("--output", required=True, metavar="RUN_DIR",
                        help="run directory: the store RUN_DIR/trajectory/, pc1.tsv, "
                        "aux.json, summary.json")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA card; 'cpu' must be "
                        "asked for explicitly)")
    parser.add_argument("-s", "--seed", type=int, default=None)
    parser.add_argument("config")
    parser.add_argument("chains")
    args = parser.parse_args(argv)
    run_production(args.output, args.config, args.chains, args.seed, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
