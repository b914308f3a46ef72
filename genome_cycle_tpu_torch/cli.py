"""Command-line interface of the PyTorch/CUDA port.

Usage (one trajectory file carries the whole cell cycle, SURVEY.md §3):

    python -m genome_cycle_tpu_torch.cli prepare [-s SEED] -o out.h5 config.json chains.tsv
    python -m genome_cycle_tpu_torch.cli anatelophase [--device cpu] out.h5
    python -m genome_cycle_tpu_torch.cli transition {interphase|prometaphase} out.h5
    python -m genome_cycle_tpu_torch.cli transition cycle prev.h5 next.h5
    python -m genome_cycle_tpu_torch.cli interphase [--device cpu] [--profile DIR] [--shards N] out.h5
    python -m genome_cycle_tpu_torch.cli prometaphase [--device cpu] out.h5
    python -m genome_cycle_tpu_torch.cli simulate [--device cpu] [-s SEED] -o out.h5 config.json chains.tsv
    python -m genome_cycle_tpu_torch.cli cycles -n 3 [--device cpu] [-s SEED] -o prefix config.json chains.tsv
    python -m genome_cycle_tpu_torch.cli ensemble -n 4 [--device cpu] [-s SEED] -o prefix config.json chains.tsv
    python -m genome_cycle_tpu_torch.cli cool [--device cpu] --output sim.cool rep_0.h5 rep_1.h5 ...
    python -m genome_cycle_tpu_torch.cli dephase [--device cpu] --output haploid.cool sim.cool
    python -m genome_cycle_tpu_torch.cli pc1 [--device cpu] --output pc1.tsv [--aux-output aux.json] haploid.cool
    python -m genome_cycle_tpu_torch.cli {nci|annotate|dumpgsd} ...   (as the JAX package's)

`simulate` = prepare + anatelophase + transition interphase + interphase
(scripts/simulate:42-45).  `cycles` runs whole cell cycles one after another,
one file ``<prefix>cell_<k>.h5`` each, seeded SEED + k; the target chromatids
of a cycle's metaphase start the next cycle's anaphase.  `ensemble` prepares
R replicas, one file ``<prefix>rep_<k>.h5`` each, seeded SEED + k, runs
anatelophase and the transition in each, and then their interphase in
lock-step (``parallel/ensemble.py``).

The stages and the analysis commands with device work (``cool``,
``dephase``, ``pc1``) run on the first CUDA card; without one they fail
unless ``--device cpu`` is given.  ``nci``, ``annotate`` and ``dumpgsd`` are
host code and take the JAX package's arguments.  ``interphase --profile DIR``
writes a ``torch.profiler`` trace of the run (chrome trace format) into DIR.

A trajectory is an HDF5 file, or a directory store (one file per HDF5 path,
``store.DirectoryStore``) where the path is an existing directory or ends in
``/``: ``simulate -o cell/ ...`` needs no ``h5py``.  ``dumpgsd`` and the
commands that write or read a ``.cool`` file (``cool``, ``dephase``, ``pc1``,
``nci``, ``annotate``) need ``h5py``.

``interphase --shards N`` decomposes the G1 phase over N ranks, one process
each (``parallel/halo.py``): on ``cuda:0`` ... ``cuda:N-1`` with NCCL, which
raises when there are fewer than N cards; with ``--device cpu`` on the CPU
with gloo; with ``--device cuda:K`` all on that one card, with gloo.  Only
rank 0 opens the trajectory file; with ``--profile`` it traces its own
process.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from .store import open_store
from .utils.logging import log_stderr

ANALYSIS_COMMANDS = {
    "nci": "genome_cycle_tpu_torch.analysis.nci",
    "annotate": "genome_cycle_tpu_torch.analysis.annotate",
    "cool": "genome_cycle_tpu_torch.analysis.cool",
    "dephase": "genome_cycle_tpu_torch.analysis.dephase",
    "pc1": "genome_cycle_tpu_torch.analysis.pc1",
    "dumpgsd": "genome_cycle_tpu_torch.analysis.dumpgsd",
}


def _add_store_cmd(sub, name, help_text, device=False):
    p = sub.add_parser(name, help=help_text)
    p.add_argument("trajectory", help="trajectory: an .h5 file, or a directory store")
    if device:
        _add_device(p)
    return p


def _add_device(p):
    p.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the first CUDA card; "
        "'cpu' must be asked for explicitly)",
    )


def _add_inputs(p, output_name, output_dest):
    _add_device(p)
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("-o", output_name, dest=output_dest, required=True)
    p.add_argument("config")
    p.add_argument("chains")


@contextlib.contextmanager
def _profiled(directory, device):
    """A ``torch.profiler`` trace of the block into ``directory`` (the
    host's operators and, on a CUDA device, the card's kernels), written as
    ``trace.json``; nothing when ``directory`` is None."""
    if directory is None:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import resolve_device

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))


def _interphase_rank(path, profile):
    """``interphase --shards``: one rank of the decomposed run.  Rank 0 opens
    the trajectory, logs and, with ``profile``, traces its process."""
    import torch.distributed as dist

    from .models.interphase import run_interphase
    from .parallel.mesh import make_mesh

    mesh = make_mesh(1, dist.get_world_size())
    if mesh.shard != 0:
        run_interphase(None, log=lambda message: None, mesh=mesh)
        return
    with _profiled(profile, mesh.device), open_store(path) as store:
        run_interphase(store, log=log_stderr, mesh=mesh)


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # The analysis tools keep their own argparse CLIs; forward to them.
    if argv and argv[0] in ANALYSIS_COMMANDS:
        import importlib
        import logging

        from .analysis.common import invoke_main

        module = importlib.import_module(ANALYSIS_COMMANDS[argv[0]])
        old_argv = sys.argv
        sys.argv = list(argv)
        try:
            invoke_main(module.main, module.parse_args(), logging.getLogger())
        finally:
            sys.argv = old_argv
        return 0

    parser = argparse.ArgumentParser(
        prog="genome_cycle_tpu_torch",
        description="Whole-genome cell-cycle simulator, PyTorch/CUDA port",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("prepare", help="compile config + chains into a new store")
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("config")
    p.add_argument("chains")

    _add_store_cmd(sub, "anatelophase", "run anaphase + telophase", device=True)
    p = _add_store_cmd(sub, "interphase", "run relaxation + G1 interphase", device=True)
    p.add_argument(
        "--profile", metavar="DIR", default=None,
        help="write a torch.profiler trace of the run into DIR (chrome trace "
        "format; view in chrome://tracing or Perfetto)",
    )
    p.add_argument(
        "--shards", type=int, default=None, metavar="N",
        help="spatially decompose the G1 phase over N ranks, one process each "
        "(x-slab ownership + halo exchange): one CUDA card a rank with NCCL, "
        "or all on --device with gloo; the same output schema as the "
        "single-device run, and with the same seed the same noise",
    )
    _add_store_cmd(sub, "prometaphase", "run prometaphase/metaphase", device=True)

    p = sub.add_parser("transition", help="convert structures between stages")
    tsub = p.add_subparsers(dest="mode", required=True)
    _add_store_cmd(tsub, "interphase", "telophase -> relaxation initial structure")
    _add_store_cmd(tsub, "prometaphase", "interphase -> prometaphase initial structure")
    pc = tsub.add_parser("cycle", help="metaphase of prev -> anaphase of next")
    pc.add_argument("prev")
    pc.add_argument("next")

    p = sub.add_parser("simulate", help="prepare + anatelophase + interphase")
    _add_inputs(p, "--output", "output")

    p = sub.add_parser("cycles", help="multi-cycle experiment (one file per cycle)")
    p.add_argument("-n", "--cycles", type=int, default=3)
    _add_inputs(p, "--output-prefix", "output_prefix")

    p = sub.add_parser(
        "ensemble",
        help="R replica interphase runs in lock-step, one trajectory file each",
    )
    p.add_argument("-n", "--replicas", type=int, default=4)
    _add_inputs(p, "--output-prefix", "output_prefix")

    sub.add_parser(
        "analysis-help",
        help="analysis tools: " + ", ".join(ANALYSIS_COMMANDS),
    )

    args = parser.parse_args(argv)
    log = log_stderr

    from .models import transitions
    from .models.anatelophase import run_anatelophase
    from .models.interphase import run_interphase
    from .models.prepare import run_prepare
    from .models.prometaphase import run_prometaphase

    if args.command == "prepare":
        run_prepare(args.output, args.config, args.chains, args.seed, log=log)

    elif args.command == "anatelophase":
        with open_store(args.trajectory) as store:
            run_anatelophase(store, log=log, device=args.device)

    elif args.command == "interphase":
        if args.shards is not None and args.shards > 1:
            from .parallel.mesh import rank_devices, spawn

            devices = rank_devices(args.shards, args.device)
            spawn(_interphase_rank, args.shards, devices, None, args.trajectory, args.profile)
        else:
            with _profiled(args.profile, args.device), open_store(args.trajectory) as store:
                run_interphase(store, log=log, device=args.device)

    elif args.command == "prometaphase":
        with open_store(args.trajectory) as store:
            run_prometaphase(store, log=log, device=args.device)

    elif args.command == "transition":
        if args.mode == "interphase":
            with open_store(args.trajectory) as store:
                transitions.transition_interphase(store, log=log)
        elif args.mode == "prometaphase":
            with open_store(args.trajectory) as store:
                transitions.transition_prometaphase(store, log=log)
        else:
            with open_store(args.prev) as prev, open_store(args.next) as nxt:
                transitions.transition_cycle(prev, nxt, log=log)

    elif args.command == "simulate":
        run_prepare(args.output, args.config, args.chains, args.seed, log=log)
        with open_store(args.output) as store:
            run_anatelophase(store, log=log, device=args.device)
            transitions.transition_interphase(store, log=log)
            run_interphase(store, log=log, device=args.device)

    elif args.command == "cycles":
        prev_path = None
        for k in range(args.cycles):
            path = f"{args.output_prefix}cell_{k}.h5"
            seed = None if args.seed is None else args.seed + k
            log(f"=== cycle {k}: {path} ===")
            run_prepare(path, args.config, args.chains, seed, log=log)
            if prev_path is not None:
                with open_store(prev_path) as prev, open_store(path) as nxt:
                    transitions.transition_cycle(prev, nxt, log=log)
            with open_store(path) as store:
                run_anatelophase(store, log=log, device=args.device)
                transitions.transition_interphase(store, log=log)
                run_interphase(store, log=log, device=args.device)
                transitions.transition_prometaphase(store, log=log)
                run_prometaphase(store, log=log, device=args.device)
            prev_path = path

    elif args.command == "ensemble":
        from .parallel.ensemble import run_ensemble_interphase

        paths = [f"{args.output_prefix}rep_{k}.h5" for k in range(args.replicas)]
        for k, path in enumerate(paths):
            seed = None if args.seed is None else args.seed + k
            log(f"=== replica {k}: {path} ===")
            run_prepare(path, args.config, args.chains, seed, log=log)
            with open_store(path) as store:
                run_anatelophase(store, log=log, device=args.device)
                transitions.transition_interphase(store, log=log)
        log(f"=== ensemble interphase: {args.replicas} replicas in lock-step ===")
        with contextlib.ExitStack() as stack:
            stores = [stack.enter_context(open_store(path)) for path in paths]
            run_ensemble_interphase(stores, log=log, device=args.device)

    elif args.command == "analysis-help":
        print("analysis tools: " + ", ".join(ANALYSIS_COMMANDS)
              + " (each takes --help)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
