"""Command-line interface of the PyTorch/CUDA port.

Usage (one trajectory file carries the whole cell cycle, SURVEY.md §3):

    python -m genome_cycle_tpu_torch.cli prepare [-s SEED] -o out.h5 config.json chains.tsv
    python -m genome_cycle_tpu_torch.cli anatelophase [--device cpu] out.h5
    python -m genome_cycle_tpu_torch.cli transition {interphase|prometaphase} out.h5
    python -m genome_cycle_tpu_torch.cli transition cycle prev.h5 next.h5
    python -m genome_cycle_tpu_torch.cli interphase [--device cpu] out.h5
    python -m genome_cycle_tpu_torch.cli prometaphase [--device cpu] out.h5
    python -m genome_cycle_tpu_torch.cli simulate [--device cpu] [-s SEED] -o out.h5 config.json chains.tsv
    python -m genome_cycle_tpu_torch.cli cycles -n 3 [--device cpu] [-s SEED] -o prefix config.json chains.tsv

`simulate` = prepare + anatelophase + transition interphase + interphase
(scripts/simulate:42-45).  `cycles` runs whole cell cycles one after another,
one file ``<prefix>cell_<k>.h5`` each, seeded SEED + k; the target chromatids
of a cycle's metaphase start the next cycle's anaphase.

The stages run on the first CUDA card; without one they fail unless
``--device cpu`` is given.  The other commands of the JAX package's CLI
(ensemble, the analysis tools) are not ported yet: they say so and exit
non-zero.
"""

from __future__ import annotations

import argparse
import sys

from .store import SimulationStore
from .utils.logging import log_stderr

NOT_PORTED = (
    "ensemble", "nci", "annotate", "cool", "dephase", "pc1", "dumpgsd",
    "analysis-help",
)


def _add_store_cmd(sub, name, help_text, device=False):
    p = sub.add_parser(name, help=help_text)
    p.add_argument("trajectory", help="trajectory .h5 file")
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


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in NOT_PORTED:
        log_stderr(
            f"genome_cycle_tpu_torch: '{argv[0]}' is not ported yet; "
            "use the genome_cycle_tpu CLI for it"
        )
        return 2

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
    _add_store_cmd(sub, "interphase", "run relaxation + G1 interphase", device=True)
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
        with SimulationStore(args.trajectory) as store:
            run_anatelophase(store, log=log, device=args.device)

    elif args.command == "interphase":
        with SimulationStore(args.trajectory) as store:
            run_interphase(store, log=log, device=args.device)

    elif args.command == "prometaphase":
        with SimulationStore(args.trajectory) as store:
            run_prometaphase(store, log=log, device=args.device)

    elif args.command == "transition":
        if args.mode == "interphase":
            with SimulationStore(args.trajectory) as store:
                transitions.transition_interphase(store, log=log)
        elif args.mode == "prometaphase":
            with SimulationStore(args.trajectory) as store:
                transitions.transition_prometaphase(store, log=log)
        else:
            with SimulationStore(args.prev) as prev, SimulationStore(args.next) as nxt:
                transitions.transition_cycle(prev, nxt, log=log)

    elif args.command == "simulate":
        run_prepare(args.output, args.config, args.chains, args.seed, log=log)
        with SimulationStore(args.output) as store:
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
                with SimulationStore(prev_path) as prev, SimulationStore(path) as nxt:
                    transitions.transition_cycle(prev, nxt, log=log)
            with SimulationStore(path) as store:
                run_anatelophase(store, log=log, device=args.device)
                transitions.transition_interphase(store, log=log)
                run_interphase(store, log=log, device=args.device)
                transitions.transition_prometaphase(store, log=log)
                run_prometaphase(store, log=log, device=args.device)
            prev_path = path
    return 0


if __name__ == "__main__":
    sys.exit(main())
