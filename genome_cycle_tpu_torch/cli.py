"""Command-line interface of the PyTorch/CUDA port.

Usage (one trajectory file carries the whole cell cycle, SURVEY.md §3):

    python -m genome_cycle_tpu_torch.cli prepare [-s SEED] -o out.h5 config.json chains.tsv
    python -m genome_cycle_tpu_torch.cli transition interphase out.h5
    python -m genome_cycle_tpu_torch.cli interphase [--device cpu] out.h5

``interphase`` runs on the first CUDA card; without one it fails unless
``--device cpu`` is given.  The other commands of the JAX package's CLI
(anatelophase, prometaphase, the other transitions, simulate, cycles,
ensemble, the analysis tools) are not ported yet: they say so and exit
non-zero.
"""

from __future__ import annotations

import argparse
import sys

from .store import SimulationStore
from .utils.logging import log_stderr

NOT_PORTED = (
    "anatelophase", "prometaphase", "simulate", "cycles", "ensemble",
    "nci", "annotate", "cool", "dephase", "pc1", "dumpgsd", "analysis-help",
)


def _not_ported(what: str) -> int:
    log_stderr(
        f"genome_cycle_tpu_torch: '{what}' is not ported yet; "
        "use the genome_cycle_tpu CLI for it"
    )
    return 2


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in NOT_PORTED:
        return _not_ported(argv[0])

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

    p = sub.add_parser("interphase", help="run relaxation + G1 interphase")
    p.add_argument("trajectory", help="trajectory .h5 file")
    p.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the first CUDA card; "
        "'cpu' must be asked for explicitly)",
    )

    p = sub.add_parser("transition", help="convert structures between stages")
    p.add_argument("mode", choices=["interphase", "prometaphase", "cycle"])
    p.add_argument("trajectory", nargs="+", help="trajectory .h5 file")

    args = parser.parse_args(argv)
    log = log_stderr

    if args.command == "prepare":
        from .models.prepare import run_prepare

        run_prepare(args.output, args.config, args.chains, args.seed, log=log)

    elif args.command == "interphase":
        from .models.interphase import run_interphase

        with SimulationStore(args.trajectory) as store:
            run_interphase(store, log=log, device=args.device)

    elif args.command == "transition":
        if args.mode != "interphase":
            return _not_ported(f"transition {args.mode}")
        if len(args.trajectory) != 1:
            parser.error("transition interphase takes one trajectory file")
        from .models.transitions import transition_interphase

        with SimulationStore(args.trajectory[0]) as store:
            transition_interphase(store, log=log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
