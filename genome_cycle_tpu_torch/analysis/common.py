"""CLI helpers shared by the analysis tools (reference: src/pkg/common/);
the port's copy of ``genome_cycle_tpu.analysis.common``."""

from __future__ import annotations

import logging
import os
import signal
import sys


def remove_none(mapping: dict) -> dict:
    """Drop None values so CLI omissions fall through to Python defaults
    (pkg/common/args.py:1-2)."""
    return {k: v for k, v in mapping.items() if v is not None}


def invoke_main(main, kwargs: dict, log: logging.Logger):
    """Run an analysis main() with uniform logging and SIGINT/SIGPIPE-correct
    exit codes (pkg/common/cli.py:16-33)."""
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s"
    )
    try:
        main(**kwargs)
    except KeyboardInterrupt:
        signal.signal(signal.SIGINT, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGINT)
    except BrokenPipeError:
        sys.exit(128 + signal.SIGPIPE)
