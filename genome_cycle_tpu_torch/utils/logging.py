"""Progress reporting, mirroring the reference's stderr lines.

Reference format: ``[stage] %F %T <tab> step <tab> E: <energy/particle>``
(stage_anatelophase/simulation_driver.cpp:313-327); the interphase driver
adds t and effective radius (stage_interphase/simulation_driver.cpp:52-79).
"""

from __future__ import annotations

import sys
import time


def progress_line(stage: str, step: int, *, t=None, energy=None, radius=None) -> str:
    stamp = time.strftime("%Y-%m-%d %H:%M:%S")
    parts = [f"[{stage}] {stamp}", str(step)]
    if t is not None:
        parts.append(f"t: {t:g}")
    if radius is not None:
        parts.append(f"R: {radius:g}")
    if energy is not None:
        parts.append(f"E: {energy:g}")
    return "\t".join(parts)


def log_stderr(message: str):
    print(message, file=sys.stderr, flush=True)
