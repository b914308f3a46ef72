"""The mitotic cell: the program's own stage drivers,
``models/anatelophase.py::run_anatelophase`` and
``models/prometaphase.py::run_prometaphase``, pass after pass.

Set-up makes the three phases' start structures with the program's stages:
prepare; anaphase + telophase at the configuration's depth (the anaphase's
random rods stay in the store as its start); the relaxation and a G1 cut to
the traffic's ``setup_interphase`` depths; the transition to prometaphase.
The anaphase has built and loaded the chunk kernel, which every phase
launches, so set-up runs no prometaphase: each pass builds its phases'
models and term tables as the first does.  The window then runs passes of
anaphase + telophase + prometaphase from those starts, pass k with the
stage seeds of the k-th next replica of a study, until the first frame
after ``seconds``; the rate of each stage it ran whole closes the log.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import check as checks
from portbench.window import StopWindow


def pass_seeds(seed: int, k: int) -> dict:
    """The stage seeds of pass ``k`` of a run with ``seed``."""
    rng = np.random.default_rng([seed, k])
    return {stage: int(v) for stage, v in zip(("anaphase", "prometaphase"),
                                              rng.integers(0, 2 ** 32, size=2))}


def run(ctx) -> dict:
    from genome_cycle_tpu_torch.models.anatelophase import run_anatelophase
    from genome_cycle_tpu_torch.models.interphase import run_interphase
    from genome_cycle_tpu_torch.models.prometaphase import run_prometaphase
    from genome_cycle_tpu_torch.models.transitions import (
        transition_interphase,
        transition_prometaphase,
    )

    m = ctx.config.mitotic_phase
    store = ctx.prepare(0, overrides=ctx.traffic["setup_interphase"])
    run_anatelophase(store, log=ctx.log, device=ctx.device)
    transition_interphase(store, log=ctx.log)
    run_interphase(store, settings=ctx.settings, log=ctx.log, device=ctx.device)
    transition_prometaphase(store, log=ctx.log)

    w = ctx.window
    w.frame_interval = m.sampling_interval
    depth = {"anaphase": m.anaphase_steps, "telophase": m.telophase_steps,
             "prometaphase": m.prometaphase_steps}
    for stage, count in ctx.traffic["samples"].items():
        chunks = depth[stage] // m.sampling_interval
        for c in w.rng.choice(chunks, size=min(count, chunks), replace=False):
            w.chunk_samples.add((1, stage, (int(c) + 1) * m.sampling_interval))
    w.open()
    try:
        while True:
            w.pass_no += 1
            for stage, seed in pass_seeds(ctx.seed, w.pass_no).items():
                store.set_stage_seed(stage, seed)
            traced = ctx.trace and w.pass_no == 1
            if traced:
                w.collect_frames = True
                w.profile_start()
            run_anatelophase(store, log=ctx.log, device=ctx.device)
            run_prometaphase(store, log=ctx.log, device=ctx.device)
            if traced:
                w.profile_stop()
                w.collect_frames = False
    except StopWindow:
        pass
    for k, stage, rate in w.stage_rates(m.sampling_interval):
        ctx.log(f"portbench: pass {k} {stage} {rate:.1f} steps/s")
    return dict(stores=[store])


def check(ctx, state, systems) -> tuple:
    """(numbers, failed chunks) of the run against the reference
    ``systems`` (a ``reference.mitotic.MitoticSystem`` by phase)."""
    numbers: dict = {}
    failed = 0
    for key in sorted(ctx.window.chunks):
        record = ctx.window.chunks[key]
        if "stored" not in record:
            continue
        got = checks.mitotic_numbers(systems[key[1]], record["x_in"], record["noise"],
                                     record["x_out"], record["stored"])
        failed += int(checks.fold(numbers, got, ctx.limits))
    numbers["samples_missing"] = int(not numbers)
    return numbers, failed


def control(ctx, state, systems, low) -> dict:
    """The numbers of :func:`check` with the reference in the precision of
    ``low`` (a system by phase) put in the program's place."""
    numbers: dict = {}
    for key in sorted(ctx.window.chunks):
        record = ctx.window.chunks[key]
        system = low[key[1]]
        x0 = torch.as_tensor(record["x_in"], device=system.device).to(system.dtype)
        xi = torch.as_tensor(record["noise"], device=system.device).to(system.dtype)
        x_low = system.run(x0, xi).to(torch.float64).cpu().numpy()
        checks.fold(numbers, checks.mitotic_numbers(systems[key[1]], record["x_in"],
                                                    record["noise"], x_low, x_low))
    return numbers
