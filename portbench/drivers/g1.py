"""The G1 cells: the program's own interphase driver, alone
(``models/interphase.py::run_interphase``) or for R replicas in lock-step
(``parallel/ensemble.py::run_ensemble_interphase``).

Set-up is what a user's cycle does before G1, for each replica: prepare,
anaphase + telophase at the configuration's depth, the transition to
interphase; then the driver's relaxation and its G1 up to the first window
dump.  That dump and its checkpoint are the warm-up (the chunk, ticks,
merge, frame, checkpoint and ``WindowAccumulator.take`` have all run once);
the window opens when the checkpoint is written and closes at the first
frame after ``seconds``.  The configuration's G1 depth is the production
one, so the driver never ends on its own inside a window.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import check as checks
from portbench.window import StopWindow


def run(ctx) -> dict:
    from genome_cycle_tpu_torch.models.anatelophase import run_anatelophase
    from genome_cycle_tpu_torch.models.interphase import run_interphase
    from genome_cycle_tpu_torch.models.transitions import transition_interphase
    from genome_cycle_tpu_torch.parallel.ensemble import run_ensemble_interphase

    c = ctx.config.interphase
    replicas = ctx.replicas
    stores = [ctx.prepare(k) for k in range(replicas)]
    for store in stores:
        run_anatelophase(store, log=ctx.log, device=ctx.device)
        transition_interphase(store, log=ctx.log)
    w = ctx.window
    w.frame_interval = c.sampling_interval
    w.start_stage = "interphase"
    w.start_step = c.sampling_interval * c.contactmap_output_window
    if ctx.trace:
        w.profile_at = 2 * w.start_step - c.sampling_interval
    try:
        if replicas == 1:
            run_interphase(stores[0], settings=ctx.settings, log=ctx.log, device=ctx.device)
        else:
            run_ensemble_interphase(stores, settings=ctx.settings, log=ctx.log, device=ctx.device)
    except StopWindow:
        pass
    if not w.closed:
        raise RuntimeError("the G1 ended before the window closed")
    return dict(stores=stores)


def _replica(ctx) -> int:
    """The replica whose sampled frame the reference runs, drawn from the
    seed."""
    return int(np.random.default_rng([ctx.seed, 2 ** 21]).integers(ctx.replicas))


def _noise(w, record, n):
    shape = record["x_in"].shape
    dtype = getattr(torch, str(record["x_in"].dtype))
    return lambda step: w.noise(step, shape, dtype).reshape(-1, n, 3)


def _samples(ctx, ref, outputs) -> tuple:
    """Fold the numbers of the window's samples; ``outputs(record, r,
    noise)`` gives what the side under test produced at a sampled step for
    replica ``r`` (x_out, keys) and ``outputs(frame, r, noise_at)`` at the
    sampled frame (x_out, frame, semi, x_at, energy, keys).  Returns
    (numbers, failed, the pairs a window has to hold by step and replica)."""
    w, n, limits = ctx.window, ref.n, ctx.limits
    numbers, failed, sampled = {}, 0, {}
    for record in sorted(w.kept.values(), key=lambda r: r["at"]):
        step, noise = record["at"], _noise(w, record, n)(record["at"])
        over = False
        for r in range(ctx.replicas):
            out = outputs(record, r, noise[r])
            got = {"step_gap": checks.step_gap(ref, step, record["x_in"].reshape(-1, n, 3)[r],
                                               record["semi_in"].reshape(-1, 3)[r], noise[r],
                                               out["x_out"])}
            if "events" in record:
                got["tick_mismatch"], pairs = checks.tick_numbers(ref, step, record["x_out"].reshape(
                    -1, n, 3)[r], out["keys"])
                sampled.setdefault(step, []).append(pairs)
            over |= checks.fold(numbers, got, limits)
        failed += int(over)
    frame = w.frame
    if frame is not None and "events" in frame:
        step, noise_at = frame["at"], _noise(w, frame, n)
        over = False
        for r in range(ctx.replicas):
            out = outputs(frame, r, noise_at)
            got = {}
            got["tick_mismatch"], pairs = checks.tick_numbers(
                ref, step, frame["x_out"].reshape(-1, n, 3)[r], out["keys"])
            sampled.setdefault(step, []).append(pairs)
            if r == _replica(ctx):
                got.update(checks.frame_numbers(
                    ref, frame["first"], step, frame["x_in"].reshape(-1, n, 3)[r],
                    frame["semi_in"].reshape(-1, 3)[r], lambda s: noise_at(s)[r], out))
            over |= checks.fold(numbers, got, limits)
        failed += int(over)
    return numbers, failed, sampled


def check(ctx, state, ref) -> tuple:
    """(numbers, failed samples) of the run against the reference ``ref``."""
    w = ctx.window
    c = ctx.config.interphase
    stores, n = state["stores"], ref.n

    def outputs(record, r, noise):
        out = dict(x_out=record["x_out"].reshape(-1, n, 3)[r],
                   keys=checks.program_keys(record["events"], r, n) if "events" in record else None)
        if record is w.frame:
            out.update(checks.stored_frame(stores[r], record["at"], ctx.replicas))
            out.update(x_at=out["x_out"], semi_at=out["semi"])
        return out

    numbers, failed, sampled = _samples(ctx, ref, outputs)
    window_steps = c.sampling_interval * c.contactmap_output_window
    faults = checks.window_numbers(
        stores, w.dumps, w.start_step, window_steps,
        window_steps // c.contactmap_update_interval, w.last_step, sampled)
    numbers["window_mismatch"] = faults
    numbers["samples_missing"] = int(not w.kept or w.frame is None or "events" not in w.frame)
    failed += int(faults > 0)
    return numbers, failed


def control(ctx, state, ref, low) -> dict:
    """The numbers of :func:`check` with the reference in ``low``'s
    precision put in the program's place: its steps, its run over the frame
    and its wall from the same inputs, its tick and energy at the
    program's positions."""
    w = ctx.window
    n = ref.n

    def low_t(array):
        return torch.as_tensor(np.asarray(array, np.float64), device=low.device).to(low.dtype)

    def host(tensor):
        return tensor.to(torch.float64).cpu().numpy()

    def outputs(record, r, noise):
        x_in = low_t(record["x_in"].reshape(-1, n, 3)[r])
        semi_in = low_t(record["semi_in"].reshape(-1, 3)[r])
        x_prog = record["x_out"].reshape(-1, n, 3)[r]
        keys = (low.contacts(low_t(x_prog), record["at"], checks.BAND)[0]
                if "events" in record else None)
        if record is not w.frame:
            x_low, _, _ = low.step(x_in, semi_in, noise.to(low.dtype), record["at"])
            return dict(x_out=host(x_low), keys=keys)
        if r != _replica(ctx):
            return dict(x_out=x_prog, keys=keys)
        x_low, semi_low = low.run(x_in, semi_in, lambda s: noise(s)[r].to(low.dtype),
                                  record["first"], record["at"] - record["first"] + 1)
        semi_prog = record["semi_out"].reshape(-1, 3)[r]
        energy = (float(low.mean_energy(low_t(x_prog), low_t(semi_prog), record["at"]))
                  if ctx.replicas == 1 else None)
        return dict(x_out=host(x_low), frame=host(x_low), semi=host(semi_low), x_at=x_prog,
                    semi_at=semi_prog, energy=energy, keys=keys)

    return _samples(ctx, ref, outputs)[0]


def profile_frames(ctx, state) -> list:
    """The positions (R, N, 3) and times of the two frames that bound the
    profiled sub-window."""
    w = ctx.window
    c = ctx.config.interphase
    out = []
    for step in (w.profile_at, w.profile_at + c.sampling_interval):
        x = []
        for store in state["stores"]:
            store.set_stage("interphase")
            x.append(store.load_positions(step))
        out.append((np.stack(x), step * c.timestep))
    return out
