"""The comparison that decides ``correct``.

A G1 run keeps samples drawn from the seed, uniform over the window (see
``window.py``): a few single steps over all of its steps, each with the
positions and wall before and after it and, at a tick step, the tick's
events; and the last ``run_steps`` steps of one frame (the workload
file's; one tick interval), with the state before them, at the frame's
end and the events of the tick there.  Float32 and float64 trajectories of
the G1 part over a whole frame (PERF.md), so the reference follows the
program from the program's own state, a step or a run at a time.  A
mitotic run keeps a few chunks of 1,000 steps: the positions before, the
normals, the positions after.  Once the window has closed and the
program's state is freed, the plain reference (``portbench/reference/``,
float64) takes the same inputs and the same standard normals, and the
numbers below are compared, each against its limit from the cell's
workload file:

- ``step_gap``: a sampled step's positions against the reference's step
  from the program's own state, over the reference's largest drift
  |mu F| dt (the pair force, the bonds, loops, nucleolar bonds and droplet,
  the wall, the update);
- ``run_gap``: the positions at the end of the sampled frame against the
  reference's run over its last ``run_steps`` steps from the program's
  state before them, over the reference's largest displacement in the run
  (one replica, drawn from the seed);
- ``wall_gap``: the stored semiaxes at the frame's end against the
  reference's wall ODE over the run, relative;
- ``frame_gap``: the stored frame's positions against the reference's at
  the frame's end, relative to the largest coordinate (the store's 16-bit
  mantissa rounding is part of it);
- ``energy_gap``: the stored context's mean energy against the reference's
  at the program's positions, relative;
- ``tick_mismatch``: pairs that the program's tick and the reference's
  search disagree on, outside a band of 1e-5 of the cutoff (limit 0);
- ``window_mismatch``: each window the window wrote: rows out of order,
  counts below 1 or above the ticks of a window, the events its counts sum
  to against the events the ticks folded into it, and the pairs of a
  sampled tick that the reference finds clear of the band and the window
  lacks (limit 0);
- ``chunk_gap``: a mitotic chunk's positions after 1,000 steps against the
  reference's, over the reference's largest displacement.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

BAND = 1e-5


def _keys(i, j) -> np.ndarray:
    return np.sort((np.asarray(i, np.int64) << 32) | np.asarray(j, np.int64))


def _t(array, device, dtype):
    return torch.as_tensor(np.asarray(array, np.float64), device=device).to(dtype)


def _max(value) -> float:
    return float(torch.max(torch.abs(value)).to(torch.float64))


def fold(numbers: dict, got: dict, limits: Optional[dict] = None) -> bool:
    """Fold the readings ``got`` into the worst so far, ``numbers`` (a NaN
    reads as infinite); whether any is over its limit in ``limits``."""
    over = False
    for name, value in got.items():
        value = value if value == value else float("inf")
        numbers[name] = max(numbers.get(name, value), value)
        over |= limits is not None and value > limits[name]
    return over


def step_gap(ref, step: int, x_in, semi_in, noise, x_out) -> float:
    """A sampled step of one replica against the reference's step from the
    same state on the same normals (``noise`` a tensor on the reference's
    device)."""
    dev, f64 = ref.device, ref.dtype
    x_ref, _, drift = ref.step(_t(x_in, dev, f64), _t(semi_in, dev, f64), noise.to(f64), step)
    return _max(_t(x_out, dev, f64) - x_ref) / float(drift)


def tick_numbers(ref, step: int, tick_x, keys) -> tuple:
    """(``tick_mismatch``, the pairs the window has to hold) of one
    replica's tick at ``step`` at the positions ``tick_x`` it searched:
    the pairs the reference finds clear of the band, where float32 and
    float64 may round a pair either way."""
    found, near = ref.contacts(_t(tick_x, ref.device, ref.dtype), step, BAND)
    differ = np.setxor1d(found, keys)
    return int(np.setdiff1d(differ, near).size), np.setdiff1d(found, near)


def frame_numbers(ref, first: int, last: int, x_in, semi_in, noise_at, out: dict) -> dict:
    """The numbers of one replica's sampled frame, steps ``first`` to
    ``last``: the reference runs them from (``x_in``, ``semi_in``) on the
    normals ``noise_at(step)``.  ``out`` holds what the side under test
    produced: ``x_out`` (its positions after ``last``), ``frame`` and
    ``semi`` (as stored), ``energy`` (or None) and the positions and
    semiaxes it was read at, ``x_at`` and ``semi_at``."""
    dev, f64 = ref.device, ref.dtype
    x0 = _t(x_in, dev, f64)
    x_ref, semi_ref = ref.run(x0, _t(semi_in, dev, f64), lambda s: noise_at(s).to(f64),
                              first, last - first + 1)
    numbers = {
        "run_gap": _max(_t(out["x_out"], dev, f64) - x_ref) / _max(x_ref - x0),
        "frame_gap": _max(_t(out["frame"], dev, f64) - x_ref) / _max(x_ref),
        "wall_gap": _max(_t(out["semi"], dev, f64) - semi_ref) / _max(semi_ref),
    }
    if out.get("energy") is not None:
        e_ref = float(ref.mean_energy(_t(out["x_at"], dev, f64), _t(out["semi_at"], dev, f64),
                                      last))
        numbers["energy_gap"] = abs(out["energy"] - e_ref) / abs(e_ref)
    return numbers


def program_keys(events, replica: int, n: int) -> np.ndarray:
    """The pairs of replica ``replica`` in a tick's events, in its ids."""
    events = events.reshape(-1, 3)
    events = events[events[:, 0] >= 0].astype(np.int64)
    lo, hi = np.minimum(events[:, 0], events[:, 1]), np.maximum(events[:, 0], events[:, 1])
    mine = (lo >= replica * n) & (lo < (replica + 1) * n)
    return _keys(lo[mine] - replica * n, hi[mine] - replica * n)


def stored_frame(store, step: int, replicas: int) -> dict:
    """What the program stored for a replica at ``step``: the frame, the
    context's semiaxes and (alone, not in an ensemble) its mean energy."""
    store.set_stage("interphase")
    ctx = store.load_interphase_context(step)
    return dict(frame=store.load_positions(step), semi=np.asarray(ctx.wall_semiaxes),
                energy=ctx.mean_energy if replicas == 1 else None)


def window_numbers(stores, dumps, start_step: int, window_steps: int, ticks: int,
                   last_step: int, sampled: dict) -> int:
    """Faults found in the windows written in the window (see the module
    docstring); ``sampled`` maps a kept step to its reference pairs a
    replica."""
    faults = 0
    for k, dump in enumerate(dumps):
        step = start_step + (k + 1) * window_steps
        if step > last_step:
            break
        total = 0
        for r, store in enumerate(stores):
            store.set_stage("interphase")
            coo = store.load_contacts(step)
            coo = np.zeros((0, 3), np.int64) if coo is None else coo.astype(np.int64)
            keys = (coo[:, 0] << 32) | coo[:, 1]
            faults += int(np.sum(np.diff(keys) <= 0)) + int(np.sum(coo[:, 0] >= coo[:, 1]))
            faults += int(np.sum((coo[:, 2] < 1) | (coo[:, 2] > ticks)))
            total += int(coo[:, 2].sum())
            for s, pairs in sampled.items():
                if step - window_steps < s <= step:
                    faults += int(np.setdiff1d(pairs[r], keys).size)
        faults += abs(total - dump["events"])
    return faults


def mitotic_numbers(system, x_in, noise, x_out, stored) -> dict:
    """A mitotic chunk's numbers against the reference ``system`` (a
    ``reference.mitotic.MitoticSystem``)."""
    dev, f64 = system.device, system.dtype
    x0 = _t(x_in, dev, f64)
    x_ref = system.run(x0, _t(noise, dev, f64))
    return {
        "chunk_gap": _max(_t(x_out, dev, f64) - x_ref) / _max(x_ref - x0),
        "frame_gap": _max(_t(stored, dev, f64) - x_ref) / _max(x_ref),
    }
