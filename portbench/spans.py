"""The program's own spans and counters in one run of a cell
(``genome_cycle_tpu_torch/utils/tracing.py``), read beside the benchmark.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs the cell as ``run.py`` does and prints its result line, then one more
line, ``{"program": {...}}``: the program's tracing is started when the
window opens and stopped when it closes, and the line holds the spans and
the counters' increase over the window, the numbers below, and with
``--trace 1`` the profiled sub-window's device seconds by program span
(:func:`device_by_span`) and the share of its idle time that no span names.
With ``--trace 0`` no profiler runs: the result line's rate is then the
rate with tracing on.

The numbers (a G1 cell; a mitotic cell gives the store's alone):

- ``g1.step_host_ms``: mean host ms of ``g1.step`` (the enqueue of one step
  of every replica);
- ``g1.layout_device_ms_per_step``: device ms under ``layout`` in the
  profiled frame, over its steps;
- ``g1.merge_ms_per_tick``: mean host ms of ``merge``;
- ``g1.host_syncs_per_step``: the ``sync.*`` counters' increase over the
  window's G1 steps;
- ``g1.reruns_per_dump``: ``contact.tick_reruns`` + ``window.merge_reruns``
  over the window's dumps;
- ``g1.store_mib_per_frame``, ``mitotic.store_mib_per_frame``:
  ``store.bytes`` over the window's frames, in MiB.

The harness reads none of this: its ``window.py``, ``harness.py`` and
``trace.py`` would start the tracing, keep the counters and hand the trace's
events to :func:`device_by_span` for a metric reader to see them.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_CATEGORIES = {"kernel", "gpu_memcpy", "gpu_memset"}
RUNTIME_CATEGORIES = {"cuda_runtime", "cuda_driver"}
# Ranges of the benchmark's own wrappers, which are not the program's.
BENCH_PREFIX = "portbench::"


def _program_ranges(events, category):
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") == category and "dur" in e
                  and not e["name"].startswith(BENCH_PREFIX))


def _innermost(points, ranges):
    """For each (time, key) of ``points``, sorted by time, the name of the
    shortest of ``ranges`` (start, end, name), sorted by start, that holds
    the time, or None."""
    found, active, next_range = {}, [], 0
    for t, key in points:
        while next_range < len(ranges) and ranges[next_range][0] <= t:
            active.append(ranges[next_range])
            next_range += 1
        active = [r for r in active if r[1] >= t]
        pick = min(active, key=lambda r: r[1] - r[0], default=None)
        found[key] = pick[2] if pick else None
    return found


def device_by_span(events) -> dict:
    """Device seconds of a Chrome trace's events (``traceEvents``) by the
    innermost program span (a ``record_function`` range of the host that is
    not the benchmark's own) that encloses the runtime call which launched
    them, matched by the events' ``correlation`` id.  Without correlation
    ids, by the innermost ``gpu_user_annotation`` range that holds the
    event's middle on the device.  Events outside every span go under
    ``unattributed``."""
    device = [e for e in events if e.get("ph") == "X" and "dur" in e
              and e.get("cat") in DEVICE_CATEGORIES]
    launched = {}
    for e in events:
        correlation = (e.get("args") or {}).get("correlation")
        if e.get("cat") in RUNTIME_CATEGORIES and correlation is not None:
            launched[correlation] = float(e["ts"])
    points, fallback = [], []
    for k, e in enumerate(device):
        at = launched.get((e.get("args") or {}).get("correlation"))
        if at is not None:
            points.append((at, k))
        else:
            fallback.append((float(e["ts"]) + 0.5 * float(e["dur"]), k))
    names = _innermost(sorted(points), _program_ranges(events, "user_annotation"))
    names.update(_innermost(sorted(fallback), _program_ranges(events, "gpu_user_annotation")))
    out: dict = {}
    for k, e in enumerate(device):
        name = names.get(k) or "unattributed"
        out[name] = out.get(name, 0.0) + float(e["dur"]) * 1e-6
    return out


def _calls(snapshot, name):
    return [s for s in snapshot["spans"] if s["name"] == name]


def _mean_ms(snapshot, name):
    spans = _calls(snapshot, name)
    calls = sum(s["calls"] for s in spans)
    return 1e3 * sum(s["total_s"] for s in spans) / calls if calls else None


def program_numbers(kind: str, snapshot: dict, counts: dict, steps, frames, dumps,
                    by_span=None, profiled_steps=None) -> dict:
    """The numbers of the module's docstring from a window's ``snapshot``,
    its counters' increase ``counts``, its G1 ``steps``, ``frames`` and
    ``dumps``, and the profiled frame's device seconds ``by_span`` over
    ``profiled_steps``."""
    mib = counts.get("store.bytes", 0) / 2 ** 20 / frames if frames else None
    if kind != "g1":
        return {"mitotic.store_mib_per_frame": mib}
    syncs = sum(v for k, v in counts.items() if k.startswith("sync."))
    reruns = counts.get("contact.tick_reruns", 0) + counts.get("window.merge_reruns", 0)
    layout = None
    if by_span is not None and profiled_steps:
        layout = 1e3 * by_span.get("layout", 0.0) / profiled_steps
    return {
        "g1.step_host_ms": _mean_ms(snapshot, "g1.step"),
        "g1.layout_device_ms_per_step": layout,
        "g1.merge_ms_per_tick": _mean_ms(snapshot, "merge"),
        "g1.host_syncs_per_step": syncs / steps if steps else None,
        "g1.reruns_per_dump": reruns / dumps if dumps else None,
        "g1.store_mib_per_frame": mib,
    }


@contextlib.contextmanager
def program_tracing():
    """For the block, the window starts the program's tracing when it opens
    and stops it when it closes, and the profiled sub-window's trace is read
    by :func:`device_by_span`; yields the dict that :func:`report` reads."""
    from portbench import trace as traces
    from portbench.window import StopWindow, Window

    from genome_cycle_tpu_torch.utils import tracing

    seen: dict = {}
    window_open, frame_written, read = Window.open, Window.frame_written, traces.read

    def open_(self):
        window_open(self)
        seen["window"] = self
        seen["counters"] = tracing.counters()
        tracing.start()

    def frame_written_(self, *args, **kwargs):
        try:
            frame_written(self, *args, **kwargs)
        except StopWindow:
            tracing.stop()
            seen["snapshot"] = tracing.snapshot()
            seen["counts"] = tracing.counters_since(seen["counters"])
            raise

    def read_(profiler, window_s, workdir):
        export = profiler.export_chrome_trace

        def keep(path):
            export(path)
            with open(path) as f:
                seen["by_span"] = device_by_span(json.load(f)["traceEvents"])

        profiler.export_chrome_trace = keep
        profile = read(profiler, window_s, workdir)
        seen["idle_s"] = profile.window_s - profile.busy_s
        seen["host_idle_s"] = dict(profile.idle_gaps).get("host", 0.0)
        return profile

    Window.open, Window.frame_written, traces.read = open_, frame_written_, read_
    try:
        yield seen
    finally:
        Window.open, Window.frame_written, traces.read = window_open, frame_written, read
        tracing.stop()


def report(seen: dict, kind: str) -> dict:
    """The ``program`` object of a run (driver ``kind``) that
    :func:`program_tracing` saw: the numbers, the spans, the counters that
    moved and, from a traced run, the device seconds by span and the share
    of the idle time labelled "host"."""
    w = seen["window"]
    steps = (w.last_step - w.start_step) if kind == "g1" else None
    numbers = program_numbers(kind, seen["snapshot"], seen["counts"], steps, w.frames,
                              len(w.dumps), seen.get("by_span"), w.frame_interval)
    out = dict(numbers=numbers, spans=seen["snapshot"]["spans"],
               counters={k: v for k, v in seen["counts"].items() if v})
    if "by_span" in seen:
        idle = seen["idle_s"]
        out.update(device_by_span=seen["by_span"],
                   host_idle_share=seen["host_idle_s"] / idle if idle > 0 else None)
    return out


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from portbench import run as runner
    from portbench.harness import load_cell

    args = sys.argv[1:] if argv is None else list(argv)
    kind = load_cell(args[args.index("--workload") + 1]).traffic["driver"]
    with program_tracing() as seen:
        code = runner.main(args)
    if code != 0 or "snapshot" not in seen:
        return code or 1
    print(json.dumps({"program": report(seen, kind)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
