"""Reading the profiled sub-window: device time by kernel, busy and idle.

The profiler's trace is exported as Chrome trace JSON and read here:
device events are those of the categories ``kernel``, ``gpu_memcpy`` and
``gpu_memset``; the busy time is the union of their intervals; an idle gap
is named by what the host was doing in it, the innermost of the
benchmark's own spans (``portbench::...``, ``record_function`` ranges) or,
outside them, of the program's host operations that covers the gap's
middle.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import NamedTuple

DEVICE_CATEGORIES = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATEGORIES = {"user_annotation", "cpu_op"}


class Profile(NamedTuple):
    window_s: float            # host clock from start to stop, both synchronised
    busy_s: float              # union of the device's intervals
    kernels: dict              # kernel name -> [launches, seconds]
    device_ops: list           # [[name, seconds]], the ten longest in total
    idle_gaps: list            # [[what the host did, seconds]], the ten largest


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"\(.*$", "", name)
    name = re.sub(r"<.*$", "", name)
    return name.split(" ")[-1].split("::")[-1] or name


def _union(intervals):
    total, merged = 0.0, []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    for start, end in merged:
        total += end - start
    return total, merged


def read(profiler, window_s: float, workdir: str) -> Profile:
    """The :class:`Profile` of a stopped ``torch.profiler.profile``; the
    trace file is written under ``workdir`` and removed again."""
    handle, path = tempfile.mkstemp(suffix=".json", dir=workdir)
    os.close(handle)
    try:
        profiler.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            device.append(e)
        elif cat in HOST_CATEGORIES:
            host.append(e)
    kernels: dict = {}
    by_name: dict = {}
    for e in device:
        seconds = float(e["dur"]) * 1e-6
        name = short_name(e["name"]) if e["cat"] == "kernel" else e["cat"]
        by_name[name] = by_name.get(name, 0.0) + seconds
        if e["cat"] == "kernel":
            entry = kernels.setdefault(name, [0, 0.0])
            entry[0] += 1
            entry[1] += seconds
    busy_us, merged = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device)
    gaps: dict = {}
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["cat"] == "user_annotation", e["name"]) for e in host))
    next_span, active = 0, []
    # Gaps in time order; the host spans open at a gap's middle are few
    # (one call stack), so the sweep keeps them in a short list.
    for (_, end), (start, _) in zip(merged, merged[1:]):
        middle = 0.5 * (end + start)
        while next_span < len(spans) and spans[next_span][0] <= middle:
            active.append(spans[next_span])
            next_span += 1
        active = [s for s in active if s[1] >= middle]
        ours = [s for s in active if s[2]]
        pick = min(ours or active, key=lambda s: s[1] - s[0], default=None)
        name = pick[3] if pick else "host"
        gaps[name] = gaps.get(name, 0.0) + (start - end) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return Profile(window_s, busy_us * 1e-6, kernels,
                   [[k, v] for k, v in top], [[k, v] for k, v in idle])


def kernel(profile: Profile, name: str):
    """(launches, seconds) of the kernel ``name`` (its short name), or None
    when the trace holds none."""
    found = profile.kernels.get(name)
    return None if not found or not found[1] else tuple(found)
