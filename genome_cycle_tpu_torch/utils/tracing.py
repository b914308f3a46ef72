"""Spans and counters of the port: where a run's host time, device syncs,
launches, reruns and store bytes go.

- :func:`span` ``(name)`` is a context manager, :func:`traced` ``(name)``
  its decorator form for a whole function.  Tracing is off by default, and
  then :func:`span` returns one shared object that does nothing: no clock
  reading, no profiler call, no allocation.  Between :func:`start` and
  :func:`stop` a span reads ``time.perf_counter_ns`` at entry and exit and
  adds to a running aggregate keyed by (parent span, name): calls, total
  seconds and self seconds (the total less what its child spans cover).
  While a profiler runs it also enters ``torch.profiler.record_function(name)``,
  so that the profiler's trace holds every instance of it on the clock of
  the device's kernels (without a profiler the range would keep nothing
  and cost about 15 us of host time, five times the rest of a span).  Spans
  are aggregated, never logged one by one.
- :func:`count` ``(name, n)`` adds to a host-side counter.  Counters are
  always on and never read the device; :func:`counters` copies them, and a
  reader takes differences over any interval (:func:`counters_since`).
- :func:`sync` ``(name)`` marks a place where the port reads a device
  value on the host: it counts ``sync.<name>`` and, when tracing is on, is a
  span of that name.
- :func:`uncounted` leaves the counters as they were before the block: the
  capture of a CUDA graph and its warm-up run the wrappers without a step.

The names follow the layers of the G1 step and the stages: ``g1.step``
(with ``layout``, ``pair``, ``noise``, ``rest`` inside), ``tick``,
``merge``, ``dump``, ``g1.frame``, ``mitotic.chunk``, ``mitotic.frame``,
``store``; the counters ``launch.<kernel>``, ``contact.tick_reruns``,
``window.merge_reruns``, ``store.bytes``, ``store.files``, ``sync.*`` and
those of the G1 step's CUDA graph, ``graph.step_replays``,
``graph.step_captures`` and ``graph.step_eager`` (a replay counts the
launches it runs under ``launch.<kernel>`` too).
The state is the process's, on the one host thread that drives the device.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch


class _Off:
    """The span of tracing off: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _State:
    def __init__(self):
        self.on = False
        self.stack: list = []       # open spans, innermost last
        self.spans: dict = {}       # (parent, name) -> [calls, total ns, self ns]
        self.counts: dict = {}


_state = _State()


class _Span:
    __slots__ = ("name", "record", "child_ns", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.record = None
        if torch.autograd._profiler_enabled():
            self.record = torch.profiler.record_function(self.name)
            self.record.__enter__()
        self.child_ns = 0
        _state.stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        total = time.perf_counter_ns() - self.t0
        stack = _state.stack
        # A start() inside the span cleared the stack: the span is not kept.
        if stack and stack[-1] is self:
            stack.pop()
            parent = stack[-1] if stack else None
            if parent is not None:
                parent.child_ns += total
            key = (parent.name if parent is not None else None, self.name)
            entry = _state.spans.get(key)
            if entry is None:
                entry = _state.spans[key] = [0, 0, 0]
            entry[0] += 1
            entry[1] += total
            entry[2] += total - self.child_ns
        if self.record is not None:
            self.record.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that times the block as span ``name`` while
    tracing is on."""
    return _Span(name) if _state.on else _OFF


def traced(name: str):
    """Decorator: every call of the function is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _state.on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name``."""
    counts = _state.counts
    counts[name] = counts.get(name, 0) + n


@contextlib.contextmanager
def uncounted():
    """Every counter as it was before the block, after it."""
    saved = dict(_state.counts)
    try:
        yield
    finally:
        _state.counts.clear()
        _state.counts.update(saved)


def sync(name: str):
    """Mark a host read of a device value: counts ``sync.<name>``; a span of
    that name while tracing is on."""
    key = "sync." + name
    count(key)
    return _Span(key) if _state.on else _OFF


def start():
    """Turn spans on, their aggregates cleared (the counters run on)."""
    _state.stack.clear()
    _state.spans.clear()
    _state.on = True


def stop():
    """Turn spans off; their aggregates stay for :func:`snapshot`."""
    _state.on = False


def counters() -> dict:
    """A copy of every counter."""
    return dict(_state.counts)


def counters_since(before: dict) -> dict:
    """Each counter's increase since the copy ``before`` (0 included)."""
    return {name: value - before.get(name, 0) for name, value in _state.counts.items()}


def snapshot() -> dict:
    """The spans since :func:`start`, as ``{"spans": [{"name", "parent",
    "calls", "total_s", "self_s"}], "counters": {name: value}}``."""
    spans = [dict(name=name, parent=parent, calls=calls, total_s=total * 1e-9,
                  self_s=own * 1e-9)
             for (parent, name), (calls, total, own) in _state.spans.items()]
    return {"spans": spans, "counters": counters()}
