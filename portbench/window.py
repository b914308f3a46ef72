"""The measured window, and what the benchmark sees of the program inside it.

The program runs its own stage drivers; the benchmark sees it through

- :class:`BenchStore`, the ``store.DirectoryStore`` it hands them, whose
  frame writes open the window (at a named checkpoint), count its frames and
  bead-steps, and close it: at the first frame boundary once ``seconds``
  have passed, the store raises :class:`StopWindow`, which the driver
  catches;
- :func:`hooks`, thin wrappers on a few of the program's calls for the
  length of a run.  The comparison that decides ``correct`` depends on
  these entries of the program, and a change to one of them has to move
  its wrapper here:

  - ``InterphaseModel._bd_step4(self, carry, step, noise=None)``, the G1
    step of every replica, called once a step with ``noise=None``: the
    wrapper keeps the inputs and outputs of the sampled steps and frame,
    and hands the step its standard normals there;
  - ``InterphaseModel.contact_events_tick(self, x, step)``, the tick's
    events (kept at the sampled steps);
  - ``WindowAccumulator.add(self, events)`` and ``.take(self)``, the events
    folded into each window dump;
  - ``ops.mitotic.run_chunk(x, terms, mobility, noise, temperature,
    timestep)``, a mitotic chunk (kept at the sampled chunks).

  In a traced run only, host spans are taken around the tick and merge,
  ``InterphaseModel.cell_layout`` and the store's writes.

G1 samples, drawn from the run's seed and uniform over the window: a few
single steps over all of its steps, with or without a tick, and the last
``run_steps`` steps of one frame, run whole.  At those steps the step runs on standard normals drawn from a
generator of the benchmark's, seeded by the step (:meth:`Window.noise`),
so that the reference can draw them again; everywhere else the program
draws its own.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Optional

import numpy as np
import torch


class StopWindow(Exception):
    """Raised by the store at the frame boundary that ends the window."""


class Spans:
    """Host spans of the traced run: total seconds and calls by name."""

    def __init__(self):
        self.total: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def add(self, name: str, seconds: float):
        self.total[name] = self.total.get(name, 0.0) + seconds
        self.calls[name] = self.calls.get(name, 0) + 1


class Reservoir:
    """A uniform sample of ``size`` items from a stream of unknown length
    (Li's algorithm L), drawn from ``rng``: :meth:`offer`, called for each
    item in turn, returns the slot the item takes, or None."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.seen = size, rng, 0
        self.w = math.exp(math.log(self._u()) / size)
        self.next = size + self._skip()

    def _u(self) -> float:
        return 1.0 - float(self.rng.random())      # in (0, 1]

    def _skip(self) -> int:
        if self.w >= 1.0:
            return 1
        return int(math.floor(math.log(self._u()) / math.log(1.0 - self.w))) + 1

    def offer(self) -> Optional[int]:
        self.seen += 1
        if self.seen <= self.size:
            return self.seen - 1
        if self.seen < self.next:
            return None
        slot = int(self.rng.integers(self.size))
        self.w *= math.exp(math.log(self._u()) / self.size)
        self.next = self.seen + self._skip()
        return slot


class Window:
    """State of one run's window, shared by the store, the hooks and the
    driver.

    ``start_stage``/``start_step``: the window opens when the last of
    ``replicas`` stores has written the checkpoint of that step in that
    stage (None: the driver opens it with :meth:`open`).  ``samples``: how
    many G1 frames the reservoir keeps for the reference.
    """

    def __init__(self, seconds: float, device, rng: np.random.Generator, replicas: int = 1,
                 trace: bool = False, samples: int = 3, run_steps: int = 1):
        self.seconds = float(seconds)
        self.device = device
        self.rng = rng
        self.replicas = replicas
        self.samples = samples
        self.run_steps = run_steps
        self.spans = Spans() if trace else None
        self.start_stage: Optional[str] = None
        self.start_step: Optional[int] = None
        self.frame_interval = 1000
        self.t_open = self.t_close = None
        self.setup_peak = 0
        self.is_open = False
        self.closed = False
        self.frames = 0
        self.last_step = None
        self.bead_steps = 0
        self.stage = ""
        # G1: the sampled steps (by reservoir slot) and frame, what they
        # kept, and those still waiting for their step's tick.
        self.step_pick = Reservoir(samples, rng)
        self.frame_pick = Reservoir(1, rng)
        self.kept: dict[int, dict] = {}
        self.frame: Optional[dict] = None
        self.frame_live: Optional[dict] = None
        self.pending: list = []
        self.noise_base = int(rng.integers(1, 2 ** 39))
        self._generator = None
        self.events = 0
        self.dumps: list[dict] = []
        # Mitotic: the chunks to keep, by (pass, stage, ordinal).
        self.pass_no = 0
        self.chunk = 0
        self.chunk_samples: set = set()
        self.chunks: dict = {}
        self.stages: list = []          # [pass, stage, start, end, chunks]
        # Traced runs: the profiled sub-window.
        self.profile_at: Optional[int] = None
        self.profiler = None
        self.profile_span = None
        self.profile_frames: list = []
        self.collect_frames = False
        self._tick_t0 = None

    # -- clock and window ----------------------------------------------------

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open(self):
        """Open the window now: the device idle, the clock read, the
        device's peak memory counted afresh."""
        self.sync()
        if self.device.type == "cuda":
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.is_open = True
        self.t_open = time.perf_counter()

    def frame_written(self, step: int, last_replica: bool, beads: int):
        """A frame of ``step`` was stored; close the window if its time is
        up (never while the profiler runs)."""
        if not self.is_open or self.closed or step == 0:
            return
        if not last_replica:
            return
        self.frames += 1
        self.last_step = step
        self.bead_steps += beads * self.frame_interval
        if self.profile_at is not None and step == self.profile_at:
            self.profile_start()
        if not self.profiling and time.perf_counter() - self.t_open >= self.seconds:
            self.sync()
            self.t_close = time.perf_counter()
            self.closed = True
            raise StopWindow()

    def checkpoint_written(self, stage: str, step: int, last_replica: bool):
        if not last_replica or stage != self.start_stage:
            return
        if not self.is_open and step == self.start_step:
            self.open()
        elif self.profiling and step == self.profile_at + self.frame_interval:
            self.profile_stop()

    # -- profiler ------------------------------------------------------------

    @property
    def profiling(self) -> bool:
        return self.profile_span is not None and self.profile_span[1] is None

    def profile_start(self):
        from torch.profiler import ProfilerActivity, profile

        if self.profile_span is not None:
            return
        self.sync()
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.profiler = profile(activities=activities)
        self.profiler.start()
        self.profile_span = [time.perf_counter(), None]

    def profile_stop(self):
        self.sync()
        self.profile_span[1] = time.perf_counter()
        self.profiler.stop()

    # -- G1 samples -----------------------------------------------------------

    def noise(self, step: int, shape, dtype) -> torch.Tensor:
        """The standard normals of G1 step ``step`` at a sampled step: the
        same for the program in the window and for the reference after it."""
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.noise_base * 2 ** 24 + int(step))
        return torch.randn(tuple(shape), generator=self._generator, dtype=dtype,
                           device=self.device)

    @property
    def run_first(self) -> int:
        """Where the sampled run starts in its frame: the step number modulo
        the frame interval."""
        return (self.frame_interval - self.run_steps + 1) % self.frame_interval

    def keep_tick(self, step: int, events):
        for record in self.pending:
            if record["at"] == step:
                record["events"] = events.detach().cpu().numpy()
        self.pending = []

    # -- mitotic stages -------------------------------------------------------

    def stage_begins(self, stage: str):
        now = time.perf_counter()
        if self.stages and self.stages[-1][3] is None:
            self.stages[-1][3:] = [now, self.chunk]
        if self.is_open and not self.closed:
            self.stages.append([self.pass_no, stage, now, None, None])

    def stage_rates(self, interval: int) -> list:
        """(pass, stage, steps a second) of every stage the window ran whole."""
        return [(p, stage, chunks * interval / (end - start))
                for p, stage, start, end, chunks in self.stages if end is not None]


def store_class(base):
    """A subclass of the program's ``DirectoryStore`` ``base`` whose frame
    and checkpoint writes report to a :class:`Window`, whose writes are
    spans in a traced run, and which can set a stage's seed (the next
    replica of a study)."""

    class BenchStore(base):
        def __init__(self, root, window: Window, replica: int = 0, mode: str = "r+"):
            super().__init__(root, mode)
            self.window = window
            self.replica = replica
            self._beads = 0

        def _last(self):
            return self.replica == self.window.replicas - 1

        @contextlib.contextmanager
        def _span(self):
            spans = self.window.spans
            if spans is None or not self.window.is_open or self.window.closed:
                yield
                return
            t0 = time.perf_counter()
            with torch.profiler.record_function("portbench::store"):
                yield
            spans.add("store", time.perf_counter() - t0)

        def set_stage_seed(self, stage: str, seed: int):
            self._put(self._metadata_path(stage, "seed"), np.uint32(seed))

        def clear_frames(self):
            super().clear_frames()
            self.window.stage_begins(self._stage)
            self.window.stage = self._stage
            self.window.chunk = 0

        def save_positions(self, step, positions):
            self._beads = int(np.asarray(positions).shape[0])
            w = self.window
            if w.collect_frames and w.is_open and not w.closed:
                w.profile_frames.append((self._stage, int(step), np.array(positions)))
            with self._span():
                super().save_positions(step, positions)

        def save_interphase_context(self, step, context):
            with self._span():
                super().save_interphase_context(step, context)

        def save_contacts(self, step, contacts):
            with self._span():
                super().save_contacts(step, contacts)

        def append_frame(self, step):
            with self._span():
                super().append_frame(step)
            w = self.window
            key = (w.pass_no, self._stage, int(step))
            if key in w.chunks and "stored" not in w.chunks[key]:
                w.chunks[key]["stored"] = self.load_positions(step)
            w.frame_written(int(step), self._last(), self._beads * w.replicas)

        def save_checkpoint(self, step, arrays):
            with self._span():
                super().save_checkpoint(step, arrays)
            self.window.checkpoint_written(self._stage, int(step), self._last())

    return BenchStore


@contextlib.contextmanager
def hooks(window: Window):
    """Install the benchmark's wrappers on the program's calls (see the
    module's docstring) for the length of the block, and take them off
    again; the host spans' wrappers only in a traced run."""
    from genome_cycle_tpu_torch.models import interphase as inter
    from genome_cycle_tpu_torch.ops import mitotic as mitotic_ops

    model, acc = inter.InterphaseModel, inter.WindowAccumulator
    saved = [(model, "_bd_step4", model._bd_step4),
             (model, "contact_events_tick", model.contact_events_tick),
             (acc, "add", acc.add), (acc, "take", acc.take),
             (mitotic_ops, "run_chunk", mitotic_ops.run_chunk),
             (model, "cell_layout", model.cell_layout)]
    step_fn, tick_fn, add_fn, take_fn, chunk_fn, layout_fn = (s[2] for s in saved)
    w = window
    spans = w.spans

    def host(tensor):
        return tensor.detach().cpu().numpy()

    def live():
        return w.is_open and not w.closed

    def bd_step4(self, carry, step, noise=None):
        if noise is not None or not live():
            return step_fn(self, carry, step, noise)
        x, _, semiaxes = carry
        w.pending = []
        if (step - 1) % w.frame_interval == 0:
            w.frame_live = {} if w.frame_pick.offer() is not None else None
        frame = w.frame_live
        if frame is not None and step % w.frame_interval == w.run_first:
            frame.update(first=step, x_in=host(x), semi_in=host(semiaxes))
        slot = w.step_pick.offer()
        if slot is not None or (frame is not None and "first" in frame):
            noise = w.noise(step, x.shape, x.dtype)
        if slot is not None:
            record = dict(at=step, x_in=host(x), semi_in=host(semiaxes))
        out = step_fn(self, carry, step, noise)
        if slot is not None:
            record.update(x_out=host(out[0]), semi_out=host(out[2]))
            w.kept[slot] = record
            w.pending.append(record)
        if frame is not None and step % w.frame_interval == 0:
            frame.update(at=step, x_out=host(out[0]), semi_out=host(out[2]))
            w.frame, w.frame_live = frame, None
            w.pending.append(frame)
        return out

    def contact_events_tick(self, x, step):
        if spans is not None and live():
            w.sync()
            w._tick_t0 = time.perf_counter()
            with torch.profiler.record_function("portbench::tick"):
                events = tick_fn(self, x, step)
        else:
            events = tick_fn(self, x, step)
        if w.pending:
            w.keep_tick(step, events)
        return events

    def cell_layout(self, positions):
        if not live():
            return layout_fn(self, positions)
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench::layout"):
            layout = layout_fn(self, positions)
        spans.add("layout", time.perf_counter() - t0)
        return layout

    def add(self, events):
        if live():
            w.events += int(events.shape[0])
        if spans is not None and w._tick_t0 is not None:
            with torch.profiler.record_function("portbench::merge"):
                add_fn(self, events)
            spans.add("tick", time.perf_counter() - w._tick_t0)
            w._tick_t0 = None
            return
        add_fn(self, events)

    def take(self):
        coo = take_fn(self)
        if live():
            w.dumps.append(dict(events=w.events, rows=int(len(coo))))
        w.events = 0
        return coo

    def run_chunk(x, terms, mobility, noise, temperature, timestep):
        key = (w.pass_no, w.stage, (w.chunk + 1) * int(noise.shape[0]))
        w.chunk += 1
        out = chunk_fn(x, terms, mobility, noise, temperature, timestep)
        if key in w.chunk_samples and live():
            w.chunks[key] = dict(x_in=host(x), noise=host(noise), x_out=host(out))
        return out

    model._bd_step4 = bd_step4
    model.contact_events_tick = contact_events_tick
    acc.add, acc.take = add, take
    mitotic_ops.run_chunk = run_chunk
    if spans is not None:
        model.cell_layout = cell_layout
    try:
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)
