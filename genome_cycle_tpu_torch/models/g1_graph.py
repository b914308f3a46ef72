"""The G1 step on the card as one CUDA graph replay.

A G1 step of ``InterphaseModel._bd_step4`` on a CUDA carry is a fixed
sequence of launches: the cell layout (a memset and four kernels), the pair
kernel, the replicas' standard normals and the rest kernel.  Enqueued one by
one it costs the host several times what it costs the card (the wrappers,
their checks, allocations and launches).  :class:`StepGraph` captures the
sequence once and replays it each step:

- The scalars that change every step (the pair kernel's and the wall's
  e_a, 1/d_a^2, e_b, 1/d_b^2 at the core scale, the bonds' s^2 and s at the
  bond scale) would be frozen in a graph as by-value arguments.  The kernels
  read them instead from a table on the card, a row a step
  (``ops/pair_kernels.py::StepScalars``), built on the host in float64 and
  rounded to float32 as the eager launches round them (:func:`step_scalars`).
  The row's index lives on the card and the rest kernel advances it, so a
  step costs the host no copy and no write: the table goes to the card, its
  index reset, once every ``sampling_interval`` steps (at a frame, where the
  host syncs anyway) or when a step comes out of turn.
- The graphs read and write fixed buffers.  Two variants ping-pong between
  two position and two semiaxes buffers, so that a step's output is the next
  step's input; the carry's positions pick the variant, and a carry that is
  neither buffer (the first G1 step, a resumed run) is copied in.  The
  returned positions and semiaxes are those buffers: the step after next
  overwrites them.
- The replicas' generators are registered with the graphs, so that a replay
  draws the numbers the eager step would draw and advances each generator as
  it would (``get_state`` and ``set_state`` hold as before).  A step handed
  its ``noise`` replays a variant that reads it from a buffer instead: the
  same kernels otherwise.
- The graphs are keyed on what the step's launches depend on: the device,
  (R, N), the dtype and the grid (:func:`graph_key`).  A new key (the frame
  moved the grid's bound) captures anew; the old graphs, their pool and
  their buffers are freed first.  The four variants share one memory pool
  and run on one stream, one after the other.
- The launch counters count what a replay runs (``launch.cell_layout``,
  ``launch.ab_pair_forces``, ``launch.step_rest``, one each), with
  ``graph.step_replays``; ``graph.step_captures`` counts the graph sets
  captured, ``graph.step_eager`` the G1 steps on a CUDA carry that ran the
  eager body.  A capture and its warm-up count no launch.

The eager body (``InterphaseModel._eager_step``) stays: the CPU's step, the
card's yardstick, and the step of a system the dense pair path takes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import step_rest
from ..ops.integrator import standard_normal
from ..ops.pair_kernels import (
    STEP_ROW,
    StepScalars,
    ab_pair_forces_rows,
    build_cell_layout,
    grid_dims,
    release_scratch,
)
from ..utils import tracing

# Launch counters a replay adds to, one each.
_REPLAY_LAUNCHES = ("launch.cell_layout", "launch.ab_pair_forces", "launch.step_rest")
_MAX_TABLE_ROWS = 4096


def graph_key(model, x) -> tuple:
    """What the launches of a G1 step depend on besides the buffers they
    read: the device, (R, N), the dtype and the grid (bound, cell, cells)."""
    replicas, n = (1, x.shape[0]) if x.dim() == 2 else (x.shape[0], x.shape[1])
    dims = grid_dims(model.bound, model.cell)
    cells = (replicas * (dims + 1) - 1) * dims * dims
    return (x.device, replicas, n, x.dtype, float(model.bound), float(model.cell), cells)


def replays(model, x) -> bool:
    """Whether a G1 step of ``model`` at positions ``x`` is a graph replay:
    a float32 CUDA carry on the cell-range pair path."""
    return (x.device.type == "cuda" and x.dtype == torch.float32
            and model.n > model.settings.brute_force_threshold)


def step_scalars(model, first: int, count: int) -> np.ndarray:
    """The rows of G1 steps ``first`` to ``first + count - 1``, (count,
    STEP_ROW) float32: the pair kernel's [e_a, 1/d_a^2, e_b, 1/d_b^2], the
    bonds' [s^2, s] and the wall's [e_a, 1/d_a^2, e_b, 1/d_b^2] at the scales
    of ``(step - 1) * dt``, each formed in float64 as the eager step forms it
    and rounded once, as its by-value launch arguments are.  Raises where a
    row's diameter exceeds the grid's cell."""
    rows = np.zeros((count, STEP_ROW), np.float64)
    dt = model.config.timestep
    for k in range(count):
        core, bond = model.scales((first + k - 1) * dt)
        rows[k, 0:4] = model.pair_kernel_params(core)
        rows[k, 4:6] = step_rest.bond_scalars(bond)
        rows[k, 6:10] = step_rest.wall_scalars(model._wall_params(core))
    reach = 1.0 / np.sqrt(np.minimum(rows[:, 1], rows[:, 3]).min())
    if reach > model.cell * (1.0 + 1e-6):
        raise ValueError(f"largest core diameter {reach:g} exceeds the cell edge "
                         f"{model.cell:g}: the one-cell stencil would lose pairs")
    return rows.astype(np.float32)


def _generators(generator):
    if generator is None:
        return ()
    if isinstance(generator, torch.Generator):
        return (generator,)
    return tuple(generator)


class StepGraph:
    """The CUDA graphs of a model's G1 step for one :func:`graph_key`, and
    the buffers they read and write."""

    def __init__(self, model, carry, step: int):
        x, generator, semiaxes = carry
        self.key = graph_key(model, x)
        self.generators = _generators(generator)
        device = x.device
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.x = [torch.empty(x.shape, dtype=x.dtype, device=device) for _ in range(2)]
        self.semiaxes = [torch.empty(semiaxes.shape, dtype=semiaxes.dtype, device=device)
                         for _ in range(2)]
        self.noise = torch.zeros(x.shape, dtype=x.dtype, device=device)
        self.table_rows = max(1, min(int(model.config.sampling_interval), _MAX_TABLE_ROWS))
        # [index | rows], one int32 buffer so that one copy sends both.
        self.table = torch.zeros(STEP_ROW * (1 + self.table_rows), dtype=torch.int32,
                                 device=device)
        self.scalars = StepScalars(
            self.table[:1], self.table[STEP_ROW:].view(torch.float32).view(-1, STEP_ROW))
        self.next_step = self.table_end = None
        self.graphs = {}
        self.held = ()
        self._capture(model, carry, step)
        tracing.count("graph.step_captures")

    def matches(self, model, carry, draws: bool) -> bool:
        """Whether the graphs serve ``carry``: the same key, and where the
        step draws its noise, the generators they were captured with."""
        if graph_key(model, carry[0]) != self.key:
            return False
        if not draws:
            return True
        generators = _generators(carry[1])
        return len(generators) == len(self.generators) and all(
            a is b for a, b in zip(generators, self.generators))

    # -- capture ---------------------------------------------------------------

    def _body(self, model, parity: int, draws: bool, step: int):
        """The eager step's launches from buffer ``parity`` into the other,
        the step's scalars read on the card."""
        x, semiaxes = self.x[parity], self.semiaxes[parity]
        # By-value scalars the kernels replace with the step's row.
        core, bond = model.scales((step - 1) * model.config.timestep)
        layout = build_cell_layout(x, model.af, model.bf, model.bound, model.cell)
        forces = ab_pair_forces_rows(layout, self.scalars).reshape(x.shape)
        noise = standard_normal(x, self.generators if x.dim() == 3 else self.generators[0]) \
            if draws else self.noise
        step_rest.launch_rest(
            x, forces, model.bond_rows(bond), model.wall_rows(semiaxes, core),
            model.update_rows(noise), scalars=self.scalars,
            out=self.x[1 - parity], semiaxes_out=self.semiaxes[1 - parity])

    def _capture(self, model, carry, step: int):
        """Warm up on the graphs' stream (an eager step from the carry, which
        also makes the layout's scratch and the rest kernel's tickets for
        that stream), then capture the variants: from buffer 0 and from
        buffer 1, each drawing its noise (when the carry has generators) and
        reading it from the noise buffer."""
        x, _, semiaxes = carry
        device = self.device
        current = torch.cuda.current_stream(device)
        pool = torch.cuda.graph_pool_handle()
        with tracing.uncounted():
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                model._eager_step((x, None, semiaxes), step, noise=self.noise)
                torch.randn(x.shape[-2:], dtype=x.dtype, device=device,
                            generator=torch.Generator(device=device))
                for parity in (0, 1):
                    for draws in ((False, True) if self.generators else (False,)):
                        graph = torch.cuda.CUDAGraph()
                        if draws:
                            for generator in self.generators:
                                graph.register_generator_state(generator)
                        graph.capture_begin(pool=pool)
                        try:
                            self._body(model, parity, draws, step)
                        finally:
                            graph.capture_end()
                        self.graphs[parity, draws] = graph
            current.wait_stream(self.stream)
        # The graphs replay on the caller's stream, one after the other; the
        # scratch and tickets made for the capture stream are theirs alone.
        self.held = (release_scratch(device, self.stream.cuda_stream),
                     step_rest.release_tickets(device, self.stream.cuda_stream))

    def release(self):
        """Free the graphs, their pool and the buffers."""
        for graph in self.graphs.values():
            graph.reset()
        self.graphs.clear()
        self.x = self.semiaxes = self.noise = self.table = self.scalars = None
        self.held = ()

    # -- replay ----------------------------------------------------------------

    def _send_table(self, model, step: int):
        """The rows of steps ``step`` on, and the index 0, to the card in one
        copy from pinned memory, ordered after the replays before it."""
        rows = step_scalars(model, step, self.table_rows)
        host = torch.empty(self.table.shape[0], dtype=torch.int32, pin_memory=True)
        view = host.numpy()
        view[:STEP_ROW] = 0
        view[STEP_ROW:] = rows.view(np.int32).reshape(-1)
        self.table.copy_(host, non_blocking=True)
        self.next_step, self.table_end = step, step + self.table_rows

    def _parity(self, x, semiaxes) -> int:
        """The buffer the carry's positions are, or 0 with the carry copied
        in; the semiaxes copied into the buffer's twin unless they are it."""
        parity = 0
        for k in (0, 1):
            buffer = self.x[k]
            if x.data_ptr() == buffer.data_ptr() and x.stride() == buffer.stride():
                parity = k
                break
        else:
            self.x[0].copy_(x)
        if semiaxes.data_ptr() != self.semiaxes[parity].data_ptr():
            self.semiaxes[parity].copy_(semiaxes)
        return parity

    def step(self, model, carry, step: int, noise=None):
        x, generator, semiaxes = carry
        draws = noise is None
        if draws and not self.generators:
            raise ValueError("the step draws its noise from the carry's generators: none given")
        parity = self._parity(x, semiaxes)
        if not draws:
            if tuple(noise.shape) != tuple(x.shape):
                raise ValueError(f"noise of shape {tuple(noise.shape)}, the positions "
                                 f"{tuple(x.shape)}")
            self.noise.copy_(noise)
        if step != self.next_step or step >= self.table_end:
            self._send_table(model, step)
        self.graphs[parity, draws].replay()
        self.next_step = step + 1
        tracing.count("graph.step_replays")
        for name in _REPLAY_LAUNCHES:
            tracing.count(name)
        return (self.x[1 - parity], generator, self.semiaxes[1 - parity])


def graph_step(model, carry, step: int, noise=None):
    """G1 step ``step`` of ``model`` from ``carry`` as a replay of the
    model's step graph, captured first where the model has none for the
    carry's key and generators."""
    graph = model._step_graph
    if graph is None or not graph.matches(model, carry, noise is None):
        if graph is not None:
            model._step_graph = None
            graph.release()
            # The old pool's memory goes back before the new one is taken.
            torch.cuda.empty_cache()
        graph = model._step_graph = StepGraph(model, carry, step)
    return graph.step(model, carry, step, noise)
