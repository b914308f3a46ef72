"""One run of one cell: set-up, the measured window, the reference check,
the metrics, and the result's last line.

Everything that belongs to one cell, configuration, traffic mix or metric
is found by name from ``BENCHMARK.json``:

- ``portbench/workloads/<cell>.json``: the cell's own parameters (how many
  single G1 steps the reference checks and how long a run, the limits of
  the numbers compared);
- ``portbench/configs/<config>.json``: the deployment (the simulation's
  configuration as run, its chains file, its replicas);
- ``portbench/traffic/<traffic>.json``: the mix, read by the stage driver
  it names, ``portbench/drivers/<driver>.py``;
- ``portbench/metrics/<metric>.py``: one reader a metric, ``read(run)``,
  which returns the metric's value or None when the run holds nothing for
  it.

The window drives the program's own stage drivers; see ``window.py`` for
what the benchmark sees of them.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import types
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench import trace as traces
from portbench.reference.config import parse_config
from portbench.window import Window, hooks, store_class

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "genome_cycle_tpu")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict           # the configuration's file
    traffic: dict          # the traffic's file
    params: dict           # the workload's file
    end_to_end: list       # BENCHMARK.json metric entries this cell reports
    per_layer: list


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_cell(name: str, benchmark: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    benchmark = benchmark or _load_json(ROOT / "BENCHMARK.json")
    entries = [w for w in benchmark["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    end_to_end = [m for m in benchmark["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in benchmark["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(entry["chips"]),
                _load_json(HERE / "configs" / f"{entry['config']}.json"),
                _load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                _load_json(HERE / "workloads" / f"{name}.json"),
                end_to_end, per_layer)


def _module(folder: str, name: str):
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def replica_seed(seed: int, replica: int) -> int:
    """The master seed (32 bits) of replica ``replica`` of a run."""
    return int(np.random.default_rng([seed, replica]).integers(0, 2 ** 32))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Context:
    """What a stage driver gets: the cell's files, the run's seed, window,
    device and scratch directory, and :meth:`prepare`."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 workdir: str, settings=None, log=None):
        self.cell = cell
        self.seed = seed
        self.trace = trace
        self.device = device
        self.workdir = workdir
        self.settings = settings
        self.log = log or (lambda message: print(message, file=sys.stderr))
        self.traffic = cell.traffic
        self.limits = cell.params["limits"]
        self.replicas = int(cell.config.get("replicas", 1))
        self.simulation = cell.config["simulation"]
        self.config = parse_config(json.dumps(self.simulation))
        self.chains = HERE / "configs" / cell.config["chains"]
        rng = np.random.default_rng([seed, 2 ** 20])
        self.window = Window(seconds, device, rng, self.replicas, trace,
                             int(cell.params.get("samples", 3)),
                             int(cell.params.get("run_steps", 1)))

    def prepare(self, replica: int, overrides: Optional[dict] = None):
        """The program's ``prepare`` of replica ``replica`` into a
        directory store of the run; returns the benchmark's store over it."""
        from genome_cycle_tpu_torch.models.prepare import run_prepare
        from genome_cycle_tpu_torch.store import DirectoryStore

        simulation = json.loads(json.dumps(self.simulation))
        for block, values in (overrides or {}).items():
            simulation.setdefault(block, {}).update(values)
        config_path = os.path.join(self.workdir, f"config_{replica}.json")
        with open(config_path, "w") as f:
            json.dump(simulation, f)
        path = os.path.join(self.workdir, f"cell_{replica}") + "/"
        run_prepare(path, config_path, str(self.chains), replica_seed(self.seed, replica),
                    log=self.log)
        return store_class(DirectoryStore)(path, self.window, replica)


def _reference(ctx, dtype):
    from portbench.reference.g1 import G1System
    from portbench.reference.mitotic import PHASES, MitoticSystem

    text = ctx.chains.read_text()
    if ctx.traffic["driver"] == "mitotic":
        return {p: MitoticSystem(ctx.config, text, p, ctx.device, dtype) for p in PHASES}
    return G1System(ctx.config, text, ctx.device, dtype)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             settings=None, log=None, control=None) -> dict:
    """One run of ``cell`` on ``device``; returns the result object (the
    keys of the last line, ``checks`` last).  With ``control`` (a dtype
    below the configuration's float32), the result also holds, under
    ``control``, the numbers that the reference computed in that dtype reads
    in the program's place; the benchmark's own runs never ask for it."""
    device = torch.device(device)
    workdir = tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))
    try:
        return _run(cell, seed, seconds, trace, device, t0, settings, log, workdir, control)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, t0, settings, log, workdir, control) -> dict:
    ctx = Context(cell, seed, seconds, trace, device, workdir, settings, log)
    driver = _module("drivers", ctx.traffic["driver"])
    w = ctx.window
    with hooks(w):
        state = driver.run(ctx)
    cuda = device.type == "cuda"
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = types.SimpleNamespace(
        cell=cell.name, kind=ctx.traffic["driver"], replicas=ctx.replicas,
        config=ctx.config, setup_s=w.t_open - t0, window_s=w.t_close - w.t_open,
        frames=w.frames, bead_steps=w.bead_steps, window_peak_bytes=window_peak,
        steps=(w.last_step - w.start_step) if w.start_step is not None else None,
        spans=w.spans, profile=None, profile_frames=None,
        card=torch.cuda.get_device_name(device) if cuda else None)
    if trace and w.profile_span is not None and w.profile_span[1] is not None:
        span = w.profile_span[1] - w.profile_span[0]
        run.profile = traces.read(w.profiler, span, workdir)
        run.profile_frames = (driver.profile_frames(ctx, state)
                              if hasattr(driver, "profile_frames") else w.profile_frames)
    w.profiler = None
    loaded = forbidden_modules()
    if loaded:
        raise ForbiddenModules(loaded)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    run.ref = _reference(ctx, torch.float64)
    numbers, failed = driver.check(ctx, state, run.ref)
    ctx.log(f"portbench: the reference check took {time.perf_counter() - t_check:.1f} s")
    correct = all(value <= ctx.limits[name] for name, value in numbers.items())
    metrics = {}
    for metric in (cell.per_layer if trace else cell.end_to_end):
        value = _module("metrics", metric["name"]).read(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": int(w.frames * ctx.replicas),
        "failed": int(failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else device.type,
            "kind": run.card or str(device),
            "count": 1,
            "memory_peak_bytes": int(max(w.setup_peak, window_peak)),
        },
    }
    if run.profile is not None:
        result["device"]["busy_s"] = run.profile.busy_s
        result["device"]["window_s"] = run.profile.window_s
        result["breakdown"] = {"device_ops": run.profile.device_ops,
                               "idle_gaps": run.profile.idle_gaps}
    if control is not None:
        result["control"] = driver.control(ctx, state, run.ref, _reference(ctx, control))
    result["checks"] = {name: {"value": value, "limit": ctx.limits[name]}
                        for name, value in numbers.items()}
    return result


class ForbiddenModules(RuntimeError):
    """The process loaded a module the benchmark may not load."""
