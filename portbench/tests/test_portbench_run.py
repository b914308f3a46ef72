"""The harness end to end on the CPU at a tiny size: the result's keys, a
run with no card, the modules a run loads, the control, and faults planted
in the program, each of which has to make ``correct`` false.  The tests
that need the card carry the ``gpu`` marker and skip here."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests import tiny

RUN = os.path.join(harness.HERE, "run.py")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("driver,replicas,trace", [
    ("g1", 1, False), ("g1", 2, True), ("mitotic", 1, False), ("mitotic", 1, True)])
def test_result_has_the_contract_keys(tmp_path, driver, replicas, trace):
    metrics = {"g1": ["g1_bead_steps_per_s", "setup_s", "g1.store_ms_per_frame", "g1.tick_ms",
                      "g1.layout_ms_per_step"],
               "mitotic": ["mitotic_bead_steps_per_s", "setup_s", "mitotic.store_ms_per_frame"]}
    result = tiny.run(tiny.cell(tmp_path, driver, replicas, metrics[driver]), trace=trace)
    assert list(result) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {m for m in metrics[driver] if ("." in m) == trace}
    for entry in result["metrics"].values():
        assert set(entry) == {"value", "unit"} and entry["value"] > 0
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for entry in result["checks"].values():
        assert entry["value"] <= entry["limit"]
    json.dumps(result)


def test_a_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = subprocess.run([sys.executable, RUN, "--workload", "g1-100kb", "--seed",
                           str(2 ** 31 + 3), "--seconds", "10", "--trace", "0"],
                          capture_output=True, text=True, cwd=harness.ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_the_timed_path_and_the_reference_load_no_jax(tmp_path):
    """The top-level names of every module a tiny run loads, and of every
    module the reference loads, compared whole."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "import portbench.reference.g1, portbench.reference.mitotic\n"
        "ref = sorted({m.split('.')[0] for m in sys.modules})\n"
        "from portbench.tests import tiny\n"
        "import pathlib\n"
        "tiny.run(tiny.cell(pathlib.Path(%r), 'g1'), seconds=1.0)\n"
        "tiny.run(tiny.cell(pathlib.Path(%r), 'mitotic'), seconds=1.0)\n"
        "run = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([ref, run]))\n" % (str(harness.ROOT), str(tmp_path), str(tmp_path)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(tmp_path), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref, run = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not set(ref) & {"jax", "jaxlib", "flax", "genome_cycle_tpu", "genome_cycle_tpu_torch"}
    assert not set(run) & {"jax", "jaxlib", "flax", "genome_cycle_tpu"}
    assert "genome_cycle_tpu_torch" in run


@pytest.mark.parametrize("driver", ["g1", "mitotic"])
def test_the_control_fails_where_the_program_passes(tmp_path, driver):
    result = tiny.run(tiny.cell(tmp_path, driver), control=torch.bfloat16)
    assert result["correct"] is True
    limits = {k: v["limit"] for k, v in result["checks"].items()}
    assert any(value > limits[name] for name, value in result["control"].items())


def _unchanged_step(original):
    def step(self, carry, step, noise=None):
        return carry
    return step


def _half_left_out(original):
    def step(self, carry, step, noise=None):
        out = original(self, carry, step, noise)
        x = out[0].clone()
        half = x.shape[-2] // 2
        x[..., half:, :] = carry[0][..., half:, :]
        return (x, out[1], out[2])
    return step


def _between_ticks(fault):
    """``fault`` on the steps without a tick only, as a CUDA graph over the
    steps between two ticks would be."""
    def wrap(original):
        faulty = fault(original)

        def step(self, carry, step, noise=None):
            tick = self.config.contactmap_update_interval
            return (original if step % tick == 0 else faulty)(self, carry, step, noise)
        return step
    wrap.__name__ = fault.__name__ + "_between_ticks"
    return wrap


def _stale_noise(original):
    def step(self, carry, step, noise=None):
        if not hasattr(self, "_stale"):
            self._stale = torch.randn_like(carry[0])
        return original(self, carry, step, self._stale)
    return step


def _tick_altered(original):
    def tick(self, x, step):
        events = original(self, x, step).clone()
        events[-1, 1] = (events[-1, 1] + 7) % x.shape[-2]
        return events
    return tick


def _merge_altered(original):
    def merge(acc, acc_n, events):
        out, n, overflow = original(acc, acc_n, events)
        out[0, 2] += 1
        return out, n, overflow
    return merge


def _frame_altered(original):
    def save(store, model, step, x, semiaxes, contacts_coo, mean_energy):
        return original(store, model, step, x + 1e-2, semiaxes, contacts_coo, mean_energy)
    return save


def _chunk_unchanged(original):
    def run_chunk(x, terms, mobility, noise, temperature, timestep):
        return x
    return run_chunk


def _chunk_altered(original):
    def run_chunk(x, terms, mobility, noise, temperature, timestep):
        out = original(x, terms, mobility, noise, temperature, timestep).clone()
        out[0] += 1e-2
        return out
    return run_chunk


def _targets():
    from genome_cycle_tpu_torch.models import interphase
    from genome_cycle_tpu_torch.ops import mitotic

    return {"step": (interphase.InterphaseModel, "_bd_step4"),
            "tick": (interphase.InterphaseModel, "contact_events_tick"),
            "merge": (interphase, "merge_events_acc"),
            "frame": (interphase, "save_g1_frame"),
            "chunk": (mitotic, "run_chunk")}


@pytest.mark.parametrize("driver,replicas,target,fault", [
    ("g1", 1, "step", _unchanged_step),
    ("g1", 2, "step", _unchanged_step),
    ("g1", 1, "step", _half_left_out),
    ("g1", 2, "step", _half_left_out),
    ("g1", 1, "step", _between_ticks(_unchanged_step)),
    ("g1", 2, "step", _between_ticks(_stale_noise)),
    ("g1", 1, "tick", _tick_altered),
    ("g1", 2, "merge", _merge_altered),
    ("g1", 1, "frame", _frame_altered),
    ("mitotic", 1, "chunk", _chunk_unchanged),
    ("mitotic", 1, "chunk", _chunk_altered),
], ids=lambda v: getattr(v, "__name__", str(v)))
def test_a_fault_in_the_timed_path_makes_the_run_incorrect(tmp_path, monkeypatch, driver,
                                                           replicas, target, fault):
    owner, name = _targets()[target]
    if target == "merge":
        from genome_cycle_tpu_torch.models import interphase
        monkeypatch.setattr(interphase, "merge_events_acc", fault(interphase.merge_events_acc))
    else:
        monkeypatch.setattr(owner, name, fault(getattr(owner, name)))
    result = tiny.run(tiny.cell(tmp_path, driver, replicas))
    assert result["correct"] is False
    assert result["failed"] > 0
    over = [k for k, v in result["checks"].items() if v["value"] > v["limit"]]
    assert over


def test_the_reservoir_samples_uniformly():
    from portbench.window import Reservoir

    counts = np.zeros(40)
    for trial in range(3000):
        pick, kept = Reservoir(3, np.random.default_rng([7, trial])), {}
        for item in range(40):
            slot = pick.offer()
            if slot is not None:
                kept[slot] = item
        assert len(kept) == 3 and len(set(kept.values())) == 3
        counts[list(kept.values())] += 1
    expected = 3000 * 3 / 40
    assert np.all(np.abs(counts - expected) < 5 * np.sqrt(expected))


def test_replica_seeds_take_large_seeds_and_differ():
    seeds = [harness.replica_seed(2 ** 31 + 12345, k) for k in range(4)]
    assert len(set(seeds)) == 4 and all(0 <= s < 2 ** 32 for s in seeds)
    assert seeds == [harness.replica_seed(2 ** 31 + 12345, k) for k in range(4)]
    assert np.all(np.asarray(seeds) >= 0)


with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_runs_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, RUN, "--workload", workload, "--seed",
                           str(2 ** 31 + 101), "--seconds", "10", "--trace", "0"],
                          capture_output=True, text=True, cwd=harness.ROOT, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
