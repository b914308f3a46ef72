"""The port's spans and counters (``genome_cycle_tpu_torch/utils/tracing.py``),
on the CPU.

- Off (the default): ``span`` gives one shared object that records nothing
  and never reaches ``torch.profiler``.
- On: nesting, parents, self time and ``snapshot``; a ``record_function``
  range for each span while a profiler runs, and none without one.
- Each counter at its site: a search run again by ``events_with_capacity``,
  a merge run again by a ``WindowAccumulator`` of two rows, the bytes and
  files a ``DirectoryStore`` wrote.
- A G1 chunk of a tiny model with tracing on: one ``g1.step`` a step, one
  ``tick`` and one ``merge`` a tick, the layers of a step under it and no
  host sync inside a step.
"""

import os
import time

import numpy as np
import pytest
import torch

from genome_cycle_tpu_torch.config import InterphaseConfig
from genome_cycle_tpu_torch.models import interphase as tinter
from genome_cycle_tpu_torch.ops import contact as tcontact
from genome_cycle_tpu_torch.store import DirectoryStore, InterphaseContext
from genome_cycle_tpu_torch.utils import tracing

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test leaves tracing off, as the rest of the process expects."""
    yield
    tracing.stop()


def _by_key(snap):
    return {(s["parent"], s["name"]): s for s in snap["spans"]}


def test_spans_off_are_one_shared_object_that_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tracing.start()
    tracing.stop()
    off = tracing.span("a")
    assert off is tracing.span("b") and off is tracing.sync("off_site")

    @tracing.traced("c")
    def inner(v):
        return v + 1

    with off, tracing.span("d"):
        assert inner(1) == 2
    assert tracing.snapshot()["spans"] == []


def test_spans_on_nest_with_parents_and_self_time():
    tracing.start()

    @tracing.traced("outer")
    def outer():
        with tracing.span("inner"):
            time.sleep(0.002)
        with tracing.span("inner"), tracing.sync("probe"):
            time.sleep(0.001)
        time.sleep(0.001)

    before = tracing.counters().get("sync.probe", 0)
    outer()
    with tracing.span("inner"):
        pass
    snap = tracing.snapshot()
    spans = _by_key(snap)
    assert set(spans) == {(None, "outer"), ("outer", "inner"), (None, "inner"),
                          ("inner", "sync.probe")}
    assert spans[("outer", "inner")]["calls"] == 2 and spans[(None, "inner")]["calls"] == 1
    top, kids = spans[(None, "outer")], spans[("outer", "inner")]
    assert top["total_s"] >= kids["total_s"] >= 0.003
    assert top["self_s"] == pytest.approx(top["total_s"] - kids["total_s"], abs=1e-9)
    assert top["self_s"] >= 0.001
    assert kids["self_s"] == pytest.approx(kids["total_s"]
                                           - spans[("inner", "sync.probe")]["total_s"], abs=1e-9)
    assert snap["counters"]["sync.probe"] == before + 1
    # A new start clears the spans; the counters run on.
    tracing.start()
    assert tracing.snapshot()["spans"] == []
    assert tracing.counters()["sync.probe"] == before + 1


def test_spans_on_enter_a_profiler_range_only_while_a_profiler_runs(monkeypatch):
    real = torch.profiler.record_function
    tracing.start()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"), tracing.sync("probe"):
            pass
    assert {"outer", "sync.probe"} <= {e.name for e in prof.events()}

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with tracing.span("outer"):
        pass
    monkeypatch.setattr(torch.profiler, "record_function", real)
    assert _by_key(tracing.snapshot())[(None, "outer")]["calls"] == 2


def test_a_search_run_again_counts_a_tick_rerun():
    events = torch.tensor([[0, 1, 1], [2, 3, 1], [4, 5, 1]], dtype=torch.int32)

    def search(rows):
        return events[:rows], len(events)

    before = tracing.counters()
    got = tcontact.events_with_capacity(search, tcontact.EventCapacity(2))
    assert len(got) == 3
    assert tracing.counters_since(before)["contact.tick_reruns"] == 1
    before = tracing.counters()
    tcontact.events_with_capacity(search, tcontact.EventCapacity(4))
    assert tracing.counters_since(before).get("contact.tick_reruns", 0) == 0


def test_a_merge_run_again_counts_a_merge_rerun():
    window = tinter.WindowAccumulator(10, 2, "cpu", log=lambda m: None)
    events = torch.tensor([[0, 1, 1], [0, 2, 1], [0, 1, 1], [3, 4, 1]], dtype=torch.int32)
    before = tracing.counters()
    window.add(events)                       # 3 pairs in 2 rows: grows, merges again
    window.add(events[:2])
    since = tracing.counters_since(before)
    assert since["window.merge_reruns"] == 1
    assert since["sync.merge_unique"] == since["sync.merge_pad"] == 3
    assert window.take()[:, 2].sum() == 6 and tracing.counters_since(before)["sync.take"] == 1


def test_store_bytes_are_the_sizes_of_the_files_written(tmp_path):
    store = DirectoryStore(str(tmp_path / "cell"), "w")
    store.set_stage("interphase")
    before = tracing.counters()
    tracing.start()
    store.save_positions(10, np.random.default_rng(0).normal(size=(50, 3)))
    store.save_interphase_context(10, InterphaseContext(0.1, (1.0, 1.0, 1.0), 0.9, 0.9, -1.5))
    store.save_contacts(10, np.array([[0, 1, 3], [2, 5, 1]], np.int32))
    store.append_frame(10)
    store.save_checkpoint(10, {"positions": np.zeros((50, 3), np.float32)})
    spans = _by_key(tracing.snapshot())
    since = tracing.counters_since(before)
    files = [os.path.join(top, f) for top, _, names in os.walk(tmp_path / "cell") for f in names]
    assert since["store.files"] == len(files) == 6
    assert since["store.bytes"] == sum(os.path.getsize(f) for f in files)
    assert spans[(None, "store")]["calls"] == 5


def _tiny_model(n=240, seed=4):
    """A chain of ``n`` beads, A and B in turn, on the CPU at T = 1, the
    pair force through the cell layout; and a start inside the wall."""
    af = (np.arange(n) % 2).astype(np.float64)
    rows = np.arange(n - 1)
    arrays = dict(
        af=af, bf=1.0 - af, mobility=np.ones(n),
        bond_pairs=np.stack([rows, rows + 1], 1), bond_spring=np.full(n - 1, 40.0),
        bond_length=np.full(n - 1, 0.05), loop_pairs=np.zeros((0, 2), np.int64),
        loop_spring=np.zeros(0), bond_mask=np.arange(n) < n - 1,
        bond_k_row=np.where(np.arange(n) < n - 1, 40.0, 0.0),
        bond_l_row=np.where(np.arange(n) < n - 1, 0.05, 0.0),
        loop_mask=np.zeros(n, bool), loop_k_row=np.zeros(n),
        nuc_bonds=np.zeros((0, 2), np.int64), nuc_targets=np.zeros(0, np.int64))
    config = InterphaseConfig(contactmap_update_interval=10)
    model = tinter.InterphaseModel(config, arrays,
                                   tinter.EngineSettings(brute_force_threshold=0), "cpu")
    walk = np.cumsum(np.random.default_rng(seed).normal(scale=0.03, size=(n, 3)), axis=0)
    x = torch.as_tensor(0.8 * walk / np.abs(walk).max(), dtype=torch.float32)
    generator = torch.Generator().manual_seed(seed)
    semiaxes = torch.as_tensor(config.wall_semiaxes_init, dtype=torch.float32)
    return model, (x, generator, semiaxes)


def test_a_g1_chunk_gives_one_step_span_a_step_and_one_tick_and_merge_a_tick():
    model, state = _tiny_model()
    window = tinter.WindowAccumulator(model.n, None, "cpu", log=lambda m: None)
    tracing.start()
    state = model.g1_chunk(state, 0, 30, window)
    spans = _by_key(tracing.snapshot())
    assert torch.isfinite(state[0]).all() and window.events > 0
    assert spans[(None, "g1.step")]["calls"] == 30
    for layer in ("layout", "pair", "noise", "rest"):
        assert spans[("g1.step", layer)]["calls"] == 30, layer
    assert spans[(None, "tick")]["calls"] == spans[(None, "merge")]["calls"] == 3
    assert spans[("tick", "layout")]["calls"] == 3
    assert spans[("merge", "sync.merge_unique")]["calls"] == 3
    assert not [key for key in spans if key[0] == "g1.step" and key[1].startswith("sync.")]
    step = spans[(None, "g1.step")]
    inside = sum(s["total_s"] for (parent, _), s in spans.items() if parent == "g1.step")
    assert step["self_s"] == pytest.approx(step["total_s"] - inside, abs=1e-9)
