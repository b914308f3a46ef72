"""The port's production path on the CPU: the directory store, its copy to
HDF5 that the JAX package reads, a G1 killed after a checkpoint and run
again, ``production.main``, and the compartment-memory analysis against
``examples/memory_analysis.py``.

Everything compares exactly except the memory analysis: its PC1 profiles
come from float32 power iterations on the port's side and float64 on the JAX
package's (``tests/test_torch_analysis.py``), so the correlations agree to
1e-6.
"""

import contextlib
import importlib.util
import io
import json
import os
import pathlib

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from genome_cycle_tpu import store as jstore
from genome_cycle_tpu.analysis import cool as j_cool
from genome_cycle_tpu.analysis.coolio import Cooler as JCooler
from genome_cycle_tpu.models.prepare import run_prepare as j_run_prepare
from genome_cycle_tpu_torch import cli, production
from genome_cycle_tpu_torch import store as tstore
from genome_cycle_tpu_torch.analysis import cool as t_cool
from genome_cycle_tpu_torch.analysis import dephase as t_dephase
from genome_cycle_tpu_torch.analysis import memory
from genome_cycle_tpu_torch.analysis import pc1 as t_pc1
from genome_cycle_tpu_torch.models import interphase as tinter
from genome_cycle_tpu_torch.models.anatelophase import run_anatelophase
from genome_cycle_tpu_torch.models.prepare import run_prepare
from genome_cycle_tpu_torch.models.transitions import transition_interphase

from test_torch_analysis import _write_diploid_inputs
from test_torch_cycle import CONFIG as CYCLE_CONFIG
from test_torch_interphase import _seed_telophase
from test_torch_mitotic import write_inputs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"
QUIET = lambda m: None  # noqa: E731
SEED = 42
# A G1 at T = 1 with a window every 40 steps: checkpoints at 40, 80, 120.
RESUME_CONFIG = {
    "mitotic_phase": {"coarse_graining": 10},
    "interphase": {
        "steps": 120, "sampling_interval": 20, "logging_interval": 20,
        "relaxation_steps": 40, "relaxation_sampling_interval": 20,
        "contactmap_update_interval": 10, "contactmap_output_window": 2,
    },
}
KERNEL_PATH = tinter.EngineSettings(brute_force_threshold=0)


def contents(store) -> dict:
    """{path: value} of every dataset (enum: values and mapping) and
    {new: existing} of every link, as the store's own reads give them."""
    datasets, links = store._contents()
    out = {}
    for path, kind in datasets:
        if kind == "enum":
            values, mapping = store._get_enum(path)
            out[path] = (kind, values, dict(mapping))
        elif kind == "text":
            out[path] = (kind, store._get_text(path))
        elif kind == "texts":
            out[path] = (kind, list(store._get_texts(path)))
        else:
            out[path] = (kind, np.asarray(store._get(path)))
    return {"datasets": out, "links": links}


def assert_same_contents(a, b):
    assert a["links"] == b["links"]
    assert a["datasets"].keys() == b["datasets"].keys()
    for path, value in a["datasets"].items():
        other = b["datasets"][path]
        assert value[0] == other[0], path
        if value[0] in ("array", "enum"):
            assert value[1].dtype == other[1].dtype, path
            np.testing.assert_array_equal(value[1], other[1], err_msg=path)
            assert value[2:] == other[2:], path
        else:
            assert value == other, path


@pytest.fixture(scope="module")
def cycle_inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_production")
    return (tmp, *write_inputs(tmp, CYCLE_CONFIG))


@pytest.fixture(scope="module")
def simulated(cycle_inputs):
    """``simulate --device cpu`` at T = 0 into a directory store and an HDF5
    file through the CLI, and the same stages into a ``MemoryStore``."""
    tmp, config_path, chains_path = cycle_inputs
    paths = {"directory": str(tmp / "cell") + "/", "hdf5": str(tmp / "cell.h5")}
    for path in paths.values():
        assert cli.main(["simulate", "--device", CPU, "-s", str(SEED), "-o", path,
                         config_path, chains_path]) == 0
    memory_store = tstore.MemoryStore()
    run_prepare(memory_store, config_path, chains_path, seed=SEED, log=QUIET)
    run_anatelophase(memory_store, log=QUIET, device=CPU)
    transition_interphase(memory_store, log=QUIET)
    tinter.run_interphase(memory_store, log=QUIET, device=CPU)
    return paths, memory_store


def test_directory_store_holds_what_memory_and_hdf5_hold(simulated):
    """After prepare and a cycle up to the end of G1: the same datasets,
    dtypes, values, enum mappings and links in all three backends."""
    paths, memory_store = simulated
    assert os.path.isfile(os.path.join(paths["directory"], "metadata", "config.txt"))
    with tstore.open_store(paths["directory"], "r") as directory, \
            tstore.open_store(paths["hdf5"], "r") as hdf5:
        assert isinstance(directory, tstore.DirectoryStore)
        assert isinstance(hdf5, tstore.SimulationStore)
        got = contents(directory)
        assert len(got["datasets"]) > 40 and len(got["links"]) == 8
        assert_same_contents(got, contents(memory_store))
        assert_same_contents(got, contents(hdf5))
        directory.set_stage("interphase")
        assert directory.load_steps() == [0, 20, 40, 60, 80]
        assert directory.load_checkpoint() is None
        assert directory.load_master_seed() == SEED
        types, mapping = directory.load_particle_types("relaxation")        # a link
        assert types.dtype == np.int32 and mapping == hdf5.load_particle_types("interphase")[1]


def test_directory_prepare_copied_to_hdf5_equals_the_jax_prepared_file(cycle_inputs):
    """Every dataset, dtype, enum mapping and soft link, read raw and read
    through the JAX package's store."""
    tmp, config_path, chains_path = cycle_inputs
    directory, ours, theirs = str(tmp / "prep") + "/", str(tmp / "ours.h5"), str(tmp / "theirs.h5")
    run_prepare(directory, config_path, chains_path, seed=11, log=QUIET)
    with tstore.open_store(directory, "r") as src, tstore.SimulationStore(ours, "w") as dst:
        tstore.copy_store(src, dst)
    j_run_prepare(theirs, config_path, chains_path, seed=11, log=QUIET)

    def raw(path):
        out = {}
        with h5py.File(path, "r") as f:
            def visit(name, obj):
                if isinstance(obj, h5py.Group):
                    for key in obj:
                        link = obj.get(key, getlink=True)
                        if isinstance(link, h5py.SoftLink):
                            out[f"{name}/{key}"] = ("link", link.path)
                    return
                out[name] = (obj.dtype, obj.shape, obj[()], h5py.check_enum_dtype(obj.dtype))
            f.visititems(visit)
        return out

    a, b = raw(ours), raw(theirs)
    assert a.keys() == b.keys() and sum(v[0] == "link" for v in a.values()) == 8
    for name in a:
        if a[name][0] == "link":
            assert a[name] == b[name], name
            continue
        assert a[name][0] == b[name][0] and a[name][1] == b[name][1], name
        np.testing.assert_array_equal(a[name][2], b[name][2], err_msg=name)
        assert a[name][3] == b[name][3], name
    with jstore.SimulationStore(ours) as got, jstore.SimulationStore(theirs) as want:
        assert got.load_master_seed() == want.load_master_seed() == 11
        for stage in ("relaxation", "telophase", "prometaphase"):
            np.testing.assert_array_equal(got.load_particle_types(stage)[0],
                                          want.load_particle_types(stage)[0])
        for design in ("load_interphase_design", "load_prometaphase_design"):
            assert ([vars(c) for c in getattr(got, design)().chains]
                    == [vars(c) for c in getattr(want, design)().chains])


def test_jax_cool_reads_a_directory_trajectory_copied_to_hdf5(simulated, tmp_path):
    """``simulate -o cell/`` by the port, ``copy_store`` to HDF5 (positions
    and contacts with the reference's filters), the JAX package's ``cool``:
    the port's pixels."""
    paths, _ = simulated
    copied = str(tmp_path / "copied.h5")
    with tstore.open_store(paths["directory"], "r") as src, tstore.open_store(copied, "w") as dst:
        tstore.copy_store(src, dst)
    with h5py.File(copied, "r") as f:
        assert f["/stages/interphase/40/contacts"].compression == "gzip"
        assert f["/stages/interphase/40/positions"].compression_opts == 6
        assert f["/stages/interphase/40/positions"].dtype == np.float32
    j_cool.main(output=str(tmp_path / "sim.cool"), input_sims=[copied])
    clr = JCooler(str(tmp_path / "sim.cool"))
    pixels = clr.pixels()[:]
    _, b1, b2, counts = t_cool.contact_pixels([paths["directory"]], device=CPU)
    np.testing.assert_array_equal(pixels["bin1_id"].to_numpy(), b1.numpy())
    np.testing.assert_array_equal(pixels["bin2_id"].to_numpy(), b2.numpy())
    np.testing.assert_array_equal(pixels["count"].to_numpy(), counts.numpy())
    assert int(counts.sum()) > 1000


def test_leftovers_and_a_window_written_twice_do_not_show(tmp_path):
    """A temporary file a killed writer left is never read; a window written
    again replaces the first; a checkpoint without its step is no
    checkpoint."""
    root = str(tmp_path / "s") + "/"
    store = tstore.open_store(root, "w")
    store.set_stage("interphase")
    store.save_contacts(40, np.asarray([[0, 1, 3], [2, 5, 1]], np.int32))
    store.save_contacts(40, np.asarray([[0, 1, 4]], np.int32))
    leftover = os.path.join(root, "stages", "interphase", "40", ".contacts.npy.x1y2.tmp")
    pathlib.Path(leftover).write_bytes(b"half a file")
    assert store.load_contacts(40).tolist() == [[0, 1, 4]]
    assert [p for p, _ in store._contents()[0]] == ["/stages/interphase/40/contacts"]
    assert store._names("/stages/interphase/40") == ["contacts"]
    with tstore.open_store(root, "r") as reader:       # read-only: left alone
        reader.set_stage("interphase")
        assert reader.load_contacts(40).tolist() == [[0, 1, 4]]
        with pytest.raises(OSError):
            reader.save_contacts(80, np.asarray([[0, 1, 1]], np.int32))
    base = "/stages/interphase/.checkpoint"
    store._put(base + "/positions", np.zeros((2, 3), np.float32))   # killed before its step
    assert store.load_checkpoint() is None
    store.save_checkpoint(40, {"positions": np.ones((2, 3), np.float32)})
    assert store.load_checkpoint()["step"] == 40
    store.clear_checkpoint()
    assert store.load_checkpoint() is None and not store._has(base)


def _relaxation_start(target, config_path, chains_path):
    run_prepare(target, config_path, chains_path, seed=9, log=QUIET)
    store = tstore.open_store(target) if isinstance(target, str) else target
    _seed_telophase(store)
    transition_interphase(store, log=QUIET)
    return store


@pytest.fixture(scope="module")
def resume_inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_resume")
    config_path, chains_path = write_inputs(tmp, RESUME_CONFIG)
    timings = {}
    whole = _relaxation_start(tstore.MemoryStore(), config_path, chains_path)
    tinter.run_interphase(whole, KERNEL_PATH, log=QUIET, device=CPU, timings=timings)
    return tmp, config_path, chains_path, whole, timings


def test_g1_killed_after_a_checkpoint_resumes_bit_for_bit(resume_inputs):
    """The run fails in its second checkpoint (after the window at step 80
    was written, before its checkpoint); run again, it resumes at step 40
    and every frame and window equals the uninterrupted run's to the bit."""
    tmp, config_path, chains_path, whole, _ = resume_inputs
    store = _relaxation_start(str(tmp / "killed") + "/", config_path, chains_path)
    calls = []
    save = store.save_checkpoint

    def dies_on_the_second(step, arrays):
        calls.append(step)
        if len(calls) == 2:
            raise KeyboardInterrupt("killed")
        save(step, arrays)

    store.save_checkpoint = dies_on_the_second
    with pytest.raises(KeyboardInterrupt):
        tinter.run_interphase(store, KERNEL_PATH, log=QUIET, device=CPU)
    assert calls == [40, 80]
    store.set_stage("interphase")
    assert store.load_steps() == [0, 20, 40, 60, 80] and store.load_checkpoint()["step"] == 40
    del store.save_checkpoint
    log = []
    reopened = tstore.open_store(str(tmp / "killed"))
    tinter.run_interphase(reopened, KERNEL_PATH, log=log.append, device=CPU)
    assert "resuming interphase from checkpoint at step 40" in log
    for stage in ("relaxation", "interphase"):
        whole.set_stage(stage)
        reopened.set_stage(stage)
        assert reopened.load_steps() == whole.load_steps()
        for step in whole.load_steps():
            np.testing.assert_array_equal(reopened.load_positions(step), whole.load_positions(step))
            if stage == "interphase":
                assert vars(reopened.load_interphase_context(step)) == vars(
                    whole.load_interphase_context(step))
                want = whole.load_contacts(step)
                got = reopened.load_contacts(step)
                assert (got is None) == (want is None), step
                if want is not None:
                    np.testing.assert_array_equal(got, want)
    assert reopened.load_checkpoint() is None


def test_a_window_s_counts_sum_to_its_ticks_events(resume_inputs):
    """The accumulator counts the events it folds in; each stored window's
    counts sum to them, and the log line of the dump says so."""
    _, _, _, whole, timings = resume_inputs
    whole.set_stage("interphase")
    windows = timings["windows"]
    assert [w["step"] for w in windows] == [0, 40, 80, 120]
    for w in windows:
        coo = whole.load_contacts(w["step"])
        assert w["rows"] == len(coo) and int(coo[:, 2].sum()) == w["events"] > 0
        assert (w["capacity"] is None) == (w["step"] == 0)
    assert timings["grid_bound"] > 0
    logged = []
    window = tinter.WindowAccumulator(10, 2, CPU, log=logged.append)
    events = torch.tensor([[0, 1, 1], [0, 2, 1], [0, 1, 1], [3, 4, 1]], dtype=torch.int32)
    window.add(events)                   # 3 pairs in 2 rows: grows, merges again
    window.add(events[:2])
    assert logged and window.events == 6
    assert window.take()[:, 2].sum() == 6 and window.events == 0


def test_production_main_at_a_cut_config(cycle_inputs, tmp_path):
    """``production.main`` on the CPU: every stage once, the frame and
    window counts, the summary's keys, and ``pc1.tsv``/``aux.json`` equal to
    what ``cool``, ``dephase`` and ``pc1`` write for the same map; run again,
    every stage is skipped and the files are the same."""
    _, config_path, chains_path = cycle_inputs
    run = str(tmp_path / "run")
    argv = ["--output", run, "--device", CPU, "-s", str(SEED), config_path, chains_path]
    assert production.main(argv) == 0
    summary = json.loads((tmp_path / "run" / "summary.json").read_text())
    assert set(summary) == {"store", "device", "card", "seed", "particles", "depth", "stages",
                            "trajectory", "analysis"}
    assert list(summary["stages"]) == ["prepare", "anatelophase", "transition interphase",
                                       "interphase", "transition prometaphase", "prometaphase"]
    g1 = summary["stages"]["interphase"]
    assert set(g1) == {"seconds", "counters", "relaxation", "g1", "windows", "grid_bound"}
    # Each stage's counter increases: every stage writes its store; the G1
    # syncs at each tick's merge and no merge ran again (on the CPU no kernel
    # launches).
    for name, entry in summary["stages"].items():
        assert entry["counters"]["store.files"] > 0 and entry["counters"]["store.bytes"] > 0, name
        assert not any(k.startswith("launch.") and v for k, v in entry["counters"].items()), name
    assert g1["counters"]["sync.merge_unique"] == 80 // 20
    assert g1["counters"]["sync.frame_energy"] >= 5 + 3     # frames of G1 and relaxation
    assert g1["counters"].get("window.merge_reruns", 0) == 0
    assert g1["g1"]["steps"] == 80 and summary["stages"]["anatelophase"]["anaphase"]["steps"] == 300
    assert summary["trajectory"]["frames"] == 5 and summary["trajectory"]["windows"] == 3
    assert summary["trajectory"]["contact_events"] == sum(w["events"] for w in g1["windows"])
    assert summary["analysis"]["contacts"] == summary["trajectory"]["contact_events"]
    assert {"pixels", "haploid_bins", "kept", "ice_rounds", "seconds"} <= set(summary["analysis"])
    with tstore.open_store(production.store_path(run), "r") as store:
        store.set_stage("prometaphase")
        assert store.load_steps() == [0, 100, 200, 300]

    cools = tmp_path / "files"
    cools.mkdir()
    t_cool.main(output=str(cools / "sim.cool"), input_sims=[production.store_path(run)],
                device=CPU)
    t_dephase.main(output=str(cools / "hap.cool"), input=str(cools / "sim.cool"), device=CPU)
    t_pc1.main(cool=str(cools / "hap.cool"), output=str(cools / "pc1.tsv"),
               aux_output=str(cools / "aux.json"), device=CPU)
    for name in ("pc1.tsv", "aux.json"):
        assert (tmp_path / "run" / name).read_text() == (cools / name).read_text(), name
    assert pd.read_csv(cools / "pc1.tsv", sep="\t")["ev1"].notna().sum() > 200

    before = (tmp_path / "run" / "pc1.tsv").read_text()
    assert production.main(argv) == 0
    again = json.loads((tmp_path / "run" / "summary.json").read_text())
    assert all(entry == {"skipped": True} for entry in again["stages"].values())
    assert (tmp_path / "run" / "pc1.tsv").read_text() == before
    with pytest.raises(ValueError, match="another run"):
        production.main(["--output", run, "--device", CPU, "-s", str(SEED + 1),
                         config_path, chains_path])


def test_memory_analysis_matches_the_example(tmp_path):
    """Three cycles of a two-chromosome diploid system (``cycles -n 3``,
    T = 0): ``analysis/memory.py`` prints what ``examples/memory_analysis.py``
    prints, and its matrix and control agree to 1e-6 with the same formulas
    on the example's profiles (the JAX package's cool, dephase and pc1)."""
    config_path, chains_path = _write_diploid_inputs(tmp_path)
    pathlib.Path(config_path).write_text(json.dumps(CYCLE_CONFIG))
    prefix = str(tmp_path / "mem_")
    assert cli.main(["cycles", "-n", "3", "--device", CPU, "-s", "5", "-o", prefix,
                     config_path, chains_path]) == 0
    paths = [f"{prefix}cell_{k}.h5" for k in range(3)]
    spec = importlib.util.spec_from_file_location(
        "memory_analysis_example", ROOT / "examples" / "memory_analysis.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)

    printed = {}
    for name, run in (("example", lambda: example.main(paths)),
                      ("port", lambda: memory.main(paths, device=CPU))):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            run()
        printed[name] = out.getvalue()
    assert printed["port"] == printed["example"]
    assert "adjacent-cycle memory" in printed["port"]

    theirs = memory.memory_matrix([example.pc1_of(p) for p in paths])
    ours = memory.memory_matrix([memory.profile(p, CPU) for p in paths])
    np.testing.assert_allclose(ours[0], theirs[0], atol=1e-6)
    for got, want in zip(ours[1:], theirs[1:]):
        np.testing.assert_allclose(got, want, atol=1e-6)
    assert 0.5 < ours[0][0, 1] <= 1 and ours[0][0, 0] == pytest.approx(1.0)
