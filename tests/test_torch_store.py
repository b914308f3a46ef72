"""The port's trajectory store: HDF5 and memory backends, and the JAX
package reading what the port wrote.  Everything here is exact: integers,
strings, and float32 values that went through the same quantization."""

import dataclasses
import json

import h5py
import numpy as np
import pytest

from genome_cycle_tpu import native as jnative
from genome_cycle_tpu import store as jstore
from genome_cycle_tpu.models.prepare import run_prepare as j_run_prepare
from genome_cycle_tpu_torch import store as tstore
from genome_cycle_tpu_torch.models.prepare import run_prepare

from test_torch_interphase import _write_inputs


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_store")
    return _write_inputs(tmp) + (tmp,)


def _fill(store, n):
    """The same frames, contexts, contacts and checkpoint into any store."""
    rng = np.random.default_rng(0)
    store.set_stage("interphase")
    store.clear_frames()
    for step in (0, 10, 20):
        store.save_positions(step, rng.normal(size=(n, 3)))
        store.save_interphase_context(step, tstore.InterphaseContext(
            time=step * 1e-5, wall_semiaxes=(2.0, 2.1, 2.2), core_scale=0.5,
            bond_scale=0.6, mean_energy=float(step),
        ))
        store.append_frame(step)
    coo = np.asarray([[0, 1, 3], [0, 7, 1], [2, 5, 9]], np.int32)
    store.save_contacts(0, coo)
    store.save_contacts(10, np.zeros((0, 3), np.int32))          # no-op
    store.save_checkpoint(20, {"positions": rng.normal(size=(n, 3)).astype(np.float32),
                               "semiaxes": np.asarray([2.0, 2.1, 2.2], np.float32),
                               "key": np.arange(16, dtype=np.uint8)})
    return coo


def _snapshot(store):
    out = {"config": store.load_config(), "seed": store.load_master_seed(),
           "chains_source": store.load_chains_source()}
    for stage, load in (("anaphase", store.load_anatelophase_design),
                        ("interphase", store.load_interphase_design),
                        ("prometaphase", store.load_prometaphase_design)):
        out[stage] = load()
        out[stage + "_types"] = store.load_particle_types(stage)
    for stage in ("relaxation", "telophase"):
        out[stage + "_types"] = store.load_particle_types(stage)   # soft links
        out[stage + "_chains"] = store.load_chain_assignments(stage)
    store.set_stage("interphase")
    out["steps"] = store.load_steps()
    out["positions"] = [store.load_positions(s) for s in out["steps"]]
    out["contexts"] = [store.load_interphase_context(s) for s in out["steps"]]
    out["contacts"] = [store.load_contacts(s) for s in out["steps"]]
    out["checkpoint"] = store.load_checkpoint()
    out["has"] = [store.check_positions(s) for s in (0, 5)]
    return out


def _assert_same(a, b):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), (type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif hasattr(a, "__dataclass_fields__"):
        _assert_same(vars(a), vars(b))
    else:
        assert a == b


def test_memory_store_and_hdf5_hold_the_same(inputs):
    config_path, chains_path, tmp = inputs
    path = str(tmp / "a.h5")
    memory = tstore.MemoryStore()
    run_prepare(path, config_path, chains_path, seed=7, log=lambda m: None)
    run_prepare(memory, config_path, chains_path, seed=7, log=lambda m: None)
    with tstore.SimulationStore(path) as disk:
        n = disk.load_interphase_design().particle_count
        coo = _fill(disk, n)
        _fill(memory, n)
        a, b = _snapshot(disk), _snapshot(memory)
        _assert_same(a, b)
        assert a["steps"] == [0, 10, 20] and a["has"] == [True, False]
        np.testing.assert_array_equal(a["contacts"][0], coo)
        assert a["contacts"][1] is None
        assert a["checkpoint"]["step"] == 20 and a["checkpoint"]["key"].dtype == np.uint8
        for store in (disk, memory):
            store.truncate_frames(10)
            assert store.load_steps() == [0, 10]
            store.append_frames([30, 40])
            assert store.load_steps() == [0, 10, 30, 40]
            store.clear_checkpoint()
            assert store.load_checkpoint() is None
            store.clear_frames()
            assert store.load_steps() == []
    # Reads hand out copies: changing one does not change the store.
    memory.set_stage("interphase")
    memory.load_positions(0)[:] = 0
    assert memory.load_positions(0).any()


def test_positions_are_quantized_alike_everywhere(inputs):
    rng = np.random.default_rng(1)
    values = np.concatenate([rng.normal(size=500) * 10 ** rng.uniform(-6, 3, 500),
                             [0.0, 1.0, -1.0, 1e-300]])
    for bits in (8, 16):
        np.testing.assert_array_equal(
            tstore.quantize_f64(values, bits), jnative.quantize_f64(values, bits)
        )
    q = tstore.quantize_positions(values.reshape(-1, 3)[:100])
    np.testing.assert_array_equal(q, jstore.quantize_positions(values.reshape(-1, 3)[:100]))
    rel = np.abs(q - values.reshape(-1, 3)[:100]) / np.abs(values.reshape(-1, 3)[:100])
    assert rel.max() <= 2.0 ** -16


def test_prepared_file_equals_the_jax_package_s(inputs):
    """Dataset by dataset, dtype by dtype, soft links included."""
    config_path, chains_path, tmp = inputs
    ours, theirs = str(tmp / "ours.h5"), str(tmp / "theirs.h5")
    run_prepare(ours, config_path, chains_path, seed=11, log=lambda m: None)
    j_run_prepare(theirs, config_path, chains_path, seed=11, log=lambda m: None)

    def contents(path):
        out = {}
        with h5py.File(path, "r") as f:
            def visit(name):
                link = f.get(name, getlink=True)
                obj = f[name]
                if isinstance(obj, h5py.Dataset):
                    out[name] = (obj.dtype, obj.shape, obj[()],
                                 h5py.check_enum_dtype(obj.dtype),
                                 link.path if isinstance(link, h5py.SoftLink) else None)
            f.visit(visit)
            for stage in ("relaxation", "telophase"):   # visit skips soft links
                for key in f[f"/stages/{stage}/metadata"]:
                    name = f"stages/{stage}/metadata/{key}"
                    link = f.get(name, getlink=True)
                    out[name] = ("link", link.path if isinstance(link, h5py.SoftLink) else None)
        return out

    a, b = contents(ours), contents(theirs)
    assert a.keys() == b.keys() and len(a) > 25
    for name in a:
        if a[name][0] == "link":
            assert a[name] == b[name] and a[name][1] is not None, name
            continue
        assert a[name][0] == b[name][0] and a[name][1] == b[name][1], name
        np.testing.assert_array_equal(a[name][2], b[name][2], err_msg=name)
        assert a[name][3] == b[name][3], name


def test_jax_package_reads_a_file_the_port_wrote(inputs):
    config_path, chains_path, tmp = inputs
    path = str(tmp / "shared.h5")
    run_prepare(path, config_path, chains_path, seed=5, log=lambda m: None)
    with tstore.SimulationStore(path) as store:
        n = store.load_interphase_design().particle_count
        _fill(store, n)
        ours = _snapshot(store)
    with jstore.SimulationStore(path) as store:
        theirs = _snapshot(store)
    assert ours["steps"] == theirs["steps"] == [0, 10, 20]
    for key in ("positions", "contacts", "seed", "chains_source"):
        _assert_same(ours[key], theirs[key])
    for a, b in zip(ours["contexts"], theirs["contexts"]):
        assert vars(a) == vars(b)
    assert dataclasses.asdict(ours["config"]) == dataclasses.asdict(theirs["config"])
    for stage in ("anaphase", "interphase", "prometaphase"):
        assert [vars(c) for c in ours[stage].chains] == [vars(c) for c in theirs[stage].chains]
        _assert_same(ours[stage + "_types"], theirs[stage + "_types"])
    np.testing.assert_array_equal(ours["interphase"].ab_factors, theirs["interphase"].ab_factors)
    np.testing.assert_array_equal(
        ours["interphase"].nucleolar_bonds, theirs["interphase"].nucleolar_bonds
    )
    with h5py.File(path, "r") as f:
        raw = json.loads(f["/stages/interphase/10/context"][()].decode())
        assert list(raw) == ["time", "wall_semiaxes", "core_scale", "bond_scale",
                             "mean_energy", "wall_energy"]
        assert f["/stages/interphase/0/contacts"].compression == "gzip"
        assert f["/stages/interphase/0/positions"].dtype == np.float32


def test_cool_reads_a_trajectory_the_port_wrote(inputs):
    """prepare -> telophase seed -> transition -> run_interphase on the CPU,
    all by the port, then the JAX package's `cool` over the file."""
    from genome_cycle_tpu.analysis import cool as cool_mod
    from genome_cycle_tpu.analysis.coolio import Cooler
    from genome_cycle_tpu_torch.models.interphase import run_interphase
    from genome_cycle_tpu_torch.models.transitions import transition_interphase
    from test_torch_interphase import _seed_telophase

    config_path, chains_path, tmp = inputs
    path = str(tmp / "run.h5")
    run_prepare(path, config_path, chains_path, seed=9, log=lambda m: None)
    with tstore.SimulationStore(path) as store:
        _seed_telophase(store)
        transition_interphase(store, log=lambda m: None)
        run_interphase(store, log=lambda m: None, device="cpu")   # brute path
        store.set_stage("interphase")
        total = sum(int(store.load_contacts(s)[:, 2].sum()) for s in (0, 40, 80))
    out = str(tmp / "sim.cool")
    cool_mod.main(output=out, input_sims=[path])
    clr = Cooler(out)
    assert set(clr.chromnames) == {"chr1:a", "chr2:a", "nucleoli"}
    assert clr.nbins == 504
    mat = clr.matrix(balance=False)[:, :]
    assert np.triu(mat).sum() == total
