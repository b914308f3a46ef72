"""The port's mesh, replicated-position engine, ensemble over ranks and
``interphase --shards`` against the single-process runs and the JAX package.

Counterparts of tests/test_parallel.py and tests/test_multihost.py (whose
two-process runs are what every case here is made of: ranks are processes on
the CPU, gloo, started by ``parallel/mesh.spawn`` with a ``file://``
rendezvous under the test's temporary directory).  Each world starts once, in
a module fixture.

Tolerances: at T = 0 positions atol 2e-5 and semiaxes rtol 1e-5 (float32
sums in another order), equal window pair sets; the ensemble over ranks
within 1e-4 of the one-process ensemble at every frame (their cell layouts
differ: one cube a rank against all cubes side by side), windows equal but
for 1 % of rows at the cutoff's edge.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from genome_cycle_tpu.parallel.mesh import make_mesh as jax_make_mesh
from genome_cycle_tpu.parallel.sharded import (
    init_sharded_carry as jax_init_sharded_carry,
    make_sharded_interphase_step as jax_sharded_step,
)
from genome_cycle_tpu_torch.config import parse_config
from genome_cycle_tpu_torch.models.anatelophase import run_anatelophase
from genome_cycle_tpu_torch.models.interphase import (
    EngineSettings, InterphaseModel, WindowAccumulator, design_arrays,
)
from genome_cycle_tpu_torch.models.prepare import run_prepare
from genome_cycle_tpu_torch.models.transitions import transition_interphase
from genome_cycle_tpu_torch.parallel import mesh, ranks
from genome_cycle_tpu_torch.parallel.ensemble import run_ensemble_interphase
from genome_cycle_tpu_torch.store import SimulationStore, StageDesign
from genome_cycle_tpu_torch.topology import ChainAssignment

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_halo as jax_halo  # noqa: E402
import test_parallel as jax_parallel  # noqa: E402

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent

N = 256
SEMIAXES = np.asarray([2.0, 2.0, 2.0], np.float32)
SETTINGS = EngineSettings()


def port_system(temperature):
    per = N // 2
    ab = np.zeros((N, 2))
    ab[::2, 0] = 1.0
    ab[1::2, 1] = 1.0
    design = StageDesign(seed=7, chains=[ChainAssignment(f"chr{i}:a", i * per, (i + 1) * per)
                                         for i in range(2)],
                         ab_factors=ab, nucleolar_bonds=np.zeros((0, 2), np.int64))
    config = parse_config(json.dumps({"interphase": {"temperature": temperature}})).interphase
    return config, design_arrays(design, config)


def ball():
    return jax_parallel.ball_positions(np.random.default_rng(1234), N).astype(np.float32)


def single_run(temperature, x, steps, seed=3):
    config, arrays = port_system(temperature)
    model = InterphaseModel(config, arrays, SETTINGS, "cpu")
    generator = torch.Generator()
    generator.manual_seed(seed)
    window = WindowAccumulator(N, None, "cpu")
    x, _, semi = model.g1_chunk((torch.as_tensor(x), generator, torch.as_tensor(SEMIAXES)),
                                0, steps, window)
    return x.numpy(), semi.numpy(), window.take()


ENSEMBLE_CONFIG = {
    "mitotic_phase": {"anaphase_steps": 200, "telophase_steps": 100, "sampling_interval": 100,
                      "logging_interval": 200, "coarse_graining": 10},
    "interphase": {"steps": 200, "sampling_interval": 100, "logging_interval": 200,
                   "relaxation_steps": 100, "relaxation_sampling_interval": 100,
                   "contactmap_output_window": 2},
}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Two replicas of a 300-bead chain through anatelophase and the
    transition (the JAX ensemble test's system), and a copy of each."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    (tmp / "config.json").write_text(json.dumps(ENSEMBLE_CONFIG))
    rows = ["chain\tstart\tend\tA\tB\ttags"]
    for i in range(300):
        tag = "cen,B" if 140 <= i < 160 else ("A" if i % 2 else "B")
        a, b = (1, 0) if tag == "A" else (0, 1)
        rows.append(f"chr1:a\t{i * 100000}\t{(i + 1) * 100000}\t{a}\t{b}\t{tag}")
    (tmp / "chains.tsv").write_text("\n".join(rows) + "\n")
    paths, copies = [], []
    for k in range(2):
        path = str(tmp / f"cell_{k}.h5")
        run_prepare(path, str(tmp / "config.json"), str(tmp / "chains.tsv"), seed=100 + k,
                    log=lambda m: None)
        with SimulationStore(path) as store:
            run_anatelophase(store, log=lambda m: None, device="cpu")
            transition_interphase(store, log=lambda m: None)
        copies.append(str(tmp / f"copy_{k}.h5"))
        shutil.copy(path, copies[-1])
        paths.append(path)
    cli_path = str(tmp / "cli.h5")
    shutil.copy(paths[0], cli_path)
    return paths, copies, cli_path


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, stores):
    tasks = [
        ("jax steps", ranks.sharded_steps, (*port_system(0.0), SETTINGS, ball(), SEMIAXES, 3, 5)),
        ("tick", ranks.sharded_steps, (*port_system(0.0), SETTINGS,
                                       jax_halo.chain_positions(N), SEMIAXES, 3, 20)),
        ("warm", ranks.sharded_steps, (*port_system(1.0), SETTINGS,
                                       jax_halo.chain_positions(N), SEMIAXES, 3, 20)),
        ("warm again", ranks.sharded_steps, (*port_system(1.0), SETTINGS,
                                             jax_halo.chain_positions(N), SEMIAXES, 3, 20)),
        ("ensemble", ranks.ensemble, (stores[0], SETTINGS)),
        ("mesh", mesh.mesh_report, (1, 2)),
    ]
    return mesh.spawn(ranks.run_tasks, 2, ["cpu"] * 2, None, tasks,
                      rendezvous=tmp_path_factory.mktemp("ranks2"), threads=1)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tasks = [("mesh", mesh.mesh_report, (2, 2)),
             ("hybrid", mesh.mesh_report, (2, 2, [0, 1, 0, 1]))]
    return mesh.spawn(ranks.run_tasks, 4, ["cpu"] * 4, None, tasks,
                      rendezvous=tmp_path_factory.mktemp("ranks4"), threads=1)


def test_mesh_construction(four_ranks, two_ranks):
    reports = [r["mesh"] for r in four_ranks]
    assert [(r["replica"], r["shard"]) for r in reports] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["grid"] == ((0, 1), (2, 3)) and r["backend"] == "gloo" for r in reports)
    # Every collective stays within the replica's beads group.
    assert [r["sum"] for r in reports] == [1.0, 1.0, 5.0, 5.0]
    assert [r["max"] for r in reports] == [1.0, 1.0, 3.0, 3.0]
    assert [(r["from_left"], r["from_right"]) for r in reports] == [
        (-1.0, 1.25), (0.5, -1.0), (-1.0, 3.25), (2.5, -1.0)]
    assert all(r["gathered"] == [[0], [0, 1]] for r in reports)
    assert [r["broadcast"][1] for r in reports] == [0, 0, 2, 2]
    assert [r["mesh"]["beads_ranks"] for r in two_ranks] == [(0, 1), (0, 1)]


def test_mesh_raises_on_too_few_ranks():
    with pytest.raises(ValueError, match="need 16 ranks"):
        mesh.make_mesh(4, 4, world=8)
    with pytest.raises(ValueError, match="every rank"):
        mesh.make_mesh(1, 2, world=4)
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh(1, 2)
    # The JAX package raises alike for devices.
    with pytest.raises(ValueError):
        jax_make_mesh(4, 4)


def test_a_mesh_never_moves_the_run_to_another_device(tmp_path):
    """A group joined directly with ``dist.init_process_group`` (as under
    ``torchrun``) puts its mesh on the local rank's card, or raises: never on
    the CPU unasked.  A run on a mesh raises when the caller names another
    device than the mesh's."""
    import torch.distributed as dist

    from genome_cycle_tpu_torch.models.interphase import run_interphase

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        if torch.cuda.device_count():
            assert mesh.make_mesh(1, 1).device == torch.device("cuda", 0)
        else:
            with pytest.raises(RuntimeError, match="without a device"):
                mesh.make_mesh(1, 1)
    finally:
        dist.destroy_process_group()
    on_cpu = mesh.Mesh(grid=((0,),), rank=0, replica=0, shard=0, device=torch.device("cpu"),
                       backend="gloo", beads_group=None)
    assert mesh.mesh_device(on_cpu) == mesh.mesh_device(on_cpu, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="mesh is on cpu"):
        mesh.mesh_device(on_cpu, "cuda")
    with pytest.raises(ValueError, match="mesh is on cpu"):
        run_interphase(None, device="cuda", mesh=on_cpu)
    with pytest.raises(ValueError, match="mesh is on cpu"):
        run_ensemble_interphase([None], device="cuda:0", mesh=on_cpu)


def test_hybrid_mesh_is_host_major(four_ranks):
    """Host membership given per rank: each host's ranks fill whole replica
    rows, so no beads group crosses a host (make_mesh's order would put
    ranks 0 and 1, on two hosts, in one group)."""
    np.testing.assert_array_equal(mesh.hybrid_grid(2, 2, [0, 1, 0, 1]), [[0, 2], [1, 3]])
    np.testing.assert_array_equal(mesh.hybrid_grid(4, 1, [0, 0, 1, 1]), [[0], [1], [2], [3]])
    np.testing.assert_array_equal(mesh.hybrid_grid(2, 2, [0] * 4), [[0, 1], [2, 3]])
    with pytest.raises(ValueError, match="divide"):
        mesh.hybrid_grid(3, 1, [0, 1, 0])
    with pytest.raises(ValueError, match="needs 2"):
        mesh.hybrid_grid(2, 2, [0, 0, 0, 1])
    reports = [r["hybrid"] for r in four_ranks]
    assert all(r["grid"] == ((0, 2), (1, 3)) for r in reports)
    assert [r["beads_ranks"] for r in reports] == [(0, 2), (1, 3), (0, 2), (1, 3)]
    assert [r["sum"] for r in reports] == [2.0, 4.0, 2.0, 4.0]


def test_backend_rule():
    assert mesh.backend_for(["cpu", "cpu"]) == "gloo"
    assert mesh.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert mesh.backend_for(["cuda:0", "cuda"]) == "gloo"          # one card, shared
    with pytest.raises(ValueError):
        mesh.backend_for(["cpu", "cuda:0"])
    assert mesh.rank_devices(3, "cpu") == [torch.device("cpu")] * 3
    assert mesh.rank_devices(2, "cuda") == [torch.device("cuda", 0)] * 2
    if torch.cuda.device_count() < 64:
        with pytest.raises(RuntimeError, match="64 ranks need 64 CUDA cards"):
            mesh.rank_devices(64)


def test_sharded_step_runs_and_is_deterministic(two_ranks):
    for r in two_ranks:
        np.testing.assert_array_equal(r["warm"]["positions"], r["warm again"]["positions"])
        np.testing.assert_array_equal(r["warm"]["window"], r["warm again"]["window"])
        np.testing.assert_array_equal(r["warm"]["positions"], two_ranks[0]["warm"]["positions"])
    assert np.isfinite(two_ranks[0]["warm"]["positions"]).all()
    assert [r["warm"]["home"] for r in two_ranks] == [(0, 128), (128, 256)]
    # The single run's noise: T = 1 follows the unsharded run.
    x1, _, _ = single_run(1.0, jax_halo.chain_positions(N), 20)
    np.testing.assert_allclose(two_ranks[0]["warm"]["positions"], x1, atol=5e-5)


def test_sharded_matches_single_device_and_jax_at_zero_temperature(two_ranks):
    x0 = ball()
    x1, semi1, _ = single_run(0.0, x0, 5)
    model, _ = jax_parallel.make_model(temperature=0.0)
    jmesh = jax_make_mesh(1, 8)
    carry = jax_init_sharded_carry(model, jmesh, x0[None], [3], np.asarray([[2.0, 2, 2]]))
    step = jax_sharded_step(model, jmesh)
    for s in range(1, 6):
        carry = step(carry, s)
    xj, semij = np.asarray(carry.positions)[0], np.asarray(carry.semiaxes)[0]
    got = two_ranks[0]["jax steps"]
    for x, semi in ((x1, semi1), (xj, semij)):
        np.testing.assert_allclose(got["positions"], x, atol=2e-5)
        np.testing.assert_allclose(got["semiaxes"], semi, rtol=1e-5)


def test_sharded_contacts_match_single_device(two_ranks):
    """Steps 1..20, one tick: each rank lists the pairs whose lower sorted
    index lies in its home range, so their windows together are the single
    run's."""
    x1, _, window1 = single_run(0.0, jax_halo.chain_positions(N), 20)
    got = two_ranks[0]["tick"]
    np.testing.assert_allclose(got["positions"], x1, atol=2e-5)
    assert len(window1) > 0
    np.testing.assert_array_equal(got["window"], window1)


def frames_of(path):
    with SimulationStore(path) as store:
        store.set_stage("interphase")
        return {step: (store.load_positions(step), store.load_contacts(step))
                for step in store.load_steps()}


def test_ensemble_over_ranks_equals_one_process(two_ranks, stores):
    """Each rank runs its own replica and writes only its own store; every
    frame is the one-process ensemble's."""
    paths, copies, _ = stores
    assert [r["ensemble"]["replicas"] for r in two_ranks] == [[0], [1]]
    assert all(r["ensemble"]["final"].shape == (1, 300, 3) for r in two_ranks)
    handles = [SimulationStore(p) for p in copies]
    try:
        run_ensemble_interphase(handles, log=lambda m: None, device="cpu")
    finally:
        for h in handles:
            h.close()
    for path, copy in zip(paths, copies):
        got, want = frames_of(path), frames_of(copy)
        assert sorted(got) == sorted(want) == [0, 100, 200]
        for step in want:
            np.testing.assert_allclose(got[step][0], want[step][0], atol=1e-4)
            if want[step][1] is None:
                assert got[step][1] is None
                continue
            a = {tuple(r) for r in got[step][1][:, :2]}
            b = {tuple(r) for r in want[step][1][:, :2]}
            assert len(a ^ b) <= 0.01 * len(b)
    assert np.abs(frames_of(paths[0])[200][0] - frames_of(paths[1])[200][0]).max() > 1e-3


def test_no_jax_in_the_ranks(two_ranks, four_ranks):
    """The ranks import the port alone (the functions they run live in the
    package, and ``spawn`` starts them afresh)."""
    for r in two_ranks + four_ranks:
        assert not r["mesh"]["jax_loaded"]
    for r in two_ranks:
        assert r["ensemble"]["foreign_modules"] == [] and r["tick"]["foreign_modules"] == []


def test_cli_interphase_shards_on_the_cpu(stores):
    """``interphase --shards 2 --device cpu`` end to end; without a card and
    without ``--device cpu`` it raises before it starts a rank."""
    _, _, path = stores
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-m", "genome_cycle_tpu_torch.cli", "interphase", "--shards", "2",
         "--device", "cpu", path], capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "2 shards" in proc.stderr and "backend gloo" in proc.stderr
    frames = frames_of(path)
    assert sorted(frames) == [0, 100, 200]
    assert all(np.isfinite(x).all() and x.shape == (300, 3) for x, _ in frames.values())
    assert frames[200][1] is not None and len(frames[200][1])
    with SimulationStore(path) as store:
        assert store.load_checkpoint() is None
    if not torch.cuda.is_available():
        from genome_cycle_tpu_torch import cli

        with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA cards"):
            cli.main(["interphase", "--shards", "2", path])
