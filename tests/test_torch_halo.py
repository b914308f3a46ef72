"""The port's halo engine (x-slab ownership, one-band halo exchange, one
process per rank) against the port's single-device run and the JAX package's
halo segment.

Counterparts of tests/test_halo.py and tests/test_halo_driver.py.  The ranks
are processes on the CPU (gloo), started by ``parallel/mesh.spawn`` with a
``file://`` rendezvous under the test's temporary directory; every world size
starts once, in a module fixture, and runs all its cases in one go
(``parallel/ranks.run_tasks``).  Each case runs the decomposed G1 phase,
``parallel/halo.run_halo_g1``, from the same start as the single run (no
relaxation), its frames going into a ``MemoryStore`` on the replica's first
rank.  The system is the JAX tests' own: two 128-bead chains on
``bench._chain_walk`` positions, wall semiaxes 2.

Tolerances: at T = 0, positions atol 2e-5 and semiaxes rtol 1e-5 (float32
sums in another order), equal window pair sets; at T = 1 the sharded runs
draw the single run's noise, so D = 2, D = 4 and the single run agree to
atol 5e-5 over 20 steps.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from genome_cycle_tpu.ops.contact import events_to_host, merge_window as jax_merge_window
from genome_cycle_tpu.parallel.halo import gather_positions as jax_gather_positions
from genome_cycle_tpu_torch.config import parse_config
from genome_cycle_tpu_torch.models.anatelophase import run_anatelophase
from genome_cycle_tpu_torch.models.interphase import (
    EngineSettings, InterphaseModel, WindowAccumulator,
)
from genome_cycle_tpu_torch.models.prepare import run_prepare
from genome_cycle_tpu_torch.models.transitions import transition_interphase
from genome_cycle_tpu_torch.parallel import mesh, ranks
from genome_cycle_tpu_torch.store import SimulationStore, StageDesign
from genome_cycle_tpu_torch.topology import ChainAssignment

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_halo as jax_halo  # noqa: E402  (the JAX tests' system and runner)
import test_halo_driver as jax_driver  # noqa: E402

torch.set_num_threads(1)

N = 256
BOUND = 2.0            # slabs of [-2, 2]: every one of 4 holds beads of the 1.2 ball
SEMIAXES = np.asarray([2.0, 2.0, 2.0], np.float32)
SEED = 3
STEPS = 20             # one tick
SETTINGS = EngineSettings()


def port_system(temperature, steps=STEPS):
    """Config and design of the system: G1 of ``steps`` steps in chunks
    (frames) of STEPS, one window over all of them."""
    per = N // 2
    ab = np.zeros((N, 2))
    ab[::2, 0] = 1.0
    ab[1::2, 1] = 1.0
    design = StageDesign(seed=7, chains=[ChainAssignment(f"chr{i}:a", i * per, (i + 1) * per)
                                         for i in range(2)],
                         ab_factors=ab, nucleolar_bonds=np.zeros((0, 2), np.int64))
    config = parse_config(json.dumps({"interphase": {
        "temperature": temperature, "steps": steps, "sampling_interval": STEPS,
        "contactmap_output_window": steps // STEPS}}))
    return config, design


def single_run(temperature, steps=STEPS, seed=SEED):
    """The port's single-device G1 steps 1..steps: (positions, semiaxes, window)."""
    config, design = port_system(temperature)
    model = InterphaseModel.from_design(design, config, SETTINGS, "cpu")
    model.bound = BOUND
    generator = torch.Generator()
    generator.manual_seed(seed)
    window = WindowAccumulator(N, None, "cpu")
    x, _, semi = model.g1_chunk((torch.as_tensor(jax_halo.chain_positions(N)), generator,
                                 torch.as_tensor(SEMIAXES)), 0, steps, window)
    return x.numpy(), semi.numpy(), window.take()


def halo_task(temperature, n_replicas=1, seeds=(SEED,), steps=STEPS, halo_width=None,
              edge_capacity=None):
    return (ranks.halo_g1, (n_replicas, *port_system(temperature, steps),
                            jax_halo.chain_positions(N), SEMIAXES, list(seeds), SETTINGS, BOUND,
                            halo_width, edge_capacity))


def outcome(result):
    """(final positions, semiaxes, window of all ticks) of a replica's first
    rank, from the frames it wrote."""
    store = result["store"]
    step = store.load_steps()[-1]
    return (result["final"], np.asarray(store.load_interphase_context(step).wall_semiaxes),
            store.load_contacts(step))


def halo_lines(result):
    return [line for line in result["log"] if line.startswith("halo:")]


@pytest.fixture(scope="module")
def driver_store(tmp_path_factory):
    """A port store of the JAX driver test's system through a short
    anatelophase and the transition (300 beads), and a copy of it."""
    tmp = tmp_path_factory.mktemp("torch_halo_driver")
    config_path, chains_path = jax_driver.write_inputs(tmp)
    path = str(tmp / "cell.h5")
    run_prepare(path, config_path, chains_path, seed=11, log=lambda m: None)
    with SimulationStore(path) as store:
        run_anatelophase(store, log=lambda m: None, device="cpu")
        transition_interphase(store, log=lambda m: None)
    single = str(tmp / "single.h5")
    pathlib.Path(single).write_bytes(pathlib.Path(path).read_bytes())
    return path, single


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tasks = [(name, *halo_task(t)) for name, t in (("cold", 0.0), ("warm", 1.0))]
    return mesh.spawn(ranks.run_tasks, 2, ["cpu"] * 2, None, tasks,
                      rendezvous=tmp_path_factory.mktemp("ranks2"), threads=1)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, driver_store):
    tasks = [
        ("cold", *halo_task(0.0)),
        ("warm", *halo_task(1.0, steps=2 * STEPS)),
        ("replicas", *halo_task(1.0, n_replicas=2, seeds=(11, 12))),
        # Two 20-step chunks with a band buffer of 4 rows, and with a halo
        # far narrower than the reach of a bead: each chunk runs again.
        ("narrow band", *halo_task(1.0, steps=2 * STEPS, edge_capacity=4)),
        ("narrow halo", *halo_task(1.0, steps=2 * STEPS, halo_width=0.05)),
        ("driver", ranks.interphase, (driver_store[0], EngineSettings(), 4)),
    ]
    return mesh.spawn(ranks.run_tasks, 4, ["cpu"] * 4, None, tasks,
                      rendezvous=tmp_path_factory.mktemp("ranks4"), threads=1)


def jax_halo_run():
    """The JAX halo segment over 8 virtual devices at T = 0, as
    tests/test_halo.py runs it: (positions, semiaxes, window)."""
    model = jax_halo.make_model(temperature=0.0)
    carry, events, stats, _ = jax_halo.run_halo(model, 8, jax_halo.chain_positions(N), SEED, STEPS)
    jax_halo.assert_clean(stats)
    return (jax_gather_positions(model, carry)[0], np.asarray(carry.semiaxes)[0],
            jax_merge_window([events_to_host(events)]))


def test_halo_matches_single_device_and_jax_at_zero_temperature(two_ranks, four_ranks):
    x1, semi1, window1 = single_run(0.0)
    xj, semij, windowj = jax_halo_run()
    assert len(window1) > 0
    np.testing.assert_allclose(x1, xj, atol=2e-5)
    for results in (two_ranks, four_ranks):
        cold = [r["cold"] for r in results]
        assert [r["shard"] for r in cold] == list(range(len(results)))
        assert all(r["store"] is None for r in cold[1:])     # one writer
        for r in cold:                              # every rank ends with the same state
            np.testing.assert_array_equal(r["final"], cold[0]["final"])
            assert r["timings"]["g1_steps_run_again"] == 0
        assert halo_lines(cold[0]) == []
        got = outcome(cold[0])
        for x, semi, window in ((x1, semi1, window1), (xj, semij, windowj)):
            np.testing.assert_allclose(got[0], x, atol=2e-5)
            np.testing.assert_allclose(got[1], semi, rtol=1e-5)
            np.testing.assert_array_equal(got[2], window)


def test_halo_equivalent_across_shard_counts_and_to_the_single_run(two_ranks, four_ranks):
    """The sharded ranks draw the single run's noise: D = 2, D = 4 and the
    unsharded run agree at T = 1 (the JAX module agrees only across shard
    counts)."""
    x1, semi1, window1 = single_run(1.0)
    warm2 = outcome(two_ranks[0]["warm"])
    np.testing.assert_allclose(warm2[0], x1, atol=5e-5)
    np.testing.assert_allclose(warm2[1], semi1, rtol=1e-5)
    np.testing.assert_array_equal(warm2[2], window1)
    x40, semi40, window40 = single_run(1.0, steps=2 * STEPS)
    warm4 = outcome(four_ranks[0]["warm"])
    np.testing.assert_allclose(warm4[0], x40, atol=5e-5)
    np.testing.assert_array_equal(warm4[2], window40)


def test_halo_replicas_diverge(four_ranks):
    replicas = [r["replicas"] for r in four_ranks]
    assert [(r["replica"], r["shard"]) for r in replicas] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    a, b = replicas[0]["final"], replicas[2]["final"]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert np.abs(a - b).max() > 1e-4
    np.testing.assert_array_equal(replicas[1]["final"], a)
    assert replicas[1]["store"] is None and replicas[2]["store"] is not None
    # Replica 1 is the single run of its own seed.
    np.testing.assert_allclose(b, single_run(1.0, seed=12)[0], atol=5e-5)


@pytest.mark.parametrize("case,why", [("narrow band", "band overflow"),
                                      ("narrow halo", "halo width")])
def test_halo_retries_recover_the_trajectory_without_a_retry(four_ranks, case, why):
    """A band buffer too small for the band, or a halo narrower than the
    beads' reach, makes every chunk run again, widened, from its saved state
    (positions, generator, window): the result is the run without a retry."""
    retried = four_ranks[0][case]
    lines = halo_lines(retried)
    assert len(lines) >= 2 and all(why in line for line in lines)
    assert all(r[case]["log"] == [] for r in four_ranks[1:])     # rank 0 logs
    # Every rank counts the steps that ran again: a chunk for each retry.
    assert all(r[case]["timings"]["g1_steps_run_again"] == STEPS * len(lines) for r in four_ranks)
    got, plain = outcome(retried), outcome(four_ranks[0]["warm"])
    np.testing.assert_allclose(got[0], plain[0], atol=5e-5)
    np.testing.assert_array_equal(got[2], plain[2])
    geometry = retried["timings"]["halo"]
    if case == "narrow band":
        assert geometry["edge_capacity"] > 4
    else:
        assert geometry["halo_width"] > 0.3


def test_halo_driver_writes_reference_schema_trajectory(four_ranks, driver_store):
    """``run_interphase(n_shards=4)`` on every rank: rank 0 alone opens the
    store and writes the schema of the single-device run, whose frames it
    follows (the same noise)."""
    path, single = driver_store
    log = four_ranks[0]["driver"]["log"]
    assert any("4 shards" in line for line in log)
    assert all(r["driver"]["log"] == [] for r in four_ranks[1:])
    from genome_cycle_tpu_torch.models.interphase import run_interphase

    with SimulationStore(single) as store:
        run_interphase(store, log=lambda m: None, device="cpu")
    with SimulationStore(path) as store, SimulationStore(single) as want:
        for s in (store, want):
            s.set_stage("interphase")
        steps = store.load_steps()
        assert steps == want.load_steps() == [0, 100, 200]
        for step in steps:
            x = store.load_positions(step)
            assert x.shape == (300, 3) and np.isfinite(x).all()
            np.testing.assert_allclose(x, want.load_positions(step), atol=1e-3)
            ctx, ctx_want = store.load_interphase_context(step), want.load_interphase_context(step)
            assert ctx.time == pytest.approx(step * 1e-5)
            assert ctx.mean_energy == pytest.approx(ctx_want.mean_energy, rel=1e-3)
            np.testing.assert_allclose(ctx.wall_semiaxes, ctx_want.wall_semiaxes, rtol=1e-5)
            coo, coo_want = store.load_contacts(step), want.load_contacts(step)
            assert len(coo) and (coo[:, 0] < coo[:, 1]).all()
            same = {tuple(r) for r in coo[:, :2]} ^ {tuple(r) for r in coo_want[:, :2]}
            assert len(same) <= 0.01 * len(coo_want)
        assert store.load_checkpoint() is None
    np.testing.assert_allclose(four_ranks[0]["driver"]["final"], four_ranks[3]["driver"]["final"])
