"""The port's replica ensemble against the JAX package's and against its own
single run.

The system is the 300-bead chain of tests/test_parallel.py's ensemble test,
two replicas prepared by the port with seeds 101 and 100, each with a
telophase frame seeded with numpy (a random walk per coarse chain inside the
wall) and the transition to interphase.  The pair force takes the cell-range
path (``brute_force_threshold=0``), as the ensemble does at full width.

Tolerances:
- against the JAX ensemble at temperature 0: positions at every frame within
  1e-4 * max(|x|, 1) (float32 sums in another order over 120 steps), wall
  semiaxes within 1e-5 relative, window rows equal but for 1 % of pairs at
  the cutoff's edge;
- replica k against ``run_interphase`` of store k at temperature 1, same seed
  and so the same draws: positions within 1e-4 over the relaxation and the
  whole G1 of 80 steps (the two runs' grids may differ, the ensemble's spans
  the wider replica, so the plain pair force may sum in another order);
- where one replica is perturbed, the other's trajectory, wall and contacts
  are equal to the bit: nothing couples them.
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from genome_cycle_tpu.models.interphase import EngineSettings as JSettings
from genome_cycle_tpu.parallel.ensemble import run_ensemble_interphase as j_ensemble
from genome_cycle_tpu.store import SimulationStore as JStore
from genome_cycle_tpu_torch import cli, convert
from genome_cycle_tpu_torch.models import interphase as tinter
from genome_cycle_tpu_torch.models.prepare import run_prepare
from genome_cycle_tpu_torch.models.transitions import transition_interphase
from genome_cycle_tpu_torch.ops import pair_kernels as pk
from genome_cycle_tpu_torch.ops.contact import split_window
from genome_cycle_tpu_torch.parallel.ensemble import run_ensemble_interphase
from genome_cycle_tpu_torch.store import MemoryStore, SimulationStore

from test_torch_interphase import _seed_telophase

torch.set_num_threads(1)

KERNEL_PATH = tinter.EngineSettings(brute_force_threshold=0)
# In this order the JAX engine, which sizes its block slots on the last
# replica it probes, probes the denser replica last and compiles its G1
# segment once; the other order costs a second compile (about 17 s on one
# core) and a step-0 window that lacks pairs (see ROADMAP.md, Queue 3).
SEEDS = (101, 100)
FRAMES = {"relaxation": [0, 20, 40], "interphase": [0, 20, 40, 60, 80]}


def config(temperature, coarse_graining=10):
    return {
        "mitotic_phase": {
            "coarse_graining": coarse_graining,
            "anaphase_steps": 200, "telophase_steps": 100,
            "sampling_interval": 100, "logging_interval": 200,
        },
        "interphase": {
            "temperature": temperature,
            "steps": 80, "sampling_interval": 20, "logging_interval": 80,
            "relaxation_steps": 40, "relaxation_sampling_interval": 20,
            "contactmap_update_interval": 10, "contactmap_output_window": 2,
        },
    }


def write_inputs(tmp, temperature, beads=300, coarse_graining=10):
    config_path = tmp / f"config_{temperature:g}.json"
    config_path.write_text(json.dumps(config(temperature, coarse_graining)))
    rows = ["chain\tstart\tend\tA\tB\ttags"]
    for i in range(beads):
        tag = "cen,B" if 140 <= i < 160 else ("A" if i % 2 else "B")
        a, b = (1, 0) if tag == "A" else (0, 1)
        rows.append(f"chr1:a\t{i*100000}\t{(i+1)*100000}\t{a}\t{b}\t{tag}")
    chains_path = tmp / f"chains_{beads}.tsv"
    chains_path.write_text("\n".join(rows) + "\n")
    return str(config_path), str(chains_path)


def prepare_replicas(tmp, temperature):
    """Two port-prepared files up to the relaxation's start."""
    config_path, chains_path = write_inputs(tmp, temperature)
    paths = []
    for k, seed in enumerate(SEEDS):
        path = str(tmp / f"t{temperature:g}_rep_{k}.h5")
        run_prepare(path, config_path, chains_path, seed=seed, log=lambda m: None)
        with SimulationStore(path) as store:
            _seed_telophase(store, seed=seed)
            transition_interphase(store, log=lambda m: None)
        paths.append(path)
    return paths


def copies(paths, tmp, label):
    out = []
    for k, path in enumerate(paths):
        out.append(str(tmp / f"{label}_{k}.h5"))
        shutil.copy(path, out[-1])
    return out


def run_port_ensemble(paths, **kwargs):
    stores = [SimulationStore(p) for p in paths]
    try:
        return run_ensemble_interphase(stores, settings=KERNEL_PATH, device="cpu", **kwargs)
    finally:
        for store in stores:
            store.close()


def frames_of(path):
    """{stage: {step: (positions, context, contacts)}} of a file."""
    out = {}
    with SimulationStore(path) as store:
        for stage in FRAMES:
            store.set_stage(stage)
            out[stage] = {
                step: (store.load_positions(step), store.load_interphase_context(step),
                       store.load_contacts(step))
                for step in store.load_steps()
            }
    return out


def pairs_within(x, cutoff):
    """Every pair i < j closer than ``cutoff``, as window rows [i, j, 1]."""
    r = np.linalg.norm(x[:, None].astype(np.float64) - x[None], axis=-1)
    i, j = np.nonzero(np.triu(r < cutoff, 1))
    return np.stack([i, j, np.ones_like(i)], axis=1)


def assert_windows_close(got, want):
    a, b = set(map(tuple, got.tolist())), set(map(tuple, want.tolist()))
    assert len(a) > 50
    assert len(a ^ b) <= 0.01 * len(a)


# -- against the JAX ensemble, temperature 0 ----------------------------------

@pytest.fixture(scope="module")
def cold(tmp_path_factory):
    """The port's and the JAX package's ensembles on copies of two stores."""
    tmp = tmp_path_factory.mktemp("ensemble_cold")
    paths = prepare_replicas(tmp, 0.0)
    port, jax_paths = copies(paths, tmp, "port"), copies(paths, tmp, "jax")
    logs, timings = [], {}
    final = run_port_ensemble(port, log=logs.append, timings=timings)
    stores = [JStore(p) for p in jax_paths]
    try:
        j_ensemble(stores, settings=JSettings(
            cell_capacity=128, contact_capacity=128, grid_bound=9.0, use_dense_grid=False,
        ), log=lambda m: None)
    finally:
        for store in stores:
            store.close()
    return paths, port, jax_paths, final, logs, timings


def test_ensemble_matches_jax_at_every_frame(cold):
    _, port, jax_paths, final, _, timings = cold
    for k in range(2):
        got = frames_of(port[k])
        with JStore(jax_paths[k]) as js:
            for stage, steps in FRAMES.items():
                js.set_stage(stage)
                assert sorted(got[stage]) == js.load_steps() == steps
                for step in steps:
                    x, ctx, coo = got[stage][step]
                    want = js.load_positions(step)
                    jctx = js.load_interphase_context(step)
                    scale = max(float(np.abs(want).max()), 1.0)
                    np.testing.assert_allclose(x, want, rtol=0, atol=1e-4 * scale)
                    assert ctx.wall_semiaxes == pytest.approx(jctx.wall_semiaxes, rel=1e-5)
                    assert ctx.time == pytest.approx(jctx.time)
                    assert ctx.core_scale == pytest.approx(jctx.core_scale, rel=1e-6)
                    assert ctx.bond_scale == pytest.approx(jctx.bond_scale, rel=1e-6)
                    assert ctx.mean_energy == jctx.mean_energy == 0.0   # no energy pass
                    if stage == "interphase" and step == 0:
                        # The JAX ensemble's step-0 tick ignores its overflow
                        # count, sized on the structure before relaxation: it
                        # drops pairs, and never adds one.  Held against every
                        # pair closer than the cutoff instead.
                        jrows = set(map(tuple, js.load_contacts(0).tolist()))
                        assert jrows <= set(map(tuple, coo.tolist()))
                        assert_windows_close(coo, pairs_within(x, 0.24 * ctx.core_scale))
                    elif stage == "interphase" and step % 40 == 0:
                        assert_windows_close(coo, js.load_contacts(step))
                    else:
                        assert coo is None and js.load_contacts(step) is None
        np.testing.assert_allclose(final[k], got["interphase"][80][0], atol=1e-4)
    # The replicas are two samples, not one.
    assert np.abs(final[0] - final[1]).max() > 1e-2
    assert got["interphase"][20][1].wall_semiaxes != (2.0, 2.0, 2.0)
    assert timings["relaxation_steps"] == 40 and timings["g1_steps"] == 80


def test_every_tick_of_every_chunk_is_merged(cold):
    """Four ticks a window (tick 10, window 40 steps): the longest-lived
    contacts are counted four times, in every window."""
    _, port, *_ = cold
    for path in port:
        frames = frames_of(path)["interphase"]
        assert frames[0][2][:, 2].max() == 1
        for step in (40, 80):
            coo = frames[step][2]
            key = (coo[:, 0].astype(np.int64) << 32) | coo[:, 1]
            assert (np.diff(key) > 0).all() and (coo[:, 0] < coo[:, 1]).all()
            assert coo[:, 2].max() == 4 and coo[:, 1].max() < 300
        assert all(frames[step][2] is None for step in (20, 60))


# -- against the port's single run, temperature 1 ------------------------------

@pytest.fixture(scope="module")
def warm(tmp_path_factory):
    """The port's ensemble (with a window accumulator too small to start
    with) and ``run_interphase`` of each store, at temperature 1."""
    tmp = tmp_path_factory.mktemp("ensemble_warm")
    paths = prepare_replicas(tmp, 1.0)
    ensemble = copies(paths, tmp, "ensemble")
    saved, logs = {}, []
    stores = [SimulationStore(p) for p in ensemble]
    try:
        for k, store in enumerate(stores):
            real = store.save_checkpoint
            store.save_checkpoint = lambda step, arrays, real=real, k=k: (
                saved.setdefault(k, []).append(
                    (step, {name: np.array(v) for name, v in arrays.items()})),
                real(step, arrays),
            )
        final = run_ensemble_interphase(
            stores, settings=tinter.EngineSettings(brute_force_threshold=0, acc_capacity=64),
            log=logs.append, device="cpu")
    finally:
        for store in stores:
            store.close()
    single = copies(paths, tmp, "single")
    for path in single:
        with SimulationStore(path) as store:
            tinter.run_interphase(store, settings=KERNEL_PATH, log=lambda m: None, device="cpu")
    return paths, ensemble, single, saved, logs, final


def test_replica_draws_what_its_single_run_draws(warm):
    _, ensemble, single, _, logs, _ = warm
    for k in range(2):
        got, want = frames_of(ensemble[k]), frames_of(single[k])
        for stage, steps in FRAMES.items():
            for step in steps:
                np.testing.assert_allclose(got[stage][step][0], want[stage][step][0], atol=1e-4)
                assert got[stage][step][1].wall_semiaxes == pytest.approx(
                    want[stage][step][1].wall_semiaxes, rel=1e-5)
        for step in (0, 40, 80):
            assert_windows_close(got["interphase"][step][2], want["interphase"][step][2])
        # It moved: the noise is live.
        assert np.abs(got["interphase"][80][0] - got["relaxation"][40][0]).max() > 1e-2
    assert any("growing window accumulator" in line for line in logs)
    assert sum("[relaxation]" in line for line in logs) == 2
    assert sum("2 replicas" in line and "bead-steps/s" in line for line in logs) == 1


def test_checkpoint_holds_each_replicas_state(warm):
    _, ensemble, _, saved, _, _ = warm
    for k in range(2):
        assert [step for step, _ in saved[k]] == [40, 80]        # window boundaries
        step, arrays = saved[k][0]
        assert set(arrays) == {"positions", "semiaxes", "key"}
        assert arrays["positions"].shape == (300, 3) and arrays["semiaxes"].shape == (3,)
        torch.Generator().set_state(torch.from_numpy(arrays["key"]))
        with SimulationStore(ensemble[k]) as store:
            assert store.load_checkpoint() is None                # cleared at the end
            store.set_stage("interphase")
            np.testing.assert_allclose(arrays["positions"], store.load_positions(40), atol=1e-4)
    assert not np.array_equal(saved[0][0][1]["key"], saved[1][0][1]["key"])


def test_an_ensemble_of_one_writes_what_its_single_run_writes(warm, tmp_path):
    """One stage runs one store and R: an ensemble of one store writes the
    frames, windows and checkpoints that ``run_interphase`` writes for it,
    its contexts equal but for the mean energy (an ensemble's frames carry
    0.0: no energy pass)."""
    source = warm[0][:1]
    paths = {"ensemble": copies(source, tmp_path, "one")[0],
             "single": copies(source, tmp_path, "single")[0]}
    runs = {
        "ensemble": lambda store: run_ensemble_interphase(
            [store], settings=KERNEL_PATH, log=lambda m: None, device="cpu"),
        "single": lambda store: tinter.run_interphase(
            store, settings=KERNEL_PATH, log=lambda m: None, device="cpu"),
    }
    checkpoints = {}
    for label, path in paths.items():
        with SimulationStore(path) as store:
            real = store.save_checkpoint
            store.save_checkpoint = lambda step, arrays, real=real, label=label: (
                checkpoints.setdefault(label, []).append(step), real(step, arrays))
            runs[label](store)
    assert checkpoints["ensemble"] == checkpoints["single"] == [40, 80]
    got, want = frames_of(paths["ensemble"]), frames_of(paths["single"])
    for stage, steps in FRAMES.items():
        assert sorted(got[stage]) == sorted(want[stage]) == steps
        for step in steps:
            (x, ctx, coo), (x_1, ctx_1, coo_1) = got[stage][step], want[stage][step]
            np.testing.assert_allclose(x, x_1, atol=1e-4)
            assert ctx.mean_energy == 0.0 and ctx_1.mean_energy != 0.0
            assert vars(ctx) == vars(dataclasses.replace(ctx_1, mean_energy=0.0))
            if coo_1 is None:
                assert coo is None
            else:
                assert_windows_close(coo, coo_1)
    assert all(want["interphase"][step][2] is not None for step in (0, 40, 80))


@pytest.mark.parametrize("both", [True, False], ids=["every-store", "one-store"])
def test_resume_at_a_window_boundary(warm, tmp_path, both):
    """Kill-and-resume: with a checkpoint in every store the run continues
    from it and ends where the uninterrupted run ended; with one in a single
    store it starts afresh."""
    _, ensemble, _, saved, _, _ = warm
    paths = copies(ensemble, tmp_path, "resume")
    reference = [frames_of(p)["interphase"] for p in ensemble]
    for k, path in enumerate(paths):
        with SimulationStore(path) as store:
            store.set_stage("interphase")
            if both or k == 0:
                store.save_checkpoint(40, saved[k][0][1])
            store.truncate_frames(40)
    logs = []
    run_port_ensemble(paths, log=logs.append)
    assert any("resuming ensemble interphase from step 40" in m for m in logs) == both
    for k, path in enumerate(paths):
        got = frames_of(path)["interphase"]
        assert sorted(got) == FRAMES["interphase"]
        np.testing.assert_allclose(got[80][0], reference[k][80][0], atol=1e-4)
        assert_windows_close(got[80][2], reference[k][80][2])
        with SimulationStore(path) as store:
            assert store.load_checkpoint() is None


# -- the stacked layout --------------------------------------------------------

def _replica_beads(replicas, n=400, seed=5):
    """Beads of R replicas, some beyond the grid's bound on every side."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (replicas, n, 3))
    x[:, :10] *= 2.0                      # outside the grid, clipped
    af = rng.uniform(0, 1, n)
    return (torch.as_tensor(x, dtype=torch.float32),
            torch.as_tensor(af, dtype=torch.float32), torch.as_tensor(1 - af, dtype=torch.float32))


def test_one_replica_layout_equals_the_single_layout():
    x, af, bf = _replica_beads(1)
    single = pk.build_cell_layout(x[0], af, bf, 1.2, 0.3)
    stacked = pk.build_cell_layout(x, af, bf, 1.2, 0.3)
    assert single._fields == stacked._fields
    for name in single._fields:
        a, b = getattr(single, name), getattr(stacked, name)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), name
    assert single.replicas == 1 and single.shape == (8, 8, 8) and single.num_cells == 512


def test_no_candidate_crosses_replicas_and_forces_are_per_replica():
    x, af, bf = _replica_beads(3)
    layout = pk.build_cell_layout(x, af, bf, 1.2, 0.3)
    n = x.shape[1]
    assert layout.shape == (26, 8, 8) and layout.replicas == 3 and layout.n == 3 * n
    # Bead ids r N + i, every replica's beads in their single order.
    assert torch.equal(layout.order // n, torch.sort(layout.order // n).values)
    crossing = 0
    for start, count in pk.stencil_ranges(layout):
        for i, j in pk.expand_ranges(start, count):
            crossing += int((layout.order[i] // n != layout.order[j] // n).sum())
    assert crossing == 0
    kparams = (2.5, 1 / 0.09, 2.5, 1 / 0.0576)
    forces, energy = pk.ab_pair_forces(layout, kparams, with_energy=True)
    forces = forces.reshape(x.shape)
    energies = 0.0
    for r in range(3):
        f, e = pk.ab_pair_forces(pk.build_cell_layout(x[r], af, bf, 1.2, 0.3), kparams, True)
        assert float(f.abs().max()) > 1.0
        np.testing.assert_allclose(forces[r].numpy(), f.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(f.abs().max()))
        energies += float(e)
    assert float(energy) == pytest.approx(energies, rel=1e-6)
    assert pk.candidate_pairs(layout) == sum(
        pk.candidate_pairs(pk.build_cell_layout(x[r], af, bf, 1.2, 0.3)) for r in range(3))


def test_stacked_grid_must_fit_32_bit_cell_ids():
    """Three cubes of 1000^3 cells side by side pass 2^31 cells: refused
    before anything is allocated."""
    x, af, bf = torch.zeros((3, 1, 3)), torch.ones(1), torch.zeros(1)
    with pytest.raises(ValueError, match="32-bit cell ids"):
        pk.build_cell_layout(x, af, bf, 150.0, 0.3)
    assert pk.grid_dims(150.0, 0.3) == 1000


def test_split_window_gives_each_replica_its_rows():
    coo = np.asarray([[0, 4, 1], [2, 3, 2], [5, 9, 1], [6, 7, 3], [10, 11, 1]], np.int32)
    windows = split_window(coo, 5, 3)
    np.testing.assert_array_equal(windows[0], [[0, 4, 1], [2, 3, 2]])
    np.testing.assert_array_equal(windows[1], [[0, 4, 1], [1, 2, 3]])
    np.testing.assert_array_equal(windows[2], [[0, 1, 1]])


# -- nothing couples the replicas ----------------------------------------------

def test_a_perturbed_replica_moves_nothing_in_the_other(warm):
    """Replica 0 gets a bead far outside its wall: its forces, displacement
    limit, wall reaction and contacts change; replica 1's stay as they were
    to the bit."""
    paths = warm[0]
    starts = []
    for path in paths:
        with SimulationStore(path) as store:
            cfg, design = store.load_config(), store.load_interphase_design()
            store.set_stage("relaxation")
            starts.append(store.load_positions(0).astype(np.float32))
    model = tinter.InterphaseModel.from_design(design, cfg, KERNEL_PATH, "cpu")
    c = cfg.interphase
    model.update_bound(3.5)
    perturbed = [starts[0].copy(), starts[1]]
    perturbed[0][7] = (3.2, 0.0, 0.0)

    def run(positions):
        state = convert.ensemble_state_from_numpy(
            positions, [c.wall_semiaxes_init] * 2, SEEDS, "cpu")
        for s in range(5):
            state = model.relaxation_step(state, s)
        relaxed = state[0].clone()
        for step in range(1, 6):
            state = model._bd_step4(state, step)
        events = model.contact_events_tick(state[0], 5)
        return relaxed, state[0], state[2], events

    base, moved = run(starts), run(perturbed)
    n = model.n
    assert not torch.equal(base[0][0], moved[0][0]) and not torch.equal(base[2][0], moved[2][0])
    # The displacement limit bit harder in replica 0: its far beads moved less.
    far = slice(100, None)
    shift = [np.linalg.norm(run[0][0].numpy()[far] - start[far], axis=1)
             for run, start in ((base, starts[0]), (moved, perturbed[0]))]
    assert np.median(shift[1]) < 0.5 * np.median(shift[0])
    assert torch.equal(base[0][1], moved[0][1])          # relaxation
    assert torch.equal(base[1][1], moved[1][1])          # G1
    assert torch.equal(base[2][1], moved[2][1])          # wall
    other = [events[events[:, 0] >= n] for events in (base[3], moved[3])]
    assert len(other[0]) > 100 and torch.equal(*other)
    for events in (base[3], moved[3]):
        assert torch.equal(events[:, 0] // n, events[:, 1] // n)


# -- the edges of run_ensemble_interphase and the CLI -------------------------

@pytest.mark.parametrize("change", ["beads", "factors"])
def test_stores_of_another_topology_are_refused(tmp_path, change):
    config_path, chains_path = write_inputs(tmp_path, 0.0)
    other_chains = chains_path
    if change == "beads":
        _, other_chains = write_inputs(tmp_path, 0.0, beads=280)
    else:
        text = open(chains_path).read().replace("\t1\t0\tA", "\t0.5\t0.5\tA", 1)
        (tmp_path / "other.tsv").write_text(text)
        other_chains = str(tmp_path / "other.tsv")
    stores = [MemoryStore(), MemoryStore()]
    run_prepare(stores[0], config_path, chains_path, seed=1, log=lambda m: None)
    run_prepare(stores[1], config_path, other_chains, seed=2, log=lambda m: None)
    with pytest.raises(ValueError, match="disagree on topology"):
        run_ensemble_interphase(stores, log=lambda m: None, device="cpu")
    assert run_ensemble_interphase([], device="cpu") is None


def test_ensemble_needs_a_card_unless_cpu_is_asked_for(warm):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with SimulationStore(warm[0][0], "r") as store:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_ensemble_interphase([store], log=lambda m: None)


def test_cli_ensemble_writes_a_file_per_replica(tmp_path):
    config_path, chains_path = write_inputs(tmp_path, 1.0)
    prefix = str(tmp_path / "run_")
    assert cli.main(["ensemble", "-n", "2", "--device", "cpu", "-s", "7", "-o", prefix,
                     config_path, chains_path]) == 0
    final, seeds = [], []
    for k in range(2):
        with SimulationStore(f"{prefix}rep_{k}.h5", "r") as store:
            assert store.load_config().interphase.steps == 80
            for stage, steps in (("anaphase", [0, 100, 200]), ("telophase", [0, 100]),
                                 *FRAMES.items()):
                store.set_stage(stage)
                assert store.load_steps() == steps, stage
            final.append(store.load_positions(80))
            assert store.load_contacts(80) is not None and store.load_checkpoint() is None
            seeds.append(store.load_interphase_design().seed)
    assert seeds[0] != seeds[1]
    assert np.isfinite(final).all() and np.abs(final[0] - final[1]).max() > 1e-2
