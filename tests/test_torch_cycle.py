"""The whole cell cycle of the port, through its CLI, against the JAX package.

``simulate``, then ``transition prometaphase`` and ``prometaphase``, then
``cycles -n 2``, all with ``--device cpu`` on HDF5 files, and the same stages
through the library on a ``MemoryStore``.  The JAX package reads the files
back and runs the same cycle from the same prepared file.  Temperature is 0 in
every stage, so both packages are deterministic and positions compare.  The
spindle is shrunk and the packing spring raised so that a few hundred steps
bring the rods inside the interphase wall (an unrelaxed structure far outside
it amplifies float32 rounding from step to step).

Tolerances: transitions are numpy on both sides, equal arrays; stage frames
of the two packages within 1e-3 absolute up to the end of G1 and 2e-3 for the
prometaphase that follows (float32 sums in another order, carried through
1,420 steps); stored positions are quantised to 16 mantissa bits, so a frame
read back agrees with what was computed to 2e-5 relative.
"""

import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from genome_cycle_tpu.models.anatelophase import run_anatelophase as j_anatelophase
from genome_cycle_tpu.models.interphase import run_interphase as j_interphase
from genome_cycle_tpu.models.prometaphase import run_prometaphase as j_prometaphase
from genome_cycle_tpu.models import transitions as jtransitions
from genome_cycle_tpu.store import SimulationStore as JStore
from genome_cycle_tpu_torch import cli
from genome_cycle_tpu_torch.models import transitions
from genome_cycle_tpu_torch.models.anatelophase import AnatelophaseModel, run_anatelophase
from genome_cycle_tpu_torch.models.interphase import run_interphase
from genome_cycle_tpu_torch.models.prepare import run_prepare
from genome_cycle_tpu_torch.models.prometaphase import run_prometaphase
from genome_cycle_tpu_torch.store import MemoryStore, SimulationStore

from test_torch_mitotic import write_inputs

torch.set_num_threads(1)

SPINDLE_AXIS = [0.0, 1.0, 0.0]
CONFIG = {
    "mitotic_phase": {
        "coarse_graining": 10, "temperature": 0.0,
        "anaphase_steps": 300, "telophase_steps": 400, "prometaphase_steps": 300,
        "sampling_interval": 100, "logging_interval": 100,
        "spindle_axis": SPINDLE_AXIS, "anaphase_spindle_shift": [0.0, 0.4, 0.0],
        "anaphase_start_stddev": 0.3, "telophase_packing_spring": 1000.0,
        "kfiber_decay_rate_anaphase": 10.0, "kfiber_decay_rate_prometaphase": 10.0,
    },
    "interphase": {
        "temperature": 0.0,
        "steps": 80, "sampling_interval": 20, "logging_interval": 20,
        "relaxation_steps": 40, "relaxation_sampling_interval": 20,
        "contactmap_update_interval": 20, "contactmap_output_window": 2,
    },
}
SEED = 42
STAGE_FRAMES = {
    "anaphase": [0, 100, 200, 300],
    "telophase": [0, 100, 200, 300, 400],
    "relaxation": [0, 20, 40],
    "interphase": [0, 20, 40, 60, 80],
    "prometaphase": [0, 100, 200, 300],
}
QUIET = lambda m: None


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cycle")
    return tmp, *write_inputs(tmp, CONFIG)


@pytest.fixture(scope="module")
def simulated(inputs):
    """``simulate`` then the prometaphase, through the port's CLI."""
    tmp, config_path, chains_path = inputs
    path = str(tmp / "sim.h5")
    base = ["--device", "cpu"]
    assert cli.main(["simulate", *base, "-s", str(SEED), "-o", path,
                     config_path, chains_path]) == 0
    after_simulate = str(tmp / "after_simulate.h5")
    shutil.copy(path, after_simulate)
    assert cli.main(["transition", "prometaphase", path]) == 0
    assert cli.main(["prometaphase", *base, path]) == 0
    return path, after_simulate


@pytest.fixture(scope="module")
def cycles(inputs):
    """``cycles -n 2`` through the port's CLI."""
    tmp, config_path, chains_path = inputs
    prefix = str(tmp / "run_")
    assert cli.main(["cycles", "-n", "2", "--device", "cpu", "-s", str(SEED),
                     "-o", prefix, config_path, chains_path]) == 0
    return prefix + "cell_0.h5", prefix + "cell_1.h5"


@pytest.fixture(scope="module")
def jax_cycle(inputs):
    """The JAX package's cycle 0 from a file the port prepared."""
    tmp, config_path, chains_path = inputs
    path = str(tmp / "jax.h5")
    assert cli.main(["prepare", "-s", str(SEED), "-o", path, config_path, chains_path]) == 0
    with JStore(path) as store:
        j_anatelophase(store, log=QUIET)
        jtransitions.transition_interphase(store, log=QUIET)
        j_interphase(store, log=QUIET)
        jtransitions.transition_prometaphase(store, log=QUIET)
        j_prometaphase(store, log=QUIET)
    return path


def _frames(store, stage):
    store.set_stage(stage)
    return {step: store.load_positions(step) for step in store.load_steps()}


def _target_chromatids(prev, next_design):
    """What ``transition cycle`` hands over: for each chromosome the target
    chromatid of ``prev``'s last prometaphase frame, shifted by -spindle_axis."""
    design = prev.load_prometaphase_design()
    prev.set_stage("prometaphase")
    last = prev.load_positions(prev.load_steps()[-1])
    want = np.zeros((next_design.particle_count, 3))
    for k, chain in enumerate(next_design.chains):
        target = design.chains[int(design.sister_chromatids[k][0])]
        want[chain.start:chain.end] = last[target.start:target.end] - SPINDLE_AXIS
    return want


# -- the files ---------------------------------------------------------------

def test_simulate_writes_the_four_stages_and_no_prometaphase(simulated):
    _, after_simulate = simulated
    with JStore(after_simulate, "r") as store:
        for stage in ("anaphase", "telophase", "relaxation", "interphase"):
            store.set_stage(stage)
            assert store.load_steps() == STAGE_FRAMES[stage], stage
        store.set_stage("prometaphase")
        assert store.load_steps() == [] and not store.check_positions(0)


@pytest.mark.parametrize("stage", list(STAGE_FRAMES))
def test_stage_frames_read_back_by_the_jax_store(simulated, stage):
    path, _ = simulated
    sizes = {"anaphase": 50, "telophase": 50, "relaxation": 504, "interphase": 504,
             "prometaphase": 100}
    with JStore(path, "r") as js, SimulationStore(path, "r") as ps:
        frames, own = _frames(js, stage), _frames(ps, stage)
        assert list(frames) == list(own) == STAGE_FRAMES[stage]
        for step, x in frames.items():
            assert x.shape == (sizes[stage], 3) and np.isfinite(x).all()
            np.testing.assert_array_equal(x, own[step])
        if stage in ("relaxation", "interphase"):
            ctx = js.load_interphase_context(STAGE_FRAMES[stage][-1])
            assert np.isfinite(ctx.mean_energy) and len(ctx.wall_semiaxes) == 3
        if stage == "interphase":
            assert len(js.load_contacts(0)) > 0 and len(js.load_contacts(40)) > 0
        # Every stage moves its beads.
        steps = STAGE_FRAMES[stage]
        assert np.abs(frames[steps[-1]] - frames[steps[0]]).max() > 1e-3


def test_cycles_first_cell_equals_simulate_plus_prometaphase(simulated, cycles):
    """Same seed, temperature 0: ``cycles`` composes the same stages."""
    path, _ = simulated
    with SimulationStore(path, "r") as a, SimulationStore(cycles[0], "r") as b:
        assert a.load_master_seed() == b.load_master_seed() == SEED
        for stage, steps in STAGE_FRAMES.items():
            fa, fb = _frames(a, stage), _frames(b, stage)
            assert list(fa) == list(fb) == steps
            np.testing.assert_allclose(fa[steps[-1]], fb[steps[-1]], rtol=0, atol=1e-6)


def test_cycles_seeds_each_cell_and_writes_every_stage(cycles):
    for k, path in enumerate(cycles):
        with JStore(path, "r") as store:
            assert store.load_master_seed() == SEED + k
            for stage, steps in STAGE_FRAMES.items():
                store.set_stage(stage)
                assert store.load_steps() == steps, (k, stage)
                assert np.isfinite(store.load_positions(steps[-1])).all()


def test_cycle_1_starts_from_the_hand_off_and_not_from_rods(cycles):
    with SimulationStore(cycles[0], "r") as prev, SimulationStore(cycles[1], "r") as nxt:
        design = nxt.load_anatelophase_design()
        want = _target_chromatids(prev, design)
        nxt.set_stage("anaphase")
        got = nxt.load_positions(0)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        model = AnatelophaseModel.from_design(design, nxt.load_config(), "cpu")
        rods = model.initial_rods(np.random.default_rng(design.seed), design.chains)
        assert np.abs(got - rods).max() > 0.1
        # The anaphase went on from there.
        assert 1e-3 < np.abs(nxt.load_positions(100) - got).max() < 3.0


# -- transitions -----------------------------------------------------------------

def test_transition_prometaphase_equals_jax(simulated, tmp_path):
    path, after_simulate = simulated
    copy = str(tmp_path / "transition.h5")
    shutil.copy(after_simulate, copy)
    with JStore(copy) as store:
        jtransitions.transition_prometaphase(store, log=QUIET)
        store.set_stage("prometaphase")
        want = store.load_positions(0)
    with SimulationStore(path, "r") as store:
        design = store.load_prometaphase_design()
        store.set_stage("prometaphase")
        got = store.load_positions(0)
    np.testing.assert_array_equal(got, want)
    # Sisters lie one separation along -spindle_axis from their targets.
    target, sister = (design.chains[int(k)] for k in design.sister_chromatids[0])
    np.testing.assert_allclose(
        got[sister.start:sister.end] - got[target.start:target.end],
        np.broadcast_to([0.0, -0.3, 0.0], (target.end - target.start, 3)),
        atol=1e-4,
    )


def test_transition_cycle_equals_jax(simulated, inputs, tmp_path):
    path, _ = simulated
    _, config_path, chains_path = inputs
    nexts = [str(tmp_path / name) for name in ("next_port.h5", "next_jax.h5")]
    for target in nexts:
        run_prepare(target, config_path, chains_path, seed=SEED + 1, log=QUIET)
    assert cli.main(["transition", "cycle", path, nexts[0]]) == 0
    with JStore(path, "r") as prev, JStore(nexts[1]) as nxt:
        jtransitions.transition_cycle(prev, nxt, log=QUIET)
        nxt.set_stage("anaphase")
        want = nxt.load_positions(0)
    with SimulationStore(path, "r") as prev, SimulationStore(nexts[0], "r") as nxt:
        nxt.set_stage("anaphase")
        got = nxt.load_positions(0)
        assert nxt.load_steps() == []          # a start structure, not a frame
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(
            got, _target_chromatids(prev, nxt.load_anatelophase_design()),
            rtol=2e-5, atol=2e-5,
        )


def test_transitions_refuse_a_store_without_frames(inputs, tmp_path):
    _, config_path, chains_path = inputs
    empty, other = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    for target in (empty, other):
        run_prepare(target, config_path, chains_path, seed=1, log=QUIET)
    with SimulationStore(empty) as store, SimulationStore(other) as nxt:
        with pytest.raises(RuntimeError, match="no interphase frames"):
            transitions.transition_prometaphase(store, log=QUIET)
        with pytest.raises(RuntimeError, match="no prometaphase frames"):
            transitions.transition_cycle(store, nxt, log=QUIET)
        with pytest.raises(RuntimeError, match="no initial structure"):
            run_prometaphase(store, log=QUIET, device="cpu")


# -- against the JAX package's cycle ------------------------------------------

@pytest.mark.parametrize("stage,atol", [
    ("anaphase", 1e-3), ("telophase", 1e-3), ("relaxation", 1e-3),
    ("interphase", 1e-3), ("prometaphase", 2e-3),
])
def test_cycle_at_temperature_0_matches_the_jax_pipeline(simulated, jax_cycle, stage, atol):
    path, _ = simulated
    with SimulationStore(path, "r") as ps, JStore(jax_cycle, "r") as js:
        got, want = _frames(ps, stage), _frames(js, stage)
        assert list(got) == list(want) == STAGE_FRAMES[stage]
        for step in got:
            np.testing.assert_allclose(got[step], want[step], rtol=0, atol=atol,
                                       err_msg=f"{stage} step {step}")


# -- the library on a MemoryStore ---------------------------------------------

def test_cycle_on_memory_stores_matches_the_files(inputs, cycles):
    _, config_path, chains_path = inputs
    stores, logs = [MemoryStore(), MemoryStore()], []
    for k, store in enumerate(stores):
        run_prepare(store, config_path, chains_path, seed=SEED + k, log=QUIET)
        if k:
            transitions.transition_cycle(stores[0], store, log=QUIET)
        timings = {}
        run_anatelophase(store, log=logs.append, device="cpu", timings=timings)
        transitions.transition_interphase(store, log=QUIET)
        run_interphase(store, log=QUIET, device="cpu")
        transitions.transition_prometaphase(store, log=QUIET)
        final = run_prometaphase(store, log=logs.append, device="cpu", timings=timings)
        assert timings["anaphase_steps"] == 300 and timings["telophase_steps"] == 400
        assert timings["prometaphase_steps"] == 300 and timings["prometaphase_seconds"] > 0
        with SimulationStore(cycles[k], "r") as on_file:
            for stage, steps in STAGE_FRAMES.items():
                fm, ff = _frames(store, stage), _frames(on_file, stage)
                assert list(fm) == list(ff) == steps
                np.testing.assert_allclose(fm[steps[-1]], ff[steps[-1]], rtol=0, atol=1e-6)
        np.testing.assert_allclose(final, _frames(store, "prometaphase")[300],
                                   rtol=2e-5, atol=2e-5)
    # Progress lines: step 0 and every logging interval, then "Finished.".
    assert sum(line.startswith("[anaphase]") for line in logs) == 2 * 4
    assert sum(line.startswith("[telophase]") for line in logs) == 2 * 5
    assert sum(line.startswith("[prometaphase]") for line in logs) == 2 * 4
    assert logs.count("Finished.") == 2
    assert all("E: " in line for line in logs if line.startswith("["))


def test_anatelophase_refuses_a_start_of_the_wrong_size(inputs):
    _, config_path, chains_path = inputs
    store = MemoryStore()
    run_prepare(store, config_path, chains_path, seed=1, log=QUIET)
    store.set_stage("anaphase")
    store.save_positions(0, np.zeros((7, 3)))
    with pytest.raises(ValueError, match="size mismatch"):
        run_anatelophase(store, log=QUIET, device="cpu")


# -- the command line ------------------------------------------------------------

def test_stages_need_a_card_unless_cpu_is_asked_for(inputs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    _, config_path, chains_path = inputs
    path = str(tmp_path / "cell.h5")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["simulate", "-o", path, config_path, chains_path])
    for command in (["anatelophase", path], ["prometaphase", path],
                    ["cycles", "-n", "1", "-o", str(tmp_path / "c_"), config_path, chains_path]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(command)


def test_module_entry_point_runs_a_stage_on_the_cpu(inputs, tmp_path):
    _, config_path, chains_path = inputs
    path = str(tmp_path / "cell.h5")
    config = json.loads(open(config_path).read())
    config["mitotic_phase"].update(anaphase_steps=100, telophase_steps=100)
    short = tmp_path / "short.json"
    short.write_text(json.dumps(config))
    for command in (["prepare", "-s", "3", "-o", path, str(short), chains_path],
                    ["anatelophase", "--device", "cpu", path]):
        proc = subprocess.run(
            [sys.executable, "-m", "genome_cycle_tpu_torch.cli", *command],
            capture_output=True, text=True,
            cwd=pathlib.Path(__file__).resolve().parent.parent,
        )
        assert proc.returncode == 0, proc.stderr
    assert "[telophase]" in proc.stderr and "Finished." in proc.stderr
    with JStore(path, "r") as store:
        store.set_stage("telophase")
        assert store.load_steps() == [0, 100]
