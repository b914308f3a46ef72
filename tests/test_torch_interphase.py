"""The interphase slice of the port against the JAX package.

One small design (a 300- and a 200-bead chain with an active NOR, so
nucleolar bonds and the droplet are live) is prepared by the port, gets a
telophase frame seeded with numpy (a random walk per coarse chain inside the
wall), and then goes through both packages, each reading the same file.  Temperature is 0, so both sides are deterministic and positions
can be compared; noise itself is covered by tests/test_torch_forces.py.

Tolerances: forces, reaction and energy rtol 1e-4 (float32 sums in another
order); positions after 200 G1 steps or 50 relaxation steps within 1e-4
(absolute, coordinates of order 1); the whole run's last frame within 1e-3.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_cycle_tpu.models import interphase as jinter
from genome_cycle_tpu.models.transitions import transition_interphase as j_transition
from genome_cycle_tpu.store import SimulationStore as JStore
from genome_cycle_tpu_torch import convert
from genome_cycle_tpu_torch.models import interphase as tinter
from genome_cycle_tpu_torch.models.prepare import run_prepare
from genome_cycle_tpu_torch.models.transitions import transition_interphase
from genome_cycle_tpu_torch.store import SimulationStore

# The suite runs in several worker processes at once: one thread each keeps
# torch from oversubscribing the cores (sizes here are tiny).
torch.set_num_threads(1)

CONFIG = {
    "mitotic_phase": {"coarse_graining": 10},
    "interphase": {
        "temperature": 0.0,
        "steps": 80, "sampling_interval": 20, "logging_interval": 20,
        "relaxation_steps": 40, "relaxation_sampling_interval": 20,
        "contactmap_update_interval": 20, "contactmap_output_window": 2,
        "a_core_2nd_bond_spring": 5.0, "b_core_2nd_bond_spring": 3.0,
    },
}
KERNEL_PATH = tinter.EngineSettings(brute_force_threshold=0)


def _seed_telophase(store, radius=1.5, step_length=0.3, seed=3):
    """Per coarse chain a random walk confined to a ball inside the wall (the
    port has no anaphase/telophase yet; both packages read this frame)."""
    rng = np.random.default_rng(seed)
    design = store.load_anatelophase_design()
    positions = np.zeros((design.particle_count, 3))
    for chain in design.chains:
        point = rng.normal(size=3) * 0.3
        for bead in range(chain.start, chain.end):
            positions[bead] = point
            while True:
                direction = rng.normal(size=3)
                trial = point + step_length * direction / np.linalg.norm(direction)
                if np.linalg.norm(trial) <= radius:
                    point = trial
                    break
    store.set_stage("telophase")
    store.save_positions(0, positions)
    store.append_frame(0)


def _write_inputs(tmp_path):
    config_path = tmp_path / "config.json"
    config_path.write_text(json.dumps(CONFIG))
    rows = ["chain\tstart\tend\tA\tB\ttags"]
    for name, nbeads, cen in [("chr1:a", 300, (140, 160)), ("chr2:a", 200, (90, 110))]:
        for i in range(nbeads):
            if cen[0] <= i < cen[1]:
                tag, a, b = "cen,B", 0, 1
            elif name == "chr1:a" and i < 2:
                tag, a, b = "anor,A", 1, 0
            elif i % 2 == 0:
                tag, a, b = "A", 1, 0
            else:
                tag, a, b = "B", 0, 1
            rows.append(f"{name}\t{i * 100000}\t{(i + 1) * 100000}\t{a}\t{b}\t{tag}")
    chains_path = tmp_path / "chains.tsv"
    chains_path.write_text("\n".join(rows) + "\n")
    return str(config_path), str(chains_path)


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Port-prepared file with telophase frames and the relaxation start."""
    tmp = tmp_path_factory.mktemp("torch_interphase")
    config_path, chains_path = _write_inputs(tmp)
    path = str(tmp / "cell.h5")
    run_prepare(path, config_path, chains_path, seed=42, log=lambda m: None)
    with SimulationStore(path) as store:
        _seed_telophase(store)
        transition_interphase(store, log=lambda m: None)
    return path, tmp


@pytest.fixture(scope="module")
def models(prepared):
    """The JAX model, the port's model converted from it, and the start."""
    path, _ = prepared
    with JStore(path) as store:
        jconfig = store.load_config()
        jmodel = jinter.InterphaseModel.from_design(
            store.load_interphase_design(), jconfig
        )
        store.set_stage("relaxation")
        x0 = store.load_positions(0).astype(np.float32)
    arrays = {
        f.name: np.asarray(getattr(jmodel, f.name))
        for f in dataclasses.fields(jmodel) if f.name in tinter.ARRAY_FIELDS
    }
    with SimulationStore(path) as store:
        config = store.load_config()
        design = store.load_interphase_design()
    tmodel = convert.interphase_model_from_numpy(arrays, config, KERNEL_PATH, "cpu")
    return jmodel, tmodel, x0, config, design


def test_transition_matches_jax(prepared):
    path, tmp = prepared
    copy = str(tmp / "transition.h5")
    shutil.copy(path, copy)
    with JStore(copy) as store:
        j_transition(store, log=lambda m: None)
        store.set_stage("relaxation")
        want = store.load_positions(0)
    with SimulationStore(path) as store:
        store.set_stage("relaxation")
        np.testing.assert_array_equal(store.load_positions(0), want)


def test_converted_model_equals_from_design(models):
    jmodel, tmodel, _, config, design = models
    direct = tinter.InterphaseModel.from_design(design, config, KERNEL_PATH, "cpu")
    assert set(tinter.ARRAY_FIELDS) <= {f.name for f in dataclasses.fields(jmodel)}
    for name in tinter.ARRAY_FIELDS:
        a, b = getattr(tmodel, name), getattr(direct, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jmodel, name)), err_msg=name)
    assert tmodel.n == direct.n == jmodel.n == 504
    assert tmodel.use_loops == direct.use_loops == jmodel.use_loops is True
    assert tmodel.use_droplet == direct.use_droplet == jmodel.use_droplet is True
    assert tmodel.nuc_bonds.shape == (4, 2)
    with pytest.raises(KeyError):
        convert.interphase_model_from_numpy({"af": np.zeros(3)}, config, None, "cpu")


@pytest.mark.parametrize("t", [0.0, 0.3, 2.0])
def test_scales_match_jax(models, t):
    jmodel, tmodel, *_ = models
    want = jmodel.scales(jnp.asarray(t, jnp.float32))
    got = tmodel.scales(t)
    np.testing.assert_allclose(got, [float(v) for v in want], rtol=1e-6)


@pytest.mark.parametrize("threshold", [0, 16384], ids=["cell-range", "brute"])
@pytest.mark.parametrize("core,bond", [(0.5, 0.5), (0.8, 0.9)])
def test_assemble_forces_match_jax(models, threshold, core, bond):
    jmodel, tmodel, x0, config, design = models
    model = tinter.InterphaseModel.from_design(
        design, config, tinter.EngineSettings(brute_force_threshold=threshold), "cpu"
    )
    semiaxes = np.asarray([1.2, 1.1, 1.0], np.float32)     # the wall presses
    fj, rj, ej, _, _ = jmodel._assemble_forces(
        jnp.asarray(x0), core, bond, jnp.asarray(semiaxes), with_energy=True
    )
    ft, rt, et = model._assemble_forces(
        torch.from_numpy(x0), core, bond, torch.from_numpy(semiaxes), with_energy=True
    )
    fj = np.asarray(fj)
    np.testing.assert_allclose(ft.numpy(), fj, rtol=1e-4, atol=1e-4 * np.abs(fj).max())
    assert np.abs(np.asarray(rj)).max() > 0
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-4)
    assert float(et) == pytest.approx(float(ej), rel=1e-4)
    assert float(model.total_energy(
        torch.from_numpy(x0), core, bond, torch.from_numpy(semiaxes)
    )) == pytest.approx(float(ej), rel=1e-4)
    # Without the energy pass the forces are the same and the pair energy is 0.
    f2, r2, _ = model._assemble_forces(
        torch.from_numpy(x0), core, bond, torch.from_numpy(semiaxes)
    )
    np.testing.assert_allclose(f2.numpy(), ft.numpy(), rtol=1e-6, atol=1e-5)


def test_bonded_forces_match_jax(models):
    """Chain bonds rescale K/s^2 and l*s; loops, nucleolar bonds and the
    droplet over its targets are live in this design."""
    jmodel, tmodel, x0, *_ = models
    for bond_scale in (0.5, 1.0):
        fj, ej = jmodel.bonded_forces(jnp.asarray(x0), bond_scale, with_energy=True)
        ft, et = tmodel.bonded_forces(torch.from_numpy(x0), bond_scale, with_energy=True)
        fj = np.asarray(fj)
        np.testing.assert_allclose(ft.numpy(), fj, rtol=1e-4, atol=1e-4 * np.abs(fj).max())
        assert float(et) == pytest.approx(float(ej), rel=1e-4)
    f_half, _ = tmodel.bonded_forces(torch.from_numpy(x0), 0.5)
    f_one, _ = tmodel.bonded_forces(torch.from_numpy(x0), 1.0)
    assert (f_half - f_one).abs().max() > 1e-3


def test_bd_step4_200_steps_match_jax(models):
    jmodel, tmodel, x0, config, _ = models
    semiaxes = np.asarray(config.interphase.wall_semiaxes_init, np.float32)
    zero = jnp.zeros((), jnp.int32)
    carry = (jnp.asarray(x0), jax.random.PRNGKey(0), jnp.asarray(semiaxes), (zero, zero))
    run = jax.jit(lambda c: jax.lax.scan(
        lambda cr, s: (jmodel._bd_step4(cr, s), None), c, 1 + jnp.arange(200)
    )[0])
    xj, _, aj, _ = run(carry)

    state = convert.state_from_numpy(x0, semiaxes, seed=0, device="cpu")
    for step in range(1, 201):
        state = tmodel._bd_step4(state, step)
    xt, generator, at = state
    assert np.abs(np.asarray(xj) - x0).max() > 1e-3          # it moved
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6)
    assert (at.numpy() < semiaxes).all()                     # the wall ODE ran
    assert isinstance(generator, torch.Generator)


def test_relaxation_50_steps_match_jax(models):
    jmodel, tmodel, x0, config, _ = models
    semiaxes = np.asarray(config.interphase.wall_semiaxes_init, np.float32)
    zero = jnp.zeros((), jnp.int32)
    carry = (jnp.asarray(x0), jax.random.PRNGKey(0), jnp.asarray(semiaxes), (zero, zero))
    run = jax.jit(lambda c: jax.lax.scan(
        lambda cr, s: (jmodel.relaxation_step(cr, s), None), c, jnp.arange(50)
    )[0])
    xj, _, aj, _ = run(carry)
    state = convert.state_from_numpy(x0, semiaxes, device="cpu")
    for step in range(50):
        state = tmodel.relaxation_step(state, step)
    np.testing.assert_allclose(state[0].numpy(), np.asarray(xj), atol=1e-4)
    np.testing.assert_array_equal(state[2].numpy(), semiaxes)  # frozen wall
    # Displacement-limited: no bead moves more than spacestep a step.
    moved = np.linalg.norm(state[0].numpy() - x0, axis=1).max()
    assert 0 < moved <= 50 * config.interphase.relaxation_spacestep * (1 + 1e-4)


def test_step_uses_lagged_scales_and_tick_uses_current(models, monkeypatch):
    """Forces at step s use the scales at (s-1) dt; the tick at step s uses
    the post-update positions and the core scale at s dt."""
    _, tmodel, x0, config, _ = models
    c = config.interphase
    asked = []
    real_scales = tmodel.scales
    monkeypatch.setattr(tmodel, "scales", lambda t: asked.append(t) or real_scales(t))
    state = convert.state_from_numpy(x0, c.wall_semiaxes_init, device="cpu")
    new_state = tmodel._bd_step4(state, 7)
    assert asked == [pytest.approx(6 * c.timestep)]

    seen = {}

    def spy(layout, cutoff):
        seen["cutoff"], seen["xyz"] = cutoff, layout.xyz[:, :3][torch.argsort(layout.order)]
        return torch.zeros((0, 3), dtype=torch.int32)

    monkeypatch.setattr(tinter, "contact_events", spy)
    asked.clear()
    tmodel.contact_events_tick(new_state[0], 7)
    assert asked == [pytest.approx(7 * c.timestep)]
    assert seen["cutoff"] == pytest.approx(c.contactmap_distance * real_scales(7 * c.timestep)[0])
    assert torch.equal(seen["xyz"], new_state[0])


# -- the slice as a whole -----------------------------------------------------

@pytest.fixture(scope="module")
def runs(prepared):
    """run_interphase of both packages on copies of the same store."""
    path, tmp = prepared
    port_path, jax_path = str(tmp / "port.h5"), str(tmp / "jax.h5")
    shutil.copy(path, port_path)
    shutil.copy(path, jax_path)
    port_log, saved = [], []
    with SimulationStore(port_path) as store:
        real_save = store.save_checkpoint
        store.save_checkpoint = lambda step, arrays: (
            saved.append((step, {k: np.array(v) for k, v in arrays.items()})),
            real_save(step, arrays),
        )
        timings = {}
        final = tinter.run_interphase(
            store, settings=KERNEL_PATH, log=port_log.append, device="cpu",
            timings=timings,
        )
    with JStore(jax_path) as store:
        jinter.run_interphase(store, log=lambda m: None)
    return port_path, jax_path, port_log, saved, final, timings


def test_run_interphase_frames_and_contexts_match_jax(runs):
    port_path, jax_path, port_log, _, final, timings = runs
    c = CONFIG["interphase"]
    with SimulationStore(port_path) as ps, JStore(jax_path) as js:
        for stage, last in (("relaxation", 40), ("interphase", 80)):
            ps.set_stage(stage)
            js.set_stage(stage)
            assert ps.load_steps() == js.load_steps() == list(range(0, last + 1, 20))
            for step in ps.load_steps():
                pc, jc = ps.load_interphase_context(step), js.load_interphase_context(step)
                assert dataclasses.asdict(pc).keys() == dataclasses.asdict(jc).keys()
                assert pc.time == pytest.approx(jc.time)
                assert pc.core_scale == pytest.approx(jc.core_scale, rel=1e-6)
                assert pc.bond_scale == pytest.approx(jc.bond_scale, rel=1e-6)
                assert pc.wall_semiaxes == pytest.approx(jc.wall_semiaxes, rel=1e-5)
                assert pc.mean_energy == pytest.approx(jc.mean_energy, rel=1e-3)
                np.testing.assert_allclose(
                    ps.load_positions(step), js.load_positions(step), atol=1e-3
                )
        # The logged context holds post-step values: the scales at step * dt.
        ctx = ps.load_interphase_context(60)
        t = 60 * 1e-5
        assert ctx.time == pytest.approx(t)
        assert ctx.core_scale == pytest.approx(1 - 0.5 * np.exp(-t / 0.5), rel=1e-9)
        # Step 0: the frame holds the initial wall; its reaction-free first
        # update shows only afterwards.
        assert ps.load_interphase_context(0).wall_semiaxes == (2.0, 2.0, 2.0)
        assert ps.load_interphase_context(20).wall_semiaxes != (2.0, 2.0, 2.0)
        np.testing.assert_allclose(final, ps.load_positions(80), atol=1e-4)
        assert ps.load_checkpoint() is None                   # cleared at the end
    assert timings["g1_steps"] == c["steps"] and timings["relaxation_steps"] == 40
    assert timings["g1_seconds"] > 0
    assert sum("[relaxation]" in line for line in port_log) == 3
    assert sum("[interphase]" in line and "steps/s" in line for line in port_log) == 4


def test_run_interphase_contact_windows_match_jax(runs):
    port_path, jax_path, *_ = runs
    with SimulationStore(port_path) as ps, JStore(jax_path) as js:
        ps.set_stage("interphase")
        js.set_stage("interphase")
        # Step 0: one search, dumped at once -> every count is 1.
        c0 = ps.load_contacts(0)
        assert (c0[:, 2] == 1).all() and len(c0) > 100
        np.testing.assert_array_equal(c0, js.load_contacts(0))
        assert ps.load_contacts(20) is None and ps.load_contacts(60) is None
        for step in (40, 80):
            pw, jw = ps.load_contacts(step), js.load_contacts(step)
            assert pw.dtype == np.int32 and (pw[:, 0] < pw[:, 1]).all()
            key = (pw[:, 0].astype(np.int64) << 32) | pw[:, 1]
            assert (np.diff(key) > 0).all() and pw[:, 2].max() == 2   # two ticks a window
            # Pairs at the cutoff's edge may differ between two float32 runs.
            a, b = set(map(tuple, pw.tolist())), set(map(tuple, jw.tolist()))
            assert len(a ^ b) <= 0.01 * len(a)


def test_checkpoint_holds_positions_semiaxes_and_generator_state(runs):
    port_path, _, _, saved, _, _ = runs
    assert [step for step, _ in saved] == [40, 80]            # window boundaries
    step, arrays = saved[0]
    assert set(arrays) == {"positions", "semiaxes", "key"}
    assert arrays["positions"].shape == (504, 3) and arrays["semiaxes"].shape == (3,)
    assert arrays["key"].dtype == np.uint8
    torch.Generator().set_state(torch.from_numpy(arrays["key"]))   # a real state
    with SimulationStore(port_path) as store:
        store.set_stage("interphase")
        np.testing.assert_allclose(arrays["positions"], store.load_positions(40), atol=1e-4)


def test_interphase_checkpoint_resume(runs, tmp_path):
    """Kill-and-resume, as tests/test_pipeline.py does for the JAX package."""
    port_path, _, _, saved, _, _ = runs
    copy = str(tmp_path / "resume.h5")
    shutil.copy(port_path, copy)
    with SimulationStore(copy) as store:
        store.set_stage("interphase")
        reference = store.load_positions(80)
        store.save_checkpoint(40, saved[0][1])
        store.truncate_frames(40)
        assert store.load_steps() == [0, 20, 40]
        logs = []
        tinter.run_interphase(store, settings=KERNEL_PATH, log=logs.append, device="cpu")
        assert any("resuming interphase from checkpoint at step 40" in l for l in logs)
        store.set_stage("interphase")
        assert store.load_steps() == [0, 20, 40, 60, 80]
        # Temperature 0: the resumed run retraces the first one.
        np.testing.assert_allclose(store.load_positions(80), reference, atol=1e-4)
        assert store.load_contacts(80) is not None
        assert store.load_checkpoint() is None


def test_run_interphase_needs_a_card_unless_cpu_is_asked_for(prepared):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    path, _ = prepared
    with SimulationStore(path, "r") as store:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tinter.run_interphase(store, log=lambda m: None)
