"""The mitotic stage models of the port against the JAX package.

One small design (a 300- and a 200-bead chain, coarse-grained by 10 into
chains of 30 and 20 beads with triples on both sides of each kinetochore) is
prepared by the port into a file that both packages read.  Positions come
from the design's own rods and from numpy with a seed.

Tolerances (float32 on both sides, sums in another order): model arrays
equal; forces within 1e-4 of max|F|, energies rtol 1e-4; 200 steps of a phase
at temperature 0 within 1e-4 absolute (coordinates of order 1 to 10); one
step with handed-in noise within 1e-5.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_cycle_tpu.models import anatelophase as jana
from genome_cycle_tpu.models import prometaphase as jpro
from genome_cycle_tpu.store import SimulationStore as JStore
from genome_cycle_tpu_torch import convert
from genome_cycle_tpu_torch.models import anatelophase as tana
from genome_cycle_tpu_torch.models import prometaphase as tpro
from genome_cycle_tpu_torch.models.prepare import run_prepare
from genome_cycle_tpu_torch.store import SimulationStore

# The suite runs in several worker processes at once: one thread each keeps
# torch from oversubscribing the cores (sizes here are tiny).
torch.set_num_threads(1)

CONFIG = {"mitotic_phase": {
    "coarse_graining": 10, "temperature": 0.0,
    "telophase_bond_spring_multiplier": 0.5,
    "telophase_bending_energy_multiplier": 2.0,
    "kfiber_length_anaphase": 0.2, "kfiber_length_prometaphase": 0.1,
}}
EJECTION = {"polar_ejection_force": 40.0, "polar_ejection_cross_section": 0.5}
FORCE_TOLERANCE = 1e-4
STEPS = 200


def write_inputs(tmp_path, config):
    config_path = tmp_path / "config.json"
    config_path.write_text(json.dumps(config))
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
def designs(tmp_path_factory):
    """Config and the two mitotic designs, as each package loads them."""
    tmp = tmp_path_factory.mktemp("torch_mitotic")
    config_path, chains_path = write_inputs(tmp, CONFIG)
    path = str(tmp / "cell.h5")
    run_prepare(path, config_path, chains_path, seed=42, log=lambda m: None)
    with JStore(path) as store:
        j = (store.load_config(), store.load_anatelophase_design(),
             store.load_prometaphase_design())
    with SimulationStore(path) as store:
        t = (store.load_config(), store.load_anatelophase_design(),
             store.load_prometaphase_design())
    return j, t


def _with(config, **fields):
    return dataclasses.replace(
        config, mitotic_phase=dataclasses.replace(config.mitotic_phase, **fields)
    )


def _arrays(jmodel, fields):
    return {
        f.name: np.asarray(getattr(jmodel, f.name))
        for f in dataclasses.fields(jmodel) if f.name in fields
    }


def _ana_models(designs, **fields):
    (jconfig, jdesign, _), (tconfig, tdesign, _) = designs
    jmodel = jana.AnatelophaseModel.from_design(jdesign, _with(jconfig, **fields))
    tmodel = tana.AnatelophaseModel.from_design(tdesign, _with(tconfig, **fields), "cpu")
    return jmodel, tmodel


def _pro_models(designs, **fields):
    (jconfig, _, jdesign), (tconfig, _, tdesign) = designs
    jmodel = jpro.PrometaphaseModel.from_design(jdesign, _with(jconfig, **fields))
    tmodel = tpro.PrometaphaseModel.from_design(tdesign, _with(tconfig, **fields), "cpu")
    return jmodel, tmodel


def _rods(designs):
    _, (_, tdesign, _) = designs
    _, tmodel = _ana_models(designs)
    return tmodel.initial_rods(np.random.default_rng(7), tdesign.chains).astype(np.float32)


def _ball(n, radius, seed):
    """A compact start inside ``radius``: a confined walk of 0.3 steps."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, 3))
    point = np.zeros(3)
    for bead in range(n):
        x[bead] = point
        while True:
            d = rng.normal(size=3)
            trial = point + 0.3 * d / np.linalg.norm(d)
            if np.linalg.norm(trial) <= radius:
                point = trial
                break
    return x.astype(np.float32)


def _metaphase_start(designs, seed=5):
    """Target chromatids as a confined walk, sisters displaced along -y."""
    _, (tconfig, _, tdesign) = designs
    x = np.zeros((tdesign.particle_count, 3), np.float32)
    for target, sister in tdesign.sister_chromatids:
        t, s = tdesign.chains[target], tdesign.chains[sister]
        x[t.start:t.end] = _ball(t.end - t.start, 2.0, seed + target)
        x[s.start:s.end] = x[t.start:t.end] - np.asarray([0.0, 0.3, 0.0], np.float32)
    return x


# -- construction --------------------------------------------------------------

def test_anatelophase_model_arrays_equal_jax(designs):
    jmodel, tmodel = _ana_models(designs)
    (_, _, _), (tconfig, _, _) = designs
    converted = convert.anatelophase_model_from_numpy(
        _arrays(jmodel, tana.ARRAY_FIELDS), tconfig, "cpu"
    )
    assert set(tana.ARRAY_FIELDS) <= {f.name for f in dataclasses.fields(jmodel)}
    for name in tana.ARRAY_FIELDS:
        want = np.asarray(getattr(jmodel, name))
        for model in (tmodel, converted):
            got = getattr(model, name)
            assert got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert tmodel.n == converted.n == jmodel.n == 50
    # Kinetochores at coarse beads 15 of 30 and 10 of 20; no triple crosses one.
    assert tmodel.kinetochores.tolist() == [15, 40]
    assert len(tmodel.triples) == (15 - 2) + (14 - 2) + (10 - 2) + (9 - 2)
    with pytest.raises(KeyError):
        convert.anatelophase_model_from_numpy({"mobility": np.zeros(3)}, tconfig, "cpu")


def test_prometaphase_model_arrays_equal_jax(designs):
    jmodel, tmodel = _pro_models(designs)
    (_, _, _), (tconfig, _, _) = designs
    converted = convert.prometaphase_model_from_numpy(
        _arrays(jmodel, tpro.ARRAY_FIELDS), tconfig, "cpu"
    )
    assert set(tpro.ARRAY_FIELDS) <= {f.name for f in dataclasses.fields(jmodel)}
    for name in tpro.ARRAY_FIELDS:
        want = np.asarray(getattr(jmodel, name))
        for model in (tmodel, converted):
            np.testing.assert_array_equal(getattr(model, name).numpy(), want, err_msg=name)
    assert tmodel.n == converted.n == jmodel.n == 100
    assert tmodel.sister_pairs.shape == (2, 2)
    # Both fiber fields as one: targets first, then sisters, each with its pole.
    assert tmodel.kfiber_kinetochores.tolist() == (
        tmodel.target_kinetochores.tolist() + tmodel.sister_kinetochores.tolist()
    )
    assert torch.equal(tmodel.kfiber_poles[0], tmodel.target_pole)
    assert torch.equal(tmodel.kfiber_poles[-1], tmodel.sister_pole)


def test_models_leave_out_chains_without_kinetochore(designs):
    """A chain shorter than the coarse-graining window has no kinetochore: no
    dragging, no cohesion, no fiber; its bonds and triples stay."""
    _, (tconfig, ana_design, pro_design) = designs
    ana_design = dataclasses.replace(ana_design, chains=[
        dataclasses.replace(c, kinetochore=None) if k == 1 else c
        for k, c in enumerate(ana_design.chains)
    ])
    bare = {int(pro_design.sister_chromatids[1][1])}
    pro_design = dataclasses.replace(pro_design, chains=[
        dataclasses.replace(c, kinetochore=None) if k in bare else c
        for k, c in enumerate(pro_design.chains)
    ])
    ana = tana.AnatelophaseModel.from_design(ana_design, tconfig, "cpu")
    pro = tpro.PrometaphaseModel.from_design(pro_design, tconfig, "cpu")
    assert ana.kinetochores.tolist() == [15] and ana.kfiber_springs.shape == (1,)
    assert len(ana.triples) == (15 - 2) + (14 - 2) + (20 - 2)
    assert pro.sister_pairs.shape == (1, 2) and pro.kfiber_kinetochores.shape == (2,)


def test_default_device_is_the_card_or_an_error(designs):
    _, (tconfig, ana_design, _) = designs
    if torch.cuda.is_available():
        assert tana.AnatelophaseModel.from_design(ana_design, tconfig).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tana.AnatelophaseModel.from_design(ana_design, tconfig)


def test_initial_rods_bitwise_equal(designs):
    (_, jdesign, _), (_, tdesign, _) = designs
    jmodel, tmodel = _ana_models(designs)
    want = jmodel.initial_rods(np.random.default_rng(jdesign.seed), jdesign.chains)
    got = tmodel.initial_rods(np.random.default_rng(tdesign.seed), tdesign.chains)
    assert got.dtype == want.dtype and got.shape == (50, 3)
    assert np.array_equal(got, want)
    # Rods start around -spindle_axis.
    assert np.abs(got.mean(axis=0) - [0, -5, 0]).max() < 2.0


# -- forces ---------------------------------------------------------------------

def _assert_forces_match(got, want):
    (f, e), (f_j, e_j) = got, want
    f, f_j = f.numpy(), np.asarray(f_j)
    fmax = float(np.abs(f_j).max())
    assert fmax > 1.0
    assert np.abs(f - f_j).max() <= FORCE_TOLERANCE * fmax
    assert float(e) == pytest.approx(float(e_j), rel=1e-4)


@pytest.mark.parametrize("telophase", [False, True])
@pytest.mark.parametrize("start", ["rods", "ball"])
def test_anatelophase_forces_match_jax(designs, telophase, start):
    jmodel, tmodel = _ana_models(designs)
    x = _rods(designs) if start == "rods" else _ball(50, 1.2, seed=3) * 1.5
    got = tmodel.forces(torch.as_tensor(x), telophase, with_energy=True)
    _assert_forces_match(got, jmodel.forces(jnp.asarray(x), telophase, with_energy=True))
    f_only, e_zero = tmodel.forces(torch.as_tensor(x), telophase)
    assert torch.equal(f_only, got[0]) and float(e_zero) == 0.0


@pytest.mark.parametrize("ejection", [{}, EJECTION], ids=["no ejection", "ejection"])
def test_prometaphase_forces_match_jax(designs, ejection):
    jmodel, tmodel = _pro_models(designs, **ejection)
    x = _metaphase_start(designs)
    got = tmodel.forces(torch.as_tensor(x), with_energy=True)
    _assert_forces_match(got, jmodel.forces(jnp.asarray(x), with_energy=True))
    f_only, e_zero = tmodel.forces(torch.as_tensor(x))
    assert torch.equal(f_only, got[0]) and float(e_zero) == 0.0


def test_polar_ejection_changes_the_force(designs):
    x = torch.as_tensor(_metaphase_start(designs))
    _, plain = _pro_models(designs)
    _, ejecting = _pro_models(designs, **EJECTION)
    assert (ejecting.forces(x)[0] - plain.forces(x)[0]).abs().max() > 0.1


def test_sister_cohesion_uses_the_bond_spring(designs):
    """The JAX package holds sister kinetochores with ``bond_spring`` at
    ``sister_separation``; ``sister_spring`` does not enter the force."""
    x = torch.as_tensor(_metaphase_start(designs))
    _, a = _pro_models(designs, sister_spring=1000.0)
    _, b = _pro_models(designs, sister_spring=1.0)
    assert torch.equal(a.forces(x)[0], b.forces(x)[0])
    _, c = _pro_models(designs, sister_separation=0.1)
    assert not torch.equal(a.forces(x)[0], c.forces(x)[0])


# -- trajectories at temperature 0 -------------------------------------------

def _jax_steps(step_fn, x, steps):
    carry = (jnp.asarray(x), jax.random.PRNGKey(0))
    run = jax.jit(lambda c: jax.lax.scan(
        lambda cr, s: (step_fn(cr, s), None), c, jnp.arange(steps))[0])
    return np.asarray(run(carry)[0])


def _torch_steps(step_fn, x, steps):
    carry = convert.mitotic_state_from_numpy(x, seed=0, device="cpu")
    for s in range(steps):
        carry = step_fn(carry, s)
    return carry[0].numpy()


@pytest.mark.parametrize("telophase", [False, True], ids=["anaphase", "telophase"])
def test_anatelophase_200_steps_match_jax(designs, telophase):
    jmodel, tmodel = _ana_models(designs)
    x = _rods(designs) + (np.asarray([0, 5, 0], np.float32) if telophase else 0)
    want = _jax_steps(lambda c, s: jmodel.step(c, s, telophase), x, STEPS)
    got = _torch_steps(lambda c, s: tmodel.step(c, s, telophase), x, STEPS)
    assert np.abs(want - x).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("ejection", [{}, EJECTION], ids=["no ejection", "ejection"])
def test_prometaphase_200_steps_match_jax(designs, ejection):
    jmodel, tmodel = _pro_models(designs, **ejection)
    x = _metaphase_start(designs)
    want = _jax_steps(jmodel.step, x, STEPS)
    got = _torch_steps(tmodel.step, x, STEPS)
    assert np.abs(want - x).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# -- noise ------------------------------------------------------------------------

@pytest.mark.parametrize("phase", ["anaphase", "telophase", "prometaphase"])
def test_one_step_with_handed_in_noise_matches_jax(designs, phase):
    """At temperature 1 the JAX step draws its noise from a split of its key;
    the same numbers handed to the port's step give the same positions."""
    if phase == "prometaphase":
        jmodel, tmodel = _pro_models(designs, temperature=1.0)
        x = _metaphase_start(designs)
        jstep, tstep = jmodel.step, tmodel.step
    else:
        jmodel, tmodel = _ana_models(designs, temperature=1.0)
        x = _rods(designs)
        telophase = phase == "telophase"
        jstep = lambda c, s: jmodel.step(c, s, telophase)
        tstep = lambda c, s, noise: tmodel.step(c, s, telophase, noise=noise)
    key = jax.random.PRNGKey(3)
    _, sub = jax.random.split(key)
    noise = np.asarray(jax.random.normal(sub, x.shape, jnp.float32))
    want = np.asarray(jstep((jnp.asarray(x), key), 0)[0])
    carry = convert.mitotic_state_from_numpy(x, seed=1, device="cpu")
    got = tstep(carry, 0, noise=torch.as_tensor(noise.copy()))[0].numpy()
    drawn = tstep(carry, 0, noise=None)[0].numpy()
    sigma = np.sqrt(2 * 1.0 * 0.1 * 1e-4)
    assert np.abs(want - x).max() > sigma        # the noise moved the beads
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # Without handed-in noise the generator draws other numbers of that size.
    assert 0.5 * sigma < np.std(drawn - got) < 3 * sigma


def test_generator_state_makes_a_run_repeat(designs):
    _, tmodel = _ana_models(designs, temperature=1.0)
    x = _rods(designs)
    runs = []
    for _ in range(2):
        carry = convert.mitotic_state_from_numpy(x, seed=11, device="cpu")
        for s in range(5):
            carry = tmodel.step(carry, s, False)
        runs.append(carry[0])
    assert torch.equal(runs[0], runs[1])


# -- the stage driver's order of calls -----------------------------------------------

class _RecordingStore:
    """The store calls ``run_stage_phase`` makes, recorded in ``events``."""

    def __init__(self, events):
        self.events, self.frames = events, {}

    def set_stage(self, stage):
        self.events.append(("stage", stage))

    def clear_frames(self):
        self.events.append(("clear",))

    def save_positions(self, step, positions):
        self.frames[step] = np.array(positions)

    def append_frame(self, step):
        self.events.append(("frame", step))


def test_stage_driver_enqueues_the_next_chunk_before_it_writes_a_frame():
    """Chunk k + 1 is called before frame k is written, and no chunk past
    the stage's last; frames, steps, progress lines and the returned state
    are those of a plain serial loop; the overlap and sync counters count."""
    from genome_cycle_tpu_torch.config import MitoticPhaseConfig
    from genome_cycle_tpu_torch.utils import tracing
    from genome_cycle_tpu_torch.utils.logging import progress_line

    m = dataclasses.replace(MitoticPhaseConfig(), sampling_interval=100, logging_interval=200)
    steps, start = 350, torch.arange(12, dtype=torch.float32).reshape(4, 3)

    def chunk_fn(state, k_steps, events):
        x, generator = state
        events.append(("chunk", len([e for e in events if e[0] == "chunk"]) + 1))
        x.mul_(1.5).add_(float(k_steps))           # in place: a frame must be copied first
        return (x, generator)

    def energy_fn(x):
        return (x * x).sum()

    events, lines = [], []
    store = _RecordingStore(events)
    before = tracing.counters()
    got = tana.run_stage_phase(store, "anaphase", steps, m,
                               lambda s, k: chunk_fn(s, k, events), energy_fn,
                               (start.clone(), None), lines.append)
    counted = tracing.counters_since(before)

    want_frames, want_lines, x = {}, [], start.clone()
    for chunk in range(steps // m.sampling_interval + 1):
        if chunk:
            x = chunk_fn((x, None), m.sampling_interval, [])[0]
        step = chunk * m.sampling_interval
        want_frames[step] = x.numpy().copy()
        if step % m.logging_interval == 0:
            want_lines.append(progress_line("anaphase", step,
                                            energy=float(energy_fn(x)) / x.shape[0]))

    assert events == [("stage", "anaphase"), ("clear",), ("chunk", 1), ("frame", 0),
                      ("chunk", 2), ("frame", 100), ("chunk", 3), ("frame", 200),
                      ("frame", 300)]
    assert list(store.frames) == list(want_frames)
    for step, frame in want_frames.items():
        assert np.array_equal(store.frames[step], frame)
    # The stamp aside, the same lines: "[stage] <stamp>", step, energy.
    assert [line.split(" ")[0] for line in lines] == ["[anaphase]"] * 2
    assert [line.split("\t")[1:] for line in lines] == \
        [line.split("\t")[1:] for line in want_lines]
    assert torch.equal(got[0], x) and got[1] is None
    assert counted.get("mitotic.frames_overlapped") == 3
    assert counted.get("sync.mitotic_frame") == 4 and counted.get("sync.mitotic_energy") == 2
