"""The mitotic chunk (``ops/mitotic.py``, ``csrc/mitotic_chunk.cu``) on the CPU:
its term tables against the models' force fields and the JAX package's, its
plain version against the eager step, and the stage driver through chunks
against the JAX package's ``lax.scan`` at temperature 0.

The design and starts are those of ``test_torch_mitotic.py`` (a 300- and a
200-bead chain coarse-grained by 10; rods, a ball, a metaphase plate).

Tolerances: the tables' forces within 1e-5 of max|F| of the model's eager
forces and of the JAX package's (float32 on every side, the sums in another
order: a bead sums its own terms where the eager forces scatter them);
``run_chunk_reference`` equal to the bit to K eager steps on the same noise
(the same operations); 200 steps at temperature 0 within 1e-4 absolute of
the JAX package's (coordinates of order 1 to 10), as the eager step is.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_cycle_tpu.models import anatelophase as jana
from genome_cycle_tpu.models import prometaphase as jpro
from genome_cycle_tpu_torch import convert
from genome_cycle_tpu_torch.models import anatelophase as tana
from genome_cycle_tpu_torch.models import prometaphase as tpro
from genome_cycle_tpu_torch.ops import mitotic
from genome_cycle_tpu_torch.store import MemoryStore

from test_torch_mitotic import (  # noqa: F401  (designs: a fixture)
    EJECTION, STEPS, _ball, _jax_steps, _metaphase_start, _rods, _with, designs,
)

torch.set_num_threads(1)

TABLE_TOLERANCE = 1e-5
TRAJECTORY_TOLERANCE = 1e-4
PHASES = ["anaphase", "telophase", "prometaphase"]


def _without_kinetochore(design, chains):
    """``design`` with the kinetochores of the chains ``chains`` taken away."""
    return dataclasses.replace(design, chains=[
        dataclasses.replace(c, kinetochore=None) if k in chains else c
        for k, c in enumerate(design.chains)])


def _models(designs, phase, bare=False, **fields):
    """(JAX model, port model) of the phase's stage, optionally with a chain
    (anatelophase) or one sister of a pair (prometaphase) left without its
    kinetochore."""
    (jconfig, jana_design, jpro_design), (tconfig, tana_design, tpro_design) = designs
    jconfig, tconfig = _with(jconfig, **fields), _with(tconfig, **fields)
    if phase == "prometaphase":
        if bare:
            chains = {int(tpro_design.sister_chromatids[1][1])}
            jpro_design = _without_kinetochore(jpro_design, chains)
            tpro_design = _without_kinetochore(tpro_design, chains)
        return (jpro.PrometaphaseModel.from_design(jpro_design, jconfig),
                tpro.PrometaphaseModel.from_design(tpro_design, tconfig, "cpu"))
    if bare:
        jana_design = _without_kinetochore(jana_design, {1})
        tana_design = _without_kinetochore(tana_design, {1})
    return (jana.AnatelophaseModel.from_design(jana_design, jconfig),
            tana.AnatelophaseModel.from_design(tana_design, tconfig, "cpu"))


def _terms(model, phase):
    if phase == "prometaphase":
        return model.mitotic_terms()
    return model.mitotic_terms(phase == "telophase")


def _eager_forces(jmodel, tmodel, phase, x):
    if phase == "prometaphase":
        return tmodel.forces(torch.as_tensor(x))[0], jmodel.forces(jnp.asarray(x))[0]
    telophase = phase == "telophase"
    return (tmodel.forces(torch.as_tensor(x), telophase)[0],
            jmodel.forces(jnp.asarray(x), telophase)[0])


def _start(designs, phase, start="rods"):
    if phase == "prometaphase":
        return _metaphase_start(designs)
    if start == "ball":
        return _ball(50, 1.2, seed=3) * 1.5
    return _rods(designs) + (np.asarray([0, 5, 0], np.float32) if phase == "telophase" else 0)


# -- the tables ------------------------------------------------------------------

TABLE_CASES = [
    ("anaphase", "rods", {}, False),
    ("anaphase", "ball", {}, False),
    ("telophase", "rods", {}, False),
    ("telophase", "ball", {}, False),
    ("prometaphase", "plate", {}, False),
    ("prometaphase", "plate", EJECTION, False),
    ("anaphase", "rods", {"penalize_centromere_bending": True}, False),
    ("telophase", "ball", {"penalize_centromere_bending": True}, False),
    ("prometaphase", "plate", {"penalize_centromere_bending": True, **EJECTION}, False),
    ("anaphase", "rods", {}, True),
    ("prometaphase", "plate", EJECTION, True),
]


@pytest.mark.parametrize("phase, start, fields, bare", TABLE_CASES, ids=[
    f"{p}-{s}" + ("-ejection" if "polar_ejection_force" in f else "")
    + ("-penalized" if f.get("penalize_centromere_bending") else "")
    + ("-chain without kinetochore" if b else "") for p, s, f, b in TABLE_CASES])
def test_table_forces_match_the_model_and_jax(designs, phase, start, fields, bare):
    jmodel, tmodel = _models(designs, phase, bare, **fields)
    x = _start(designs, phase, start)
    terms = _terms(tmodel, phase)
    got = mitotic.forces_from_terms_reference(torch.as_tensor(x), terms).numpy()
    eager, jax_forces = _eager_forces(jmodel, tmodel, phase, x)
    for want in (eager.numpy(), np.asarray(jax_forces)):
        fmax = float(np.abs(want).max())
        assert fmax > 1.0
        assert np.abs(got - want).max() <= TABLE_TOLERANCE * fmax


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("penalize", [False, True], ids=["split at kinetochores", "penalized"])
def test_table_holds_every_term_at_every_bead(designs, phase, penalize):
    """Each bond at both ends, each triple at its three beads in their
    roles, each fiber at its kinetochore, and nothing else."""
    _, tmodel = _models(designs, phase, penalize_centromere_bending=penalize)
    table = _terms(tmodel, phase).table.numpy()
    kinds = table[..., 0]
    want_bonds = [tmodel.bond_pairs.numpy()]
    fibers = np.zeros(0, np.int64)
    if phase == "prometaphase":
        want_bonds.append(tmodel.sister_pairs.numpy())
        fibers = tmodel.kfiber_kinetochores.numpy()
    elif phase == "anaphase":
        fibers = tmodel.kinetochores.numpy()
    got_bonds = {(bead, int(p), int(s)) for bead, w in zip(*np.nonzero(kinds == mitotic.BOND))
                 for p, s in [table[bead, w, 1:3]]}
    assert got_bonds == {(int(i), int(j), s) for s, pairs in enumerate(want_bonds)
                         for a, b in pairs for i, j in ((a, b), (b, a))}
    triples = tmodel.triples.numpy()
    for role, kind in enumerate((mitotic.TRIPLE_I, mitotic.TRIPLE_J, mitotic.TRIPLE_K)):
        beads, slots = np.nonzero(kinds == kind)
        got = sorted(map(tuple, table[beads, slots, 1:].tolist()))
        assert got == sorted(map(tuple, triples.tolist()))
        assert np.array_equal(np.sort(beads), np.sort(triples[:, role]))
    beads, slots = np.nonzero(kinds == mitotic.FIBER)
    assert np.array_equal(beads[np.argsort(table[beads, slots, 1])], fibers)
    assert set(np.unique(kinds).tolist()) <= {0, mitotic.BOND, mitotic.TRIPLE_I,
                                              mitotic.TRIPLE_J, mitotic.TRIPLE_K, mitotic.FIBER}
    # Split at the kinetochores, the kinetochore bead is the j of no triple.
    kinetochores = fibers if phase != "telophase" else tmodel.kinetochores.numpy()
    j_beads = set(triples[:, 1].tolist())
    assert penalize == bool(set(kinetochores.tolist()) & j_beads)


# -- the plain version -------------------------------------------------------------

@pytest.mark.parametrize("phase", PHASES)
def test_plain_chunk_is_k_eager_steps_to_the_bit(designs, phase):
    """At temperature 1: ``run_chunk_reference`` against K calls of the
    eager ``step`` with the same noise slabs, and the model's ``run_chunk``
    (one draw of (K, N, 3) from the generator) against the same."""
    _, tmodel = _models(designs, phase, temperature=1.0)
    x0 = torch.as_tensor(_start(designs, phase))
    k_steps = 20
    noise = torch.randn((k_steps, tmodel.n, 3), generator=torch.Generator().manual_seed(4))
    m = tmodel.config
    telophase = phase == "telophase"
    if phase == "prometaphase":
        step = tmodel.step
        chunk = tmodel.run_chunk
    else:
        step = lambda c, s, noise=None: tmodel.step(c, s, telophase, noise=noise)
        chunk = lambda c, steps: tmodel.run_chunk(c, steps, telophase)
    carry = (x0, None)
    for k in range(k_steps):
        carry = step(carry, k, noise=noise[k])
    terms = _terms(tmodel, phase)
    got = mitotic.run_chunk_reference(x0, terms.forces, tmodel.mobility, noise,
                                      m.temperature, m.timestep)
    assert (carry[0] - x0).abs().max() > 1e-3
    assert torch.equal(got, carry[0])
    assert torch.equal(mitotic.run_chunk(x0, terms, tmodel.mobility, noise, m.temperature,
                                         m.timestep), carry[0])
    seeded = convert.mitotic_state_from_numpy(x0.numpy(), seed=9, device="cpu")
    drawn = torch.randn((k_steps, tmodel.n, 3), generator=torch.Generator().manual_seed(9))
    again = mitotic.run_chunk_reference(x0, terms.forces, tmodel.mobility, drawn,
                                        m.temperature, m.timestep)
    assert torch.equal(chunk(seeded, k_steps)[0], again)


# -- the stage driver at temperature 0 against the JAX package -----------------------

@pytest.mark.parametrize("phase, fields", [
    ("anaphase", {}), ("telophase", {}), ("prometaphase", {}), ("prometaphase", EJECTION),
], ids=["anaphase", "telophase", "prometaphase", "prometaphase-ejection"])
def test_stage_driver_through_chunks_matches_jax_scan(designs, phase, fields):
    """``run_stage_phase`` with the model's chunk, a frame every 100 steps,
    over 200 steps at temperature 0, against the JAX model's ``lax.scan``."""
    jmodel, tmodel = _models(designs, phase, **fields)
    x = _start(designs, phase)
    telophase = phase == "telophase"
    if phase == "prometaphase":
        jstep, chunk = jmodel.step, tmodel.run_chunk
        energy = lambda y: tmodel.forces(y, with_energy=True)[1]
    else:
        jstep = lambda c, s: jmodel.step(c, s, telophase)
        chunk = lambda state, steps: tmodel.run_chunk(state, steps, telophase)
        energy = lambda y: tmodel.forces(y, telophase, with_energy=True)[1]
    want = _jax_steps(jstep, x, STEPS)
    m = dataclasses.replace(tmodel.config, sampling_interval=100, logging_interval=100)
    store, lines, timings = MemoryStore(), [], {}
    state = convert.mitotic_state_from_numpy(x, seed=0, device="cpu")
    got, _ = tana.run_stage_phase(store, phase, STEPS, m, chunk, energy, state,
                                  lines.append, timings)
    assert store.load_steps() == [0, 100, 200]
    assert len(lines) == 3 and timings[f"{phase}_steps"] == STEPS
    assert np.abs(want - x).max() > 0.05
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TRAJECTORY_TOLERANCE)


# -- what the wrapper refuses -------------------------------------------------------

@pytest.mark.parametrize("case", ["float64 positions", "positions (N, 2)", "noise of other N",
                                  "strided noise", "float64 mobility"])
def test_run_chunk_refuses_what_the_kernel_does_not_take(designs, case):
    _, tmodel = _models(designs, "anaphase")
    terms = tmodel.mitotic_terms(False)
    x = torch.as_tensor(_rods(designs))
    noise = torch.zeros((4, tmodel.n, 3))
    mobility = tmodel.mobility
    if case == "float64 positions":
        x, error = x.double(), TypeError
    elif case == "positions (N, 2)":
        x, error = x[:, :2].contiguous(), ValueError
    elif case == "noise of other N":
        noise, error = torch.zeros((4, tmodel.n + 1, 3)), ValueError
    elif case == "strided noise":
        noise, error = torch.zeros((tmodel.n, 4, 3)).transpose(0, 1), ValueError
    else:
        mobility, error = mobility.double(), TypeError
    with pytest.raises(error):
        mitotic.run_chunk(x, terms, mobility, noise, 1.0, 1e-4)


def test_chunk_kernel_refuses_a_cpu_tensor(designs):
    _, tmodel = _models(designs, "anaphase")
    x = torch.as_tensor(_rods(designs))
    with pytest.raises(ValueError, match="CUDA tensor"):
        mitotic.launch_chunk(x, tmodel.mitotic_terms(False), tmodel.mobility,
                             torch.zeros((4, tmodel.n, 3)), 1.0, 1e-4)


def test_capacity_and_lanes_a_row():
    """The capacity the wrapper states is the most beads whose shared memory
    fits (227 KB a block on the H100: 6,938 beads in a cluster of 16); a
    row's lanes divide a warp."""
    limit = 232448
    n = mitotic.capacity(limit)
    assert mitotic.shared_bytes(n) <= limit < mitotic.shared_bytes(n + 1)
    for beads in (50, 576, 1152, n):
        lanes = mitotic.lanes_per_row(beads, slots=9)
        assert lanes in (1, 2, 4, 8, 16, 32)
    assert n == 6938
