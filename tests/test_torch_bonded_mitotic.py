"""The bonded terms of the mitotic stages, port against the JAX package.

Bending triples, the closed-form bending force (against the port's autograd
yardstick and the JAX function, which differentiates the energy), point
sources and kinetochore fibers.  Inputs come from numpy with a seed.

Tolerances: float32 on both sides, rtol 1e-5 and atol 1e-6 on forces and
energies (another order of the same few operations); the degenerate triple,
whose force is of order 1e15, rtol 1e-5 alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_cycle_tpu.ops import bonded as jbonded
from genome_cycle_tpu.ops import potentials as jpot
from genome_cycle_tpu.topology import ChainAssignment as JChain
from genome_cycle_tpu_torch.ops import bonded as tbonded
from genome_cycle_tpu_torch.ops import potentials as tpot
from genome_cycle_tpu_torch.topology import ChainAssignment

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6

CHAIN_SETS = {
    "kinetochore inside": [("a", 0, 12, 5), ("b", 12, 30, 20)],
    "no kinetochore": [("a", 0, 9, None), ("b", 9, 20, 15)],
    "shorter than three": [("a", 0, 2, None), ("b", 2, 4, 3), ("c", 4, 5, 4)],
    "kinetochore at the ends": [("a", 0, 6, 0), ("b", 6, 12, 11), ("c", 12, 16, 13)],
    "no chain": [],
}


def _chains(cls, name):
    return [cls(n, s, e, kinetochore=k) for n, s, e, k in CHAIN_SETS[name]]


@pytest.mark.parametrize("penalize", [False, True])
@pytest.mark.parametrize("name", list(CHAIN_SETS))
def test_bending_triples_equal_jax(name, penalize):
    got = tbonded.bending_triples(_chains(ChainAssignment, name), penalize)
    want = np.asarray(jbonded.bending_triples(_chains(JChain, name), penalize))
    assert got.dtype == np.int32 and got.shape == want.shape and got.shape[1] == 3
    np.testing.assert_array_equal(got, want)


def test_bending_triples_split_at_the_kinetochore():
    chains = _chains(ChainAssignment, "kinetochore inside")
    split = tbonded.bending_triples(chains, False)
    whole = tbonded.bending_triples(chains, True)
    assert len(whole) == (12 - 2) + (18 - 2)
    assert not np.isin(split, [5, 20]).any()
    assert len(split) == (5 - 2) + (6 - 2) + (8 - 2) + (9 - 2)


def _walk(n, seed, step=0.3):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    return np.cumsum(step * d / np.linalg.norm(d, axis=1, keepdims=True), axis=0).astype(
        np.float32
    )


def _triples(name="kinetochore inside"):
    return tbonded.bending_triples(_chains(ChainAssignment, name), False)


@pytest.mark.parametrize("bending_energy", [1.0, 2.5])
def test_bending_forces_match_autograd_and_jax(bending_energy):
    x = _walk(30, seed=5)
    triples = _triples()
    f, e = tbonded.bending_forces(torch.as_tensor(x), torch.as_tensor(triples), bending_energy)
    f_ad, e_ad = tbonded.bending_forces_autograd(
        torch.as_tensor(x), torch.as_tensor(triples), bending_energy
    )
    f_j, e_j = jbonded.bending_forces(jnp.asarray(x), jnp.asarray(triples), bending_energy)
    assert float(np.abs(np.asarray(f_j)).max()) > 0.1
    for other_f, other_e in ((f_ad.numpy(), float(e_ad)), (np.asarray(f_j), float(e_j))):
        np.testing.assert_allclose(f.numpy(), other_f, rtol=RTOL, atol=ATOL)
        assert float(e) == pytest.approx(other_e, rel=RTOL, abs=ATOL)
    # Internal forces: no net force.
    np.testing.assert_allclose(f.numpy().sum(axis=0), 0.0, atol=1e-5)
    f_only, e_zero = tbonded.bending_forces(
        torch.as_tensor(x), torch.as_tensor(triples), bending_energy, with_energy=False
    )
    assert torch.equal(f_only, f) and float(e_zero) == 0.0


@pytest.mark.parametrize("coincident", [(0, 1), (1, 2), (0, 1, 2)])
def test_bending_forces_degenerate_triple_matches_autograd_and_jax(coincident):
    """Two (or three) coincident beads put the norm product under its clamp:
    the force is huge but finite, and the same on all three routes."""
    x = _walk(6, seed=8)
    for bead in coincident[1:]:
        x[bead] = x[coincident[0]]
    triples = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
    f, e = tbonded.bending_forces(torch.as_tensor(x), torch.as_tensor(triples), 1.0)
    f_ad, e_ad = tbonded.bending_forces_autograd(
        torch.as_tensor(x), torch.as_tensor(triples), 1.0
    )
    f_j, e_j = jbonded.bending_forces(jnp.asarray(x), jnp.asarray(triples), 1.0)
    assert np.isfinite(f.numpy()).all() and np.isfinite(np.asarray(f_j)).all()
    if len(coincident) == 2:
        assert float(f.abs().max()) > 1e12
    scale = max(float(f.abs().max()), 1.0)
    np.testing.assert_allclose(f.numpy() / scale, f_ad.numpy() / scale, rtol=0, atol=RTOL)
    np.testing.assert_allclose(f.numpy() / scale, np.asarray(f_j) / scale, rtol=0, atol=RTOL)
    assert float(e) == pytest.approx(float(e_ad), rel=RTOL)
    assert float(e) == pytest.approx(float(e_j), rel=RTOL)


def test_bending_forces_without_triples():
    x = torch.as_tensor(_walk(4, seed=1))
    empty = torch.zeros((0, 3), dtype=torch.int64)
    for fn in (tbonded.bending_forces, tbonded.bending_forces_autograd):
        f, e = fn(x, empty, 1.0)
        assert f.shape == x.shape and not f.any() and float(e) == 0.0


POTENTIALS = {
    "semispring": (
        lambda pot: (lambda r2: pot.semispring_energy(r2, 100.0, 1.5)),
        lambda pot: (lambda r2: pot.semispring_force_coeff(r2, 100.0, 1.5)),
    ),
    "force flux": (
        lambda pot: (lambda r2: pot.force_flux_energy(r2, 3.0, 0.7)),
        lambda pot: (lambda r2: pot.force_flux_force_coeff(r2, 3.0, 0.7)),
    ),
}


@pytest.mark.parametrize("with_targets", [False, True])
@pytest.mark.parametrize("potential", list(POTENTIALS))
def test_point_source_forces_match_jax(potential, with_targets):
    x = 2.0 * _walk(40, seed=3)
    source = np.asarray([0.3, -0.2, 0.5], np.float32)
    targets = np.asarray([3, 7, 8, 21, 39], np.int32) if with_targets else None
    energy, coeff = POTENTIALS[potential]
    f, e = tbonded.point_source_forces(
        torch.as_tensor(x), torch.as_tensor(source), energy(tpot), coeff(tpot),
        None if targets is None else torch.as_tensor(targets),
    )
    f_j, e_j = jbonded.point_source_forces(
        jnp.asarray(x), jnp.asarray(source), energy(jpot), coeff(jpot),
        None if targets is None else jnp.asarray(targets),
    )
    assert float(np.abs(np.asarray(f_j)).max()) > 0.1
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), rtol=RTOL, atol=ATOL)
    assert float(e) == pytest.approx(float(e_j), rel=RTOL, abs=ATOL)
    if with_targets:
        others = np.setdiff1d(np.arange(40), targets)
        assert not f.numpy()[others].any()
    f_only, e_zero = tbonded.point_source_forces(
        torch.as_tensor(x), torch.as_tensor(source), None, coeff(tpot),
        None if targets is None else torch.as_tensor(targets),
    )
    assert torch.equal(f_only, f) and float(e_zero) == 0.0


def test_point_source_forces_of_two_sources_add_up():
    x = torch.as_tensor(2.0 * _walk(40, seed=4))
    sources = torch.tensor([[0.0, 5.0, 0.0], [0.0, -5.0, 0.0]])
    energy, coeff = (fn(tpot) for fn in POTENTIALS["force flux"])
    f, e = tbonded.point_source_forces(x, sources, energy, coeff)
    parts = [tbonded.point_source_forces(x, s, energy, coeff) for s in sources]
    np.testing.assert_allclose(
        f.numpy(), (parts[0][0] + parts[1][0]).numpy(), rtol=RTOL, atol=ATOL
    )
    assert float(e) == pytest.approx(float(parts[0][1] + parts[1][1]), rel=RTOL)


@pytest.mark.parametrize("length", [0.0, 0.4])
def test_kfiber_forces_match_jax(length):
    x = 2.0 * _walk(40, seed=6)
    kinetochores = np.asarray([4, 17, 30], np.int32)
    pole = np.asarray([0.0, 2.0, 0.0], np.float32)
    springs = np.asarray([120.0, 250.0, 80.0], np.float32)
    f, e = tbonded.kfiber_forces(
        torch.as_tensor(x), torch.as_tensor(kinetochores), torch.as_tensor(pole),
        torch.as_tensor(springs), length,
    )
    f_j, e_j = jbonded.kfiber_forces(
        jnp.asarray(x), jnp.asarray(kinetochores), jnp.asarray(pole),
        jnp.asarray(springs), jnp.asarray(length, jnp.float32),
    )
    assert float(np.abs(np.asarray(f_j)).max()) > 10.0
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), rtol=RTOL, atol=ATOL)
    assert float(e) == pytest.approx(float(e_j), rel=RTOL)
    others = np.setdiff1d(np.arange(40), kinetochores)
    assert not f.numpy()[others].any()
    f_only, e_zero = tbonded.kfiber_forces(
        torch.as_tensor(x), torch.as_tensor(kinetochores), torch.as_tensor(pole),
        torch.as_tensor(springs), length, with_energy=False,
    )
    assert torch.equal(f_only, f) and float(e_zero) == 0.0


def test_kfiber_forces_with_a_pole_for_each_kinetochore():
    """Two fields in one call equal the sum of the two calls."""
    x = torch.as_tensor(2.0 * _walk(40, seed=7))
    kin = torch.tensor([4, 17, 30, 9, 22, 35])
    springs = torch.tensor([120.0, 250.0, 80.0, 120.0, 250.0, 80.0])
    poles = torch.tensor([[0.0, 5.0, 0.0], [0.0, -5.0, 0.0]])
    f, e = tbonded.kfiber_forces(x, kin, poles.repeat_interleave(3, dim=0), springs, 0.0)
    parts = [
        tbonded.kfiber_forces(x, kin[3 * k: 3 * k + 3], poles[k], springs[:3], 0.0)
        for k in range(2)
    ]
    np.testing.assert_allclose(
        f.numpy(), (parts[0][0] + parts[1][0]).numpy(), rtol=RTOL, atol=ATOL
    )
    assert float(e) == pytest.approx(float(parts[0][1] + parts[1][1]), rel=RTOL)


def test_pair_bond_forces_without_energy_fn():
    x = torch.as_tensor(_walk(10, seed=9, step=0.4))
    pairs = torch.as_tensor(tbonded.chain_bond_pairs([ChainAssignment("a", 0, 10, 4)]))
    coeff = lambda r2: tpot.semispring_force_coeff(r2, 1000.0, 0.3)
    f, e = tbonded.pair_bond_forces(
        x, pairs, lambda r2: tpot.semispring_energy(r2, 1000.0, 0.3), coeff
    )
    f_only, e_zero = tbonded.pair_bond_forces(x, pairs, None, coeff)
    assert float(e) > 0 and float(e_zero) == 0.0 and torch.equal(f, f_only)
