"""Port vs JAX package: bonded forces, wall force and reaction, BD update.

Inputs are made with numpy from a seed and handed to both sides; float32 on
both.  Tolerances: rtol 1e-4 / atol 1e-4 of the largest force for forces and
reactions (sums of a few hundred float32 terms in another order), 1e-5
relative for energies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_cycle_tpu.ops import bonded as jbonded
from genome_cycle_tpu.ops import integrator as jint
from genome_cycle_tpu.ops import potentials as jpot
from genome_cycle_tpu.ops import wall as jwall
from genome_cycle_tpu.topology import ChainAssignment
from genome_cycle_tpu_torch.ops import bonded as tbonded
from genome_cycle_tpu_torch.ops import integrator as tint
from genome_cycle_tpu_torch.ops import potentials as tpot
from genome_cycle_tpu_torch.ops import wall as twall

# The suite runs in several worker processes at once: one thread each keeps
# torch from oversubscribing the cores (sizes here are tiny).
torch.set_num_threads(1)

CHAINS = [ChainAssignment("a", 0, 40), ChainAssignment("b", 40, 41),
          ChainAssignment("c", 41, 100)]


def assert_forces_close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max())
    )


def _positions(seed=0, n=100, scale=0.3):
    return np.random.default_rng(seed).normal(0, scale, (n, 3)).astype(np.float32)


# -- bonded -------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["chain_bond_pairs", "loop_bond_pairs"])
def test_bond_pair_lists_match(fn):
    want = np.asarray(getattr(jbonded, fn)(CHAINS))
    got = getattr(tbonded, fn)(CHAINS)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert getattr(tbonded, fn)([]).shape == (0, 2)


def test_pair_bond_forces_match_jax():
    x = _positions(1)
    pairs = np.asarray(jbonded.chain_bond_pairs(CHAINS))
    k, l = 80.0, 0.05
    fj, ej = jbonded.pair_bond_forces(
        jnp.asarray(x), jnp.asarray(pairs),
        lambda r2: jpot.semispring_energy(r2, k, l),
        lambda r2: jpot.semispring_force_coeff(r2, k, l),
    )
    ft, et = tbonded.pair_bond_forces(
        torch.from_numpy(x), torch.from_numpy(pairs),
        lambda r2: tpot.semispring_energy(r2, k, l),
        lambda r2: tpot.semispring_force_coeff(r2, k, l),
    )
    assert_forces_close(ft, fj)
    assert float(et) == pytest.approx(float(ej), rel=1e-5)
    # No bonds: zero force, zero energy.
    f0, e0 = tbonded.pair_bond_forces(
        torch.from_numpy(x), torch.zeros((0, 2), dtype=torch.long), None, None
    )
    assert not f0.any() and float(e0) == 0.0


@pytest.mark.parametrize("offset", [1, 2])
def test_shift_bond_forces_match_jax_and_pair_form(offset):
    """The roll formulation equals the gather/scatter one; the mask kills the
    rows whose roll wraps around the end of the array."""
    x = _positions(2)
    n = len(x)
    make = jbonded.chain_bond_pairs if offset == 1 else jbonded.loop_bond_pairs
    pairs = np.asarray(make(CHAINS))
    mask = np.zeros(n, bool)
    mask[pairs[:, 0]] = True
    assert not mask[n - offset:].any()          # wrap-around rows own no bond
    k_row = np.random.default_rng(3).uniform(20, 100, n).astype(np.float32)

    fj, ej = jbonded.shift_bond_forces(
        jnp.asarray(x), offset, jnp.asarray(mask),
        lambda r2: jpot.harmonic_energy(r2, jnp.asarray(k_row)),
        lambda r2: jpot.harmonic_force_coeff(r2, jnp.asarray(k_row)),
    )
    kt = torch.from_numpy(k_row)
    ft, et = tbonded.shift_bond_forces(
        torch.from_numpy(x), offset, torch.from_numpy(mask),
        lambda r2: tpot.harmonic_energy(r2, kt),
        lambda r2: tpot.harmonic_force_coeff(r2, kt),
    )
    assert_forces_close(ft, fj)
    assert float(et) == pytest.approx(float(ej), rel=1e-5)

    kp = kt[torch.from_numpy(pairs[:, 0]).long()]
    fp, ep = tbonded.pair_bond_forces(
        torch.from_numpy(x), torch.from_numpy(pairs),
        lambda r2: tpot.harmonic_energy(r2, kp),
        lambda r2: tpot.harmonic_force_coeff(r2, kp),
    )
    assert_forces_close(ft, fp)
    assert float(et) == pytest.approx(float(ep), rel=1e-5)
    # A wrong mask (all True) would bond the last rows to the first ones.
    f_bad, _ = tbonded.shift_bond_forces(
        torch.from_numpy(x), offset, torch.ones(n, dtype=torch.bool),
        lambda r2: tpot.harmonic_energy(r2, kt),
        lambda r2: tpot.harmonic_force_coeff(r2, kt),
    )
    assert (f_bad[0] - ft[0]).abs().max() > 1e-3


# -- wall ---------------------------------------------------------------------

WALL_PARAMS = dict(a_energy=2.5, a_diameter=0.15, b_energy=2.5, b_diameter=0.12,
                   packing_spring=1000.0)
SEMIAXES = np.asarray([2.0, 1.7, 1.4], np.float32)


def _wall_inputs(kind):
    rng = np.random.default_rng(4)
    n = 200
    directions = rng.normal(size=(n, 3))
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    on_wall = directions * SEMIAXES
    if kind == "inside":       # within the soft core's reach of the wall
        x = on_wall * rng.uniform(0.93, 0.999, (n, 1))
    elif kind == "outside":    # harmonic recapture branch
        x = on_wall * rng.uniform(1.001, 1.2, (n, 1))
    else:                      # both branches, far interior included
        x = on_wall * rng.uniform(0.0, 1.15, (n, 1))
    a = rng.uniform(0, 1, n)
    return (x.astype(np.float32), (0.5 * a).astype(np.float32),
            (0.5 * (1 - a) + 5.0).astype(np.float32))


@pytest.mark.parametrize("kind", ["inside", "outside", "mixed"])
def test_wall_forces_match_jax_autodiff(kind):
    x, a_mix, b_mix = _wall_inputs(kind)
    fj, rj, ej = jwall.wall_forces(
        jnp.asarray(x), jnp.asarray(SEMIAXES), jnp.asarray(a_mix),
        jnp.asarray(b_mix), WALL_PARAMS,
    )
    ft, rt, et = twall.wall_forces(
        torch.from_numpy(x), torch.from_numpy(SEMIAXES), torch.from_numpy(a_mix),
        torch.from_numpy(b_mix), WALL_PARAMS,
    )
    assert np.abs(np.asarray(fj)).max() > 0
    assert_forces_close(ft, fj)
    assert_forces_close(rt, rj)
    assert float(et) == pytest.approx(float(ej), rel=1e-5)
    assert not ft.requires_grad and not rt.requires_grad


def test_wall_gradient_finite_at_origin_and_on_the_wall():
    """eps keeps both radicands positive, and the branch `where` does not
    take never passes a NaN gradient: a bead at the origin and one exactly on
    the wall get finite forces, equal to JAX's."""
    x = np.asarray([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0], [0.0, 1.7, 0.0],
                    [0.0, 0.0, -1.4], [0.3, 0.2, 0.1]], np.float32)
    a_mix = np.full(5, 0.5, np.float32)
    b_mix = np.full(5, 5.0, np.float32)
    fj, rj, _ = jwall.wall_forces(
        jnp.asarray(x), jnp.asarray(SEMIAXES), jnp.asarray(a_mix),
        jnp.asarray(b_mix), WALL_PARAMS,
    )
    ft, rt, et = twall.wall_forces(
        torch.from_numpy(x), torch.from_numpy(SEMIAXES), torch.from_numpy(a_mix),
        torch.from_numpy(b_mix), WALL_PARAMS,
    )
    assert torch.isfinite(ft).all() and torch.isfinite(rt).all() and torch.isfinite(et)
    assert np.isfinite(np.asarray(fj)).all()
    assert_forces_close(ft, fj)
    assert_forces_close(rt, rj)
    assert not ft[0].any()          # origin: deep inside, no force


def test_wall_forces_inside_no_grad_context():
    x, a_mix, b_mix = _wall_inputs("mixed")
    args = (torch.from_numpy(x), torch.from_numpy(SEMIAXES), torch.from_numpy(a_mix),
            torch.from_numpy(b_mix), WALL_PARAMS)
    want = twall.wall_forces(*args)
    with torch.no_grad():
        got = twall.wall_forces(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- integrator ---------------------------------------------------------------

def _bd_inputs(n=64):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    f = (rng.normal(size=(n, 3)) * 300).astype(np.float32)
    mu = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return x, f, mu


@pytest.mark.parametrize("spacestep", [None, 0.001])
def test_bd_update_zero_temperature_matches_jax(spacestep):
    x, f, mu = _bd_inputs()
    want = jint.bd_update(
        jnp.asarray(x), jnp.asarray(f), jnp.asarray(mu), jax.random.PRNGKey(0),
        jint.BDParams(0.0, 1e-3, spacestep),
    )
    gen = torch.Generator().manual_seed(0)
    got = tint.bd_update(
        torch.from_numpy(x), torch.from_numpy(f), torch.from_numpy(mu), gen,
        tint.BDParams(0.0, 1e-3, spacestep),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # T = 0 gives zero noise exactly: the update is the drift alone.
    dt = 1e-3
    if spacestep is not None:
        disp = np.linalg.norm(mu[:, None] * f, axis=1).max() * dt
        assert disp > spacestep                  # the limit is active here
        dt *= spacestep / disp
        moved = np.linalg.norm(got.numpy() - x, axis=1).max()
        assert moved == pytest.approx(spacestep, rel=1e-4)
    np.testing.assert_allclose(
        got.numpy(), x + mu[:, None] * f * np.float32(dt), rtol=1e-5, atol=1e-6
    )


def test_bd_update_noise_scales_with_effective_timestep():
    """spacestep scales dt, and the noise goes with sqrt(dt_eff); the noise
    handed in is used as it is."""
    x, f, mu = _bd_inputs()
    noise = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    temperature, dt, spacestep = 1.3, 1e-3, 0.001
    args = (torch.from_numpy(x), torch.from_numpy(f), torch.from_numpy(mu), None)
    got = tint.bd_update(*args, tint.BDParams(temperature, dt, spacestep),
                         noise=torch.from_numpy(noise))
    scale = spacestep / (np.linalg.norm(mu[:, None] * f, axis=1).max() * dt)
    dt_eff = dt * scale
    want = (x + mu[:, None] * f * dt_eff
            + np.sqrt(2 * temperature * mu * dt_eff)[:, None] * noise)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_bd_update_generator_is_reproducible():
    x, f, mu = _bd_inputs()
    args = (torch.from_numpy(x), torch.from_numpy(f), torch.from_numpy(mu))
    params = tint.BDParams(1.0, 1e-3)
    a = tint.bd_update(*args, torch.Generator().manual_seed(7), params)
    b = tint.bd_update(*args, torch.Generator().manual_seed(7), params)
    c = tint.bd_update(*args, torch.Generator().manual_seed(8), params)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_free_particle_msd():
    """MSD of free particles = 6 mu kT t, within 5 % (20,000 particles, 50
    steps: the estimator's standard error is about 0.6 %)."""
    n, steps, mu, kT, dt = 20000, 50, 0.7, 1.2, 1e-3
    x0 = torch.zeros((n, 3))
    x = x0
    gen = torch.Generator().manual_seed(11)
    mobility = torch.full((n,), mu)
    zero = torch.zeros((n, 3))
    for _ in range(steps):
        x = tint.bd_update(x, zero, mobility, gen, tint.BDParams(kT, dt))
    msd = float(((x - x0) ** 2).sum(dim=1).mean())
    assert msd == pytest.approx(6 * mu * kT * steps * dt, rel=0.05)
