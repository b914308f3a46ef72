"""Port vs JAX package: every function of ops/potentials.py.

The same numpy inputs (seeded) go through both; float32 on both sides.
Tolerance rtol 1e-5, plus atol 1e-6 of the largest value for values that
cross zero by cancellation (a spring near its rest length): the two evaluate
the same float32 expressions, differing only in the rounding of pow/sqrt.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_cycle_tpu.ops import potentials as jpot
from genome_cycle_tpu_torch.ops import potentials as tpot

# The suite runs in several worker processes at once: one thread each keeps
# torch from oversubscribing the cores (sizes here are tiny).
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _r2(seed=0, n=257, hi=0.5):
    rng = np.random.default_rng(seed)
    r = rng.uniform(1e-3, hi, n).astype(np.float32)
    return r * r


AB_PARAMS = dict(a_energy=2.5, a_diameter=0.3, b_energy=2.0, b_diameter=0.24)

CASES = {
    "softcore_energy_2_3": ("softcore_energy", (2.5, 0.3, 2, 3)),
    "softcore_energy_8_3": ("softcore_energy", (2.5, 0.24, 8, 3)),
    "softcore_force_coeff_2_3": ("softcore_force_coeff", (2.5, 0.3, 2, 3)),
    "softcore_force_coeff_8_3": ("softcore_force_coeff", (2.5, 0.24, 8, 3)),
    "softwell_energy": ("softwell_energy", (0.3, 0.2, 6)),
    "softwell_force_coeff": ("softwell_force_coeff", (0.3, 0.2, 6)),
    "spring_energy": ("spring_energy", (100.0, 0.1)),
    "spring_force_coeff": ("spring_force_coeff", (100.0, 0.1)),
    "semispring_energy": ("semispring_energy", (100.0, 0.2)),
    "semispring_force_coeff": ("semispring_force_coeff", (100.0, 0.2)),
    "harmonic_energy": ("harmonic_energy", (50.0,)),
    "harmonic_force_coeff": ("harmonic_force_coeff", (50.0,)),
    "force_flux_energy": ("force_flux_energy", (3.0, 0.25)),
    "force_flux_force_coeff": ("force_flux_force_coeff", (3.0, 0.25)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pair_potential_matches_jax(case):
    name, args = CASES[case]
    r2 = _r2()
    want = np.asarray(getattr(jpot, name)(jnp.asarray(r2), *args))
    got = getattr(tpot, name)(torch.from_numpy(r2), *args).numpy()
    np.testing.assert_allclose(
        got, np.broadcast_to(want, got.shape), rtol=RTOL,
        atol=ATOL * max(1.0, float(np.abs(want).max())),
    )


def test_cutoff_shift_matches_jax():
    r2 = _r2(1)
    want = jpot.cutoff_shift(
        lambda q: jpot.softwell_energy(q, 0.3, 0.2, 6), jnp.asarray(r2), 0.4
    )
    got = tpot.cutoff_shift(
        lambda q: tpot.softwell_energy(q, 0.3, 0.2, 6), torch.from_numpy(r2), 0.4
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert (got.numpy()[r2 >= 0.16] == 0).all()


def test_cosine_bending_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(64, 3)).astype(np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    want = jpot.cosine_bending_energy(jnp.asarray(a), jnp.asarray(b), 1.5)
    got = tpot.cosine_bending_energy(torch.from_numpy(a), torch.from_numpy(b), 1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fn", ["ab_pair_energy", "ab_pair_force_coeff"])
def test_ab_pair_matches_jax(fn):
    rng = np.random.default_rng(3)
    r2 = _r2(3, hi=0.35)
    a_mix = rng.uniform(0, 1, r2.shape).astype(np.float32)
    b_mix = (1 - a_mix).astype(np.float32)
    want = getattr(jpot, fn)(jnp.asarray(r2), jnp.asarray(a_mix), jnp.asarray(b_mix), AB_PARAMS)
    got = getattr(tpot, fn)(
        torch.from_numpy(r2), torch.from_numpy(a_mix), torch.from_numpy(b_mix), AB_PARAMS
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # Both cores are zero beyond their diameters.
    assert (got.numpy()[r2 > 0.09] == 0).all()
