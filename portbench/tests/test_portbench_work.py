"""The work counts of ``portbench/work`` against a brute-force count of the
pairs within reach, at tiny sizes on the CPU."""

import itertools

import numpy as np
import pytest

from portbench import work


def _brute(x, reach_of):
    count = 0
    for i, j in itertools.combinations(range(len(x)), 2):
        if np.sum((x[i] - x[j]) ** 2) < reach_of(i, j) ** 2:
            count += 1
    return count


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pairs_within_a_cutoff(seed):
    x = np.random.default_rng(seed).uniform(-1, 1, size=(150, 3))
    assert len(work.pairs_within(x, 0.3)) == _brute(x, lambda i, j: 0.3)
    w = work.contact_tick(x, 0.3)
    pairs = _brute(x, lambda i, j: 0.3)
    assert w == work.Work(work.TICK_OPS * pairs, 12 * 150 + 12 * pairs)


@pytest.mark.parametrize("seed", [4, 5])
def test_pair_force_counts_each_pair_within_its_mix_reach_once(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(2, 120, 3))
    af = rng.integers(0, 2, size=120).astype(float)
    bf = 1.0 - af
    bf[:5] = 0.0           # beads with neither factor reach nothing with each other
    da, db = 0.3, 0.24

    def reach(i, j):
        a_on, b_on = af[i] + af[j] > 0, bf[i] + bf[j] > 0
        return max(da if a_on else 0.0, db if b_on else 0.0)

    expected = sum(_brute(xr, reach) for xr in x)
    assert work.pair_force_pairs(x, af, bf, da, db) == expected
    assert work.pair_force(x, af, bf, da, db) == work.Work(
        work.PAIR_FORCE_OPS * expected, work.PAIR_FORCE_BYTES * 240)


def test_mitotic_chunk_and_step_rest_counts():
    x = np.random.default_rng(6).uniform(-1, 1, size=(80, 3))
    pairs = _brute(x, lambda i, j: 0.3)
    w = work.mitotic_chunk(x, 1000, 0.3, bonds=70, triples=60, sources=5)
    per_step = (work.MITOTIC_PAIR_OPS * pairs + work.BOND_OPS * 70 + work.BENDING_OPS * 60
                + work.SOURCE_OPS * 5 + work.UPDATE_OPS * 80)
    assert w.flops == per_step * 1000
    assert w.bytes == 4 * (3 * 80 * 1000 + 3 * 80 + 80 + 3 * 80)
    r = work.step_rest(100, 90, 4)
    assert r.bytes == work.STEP_REST_BYTES * 100
    assert r.flops == work.BOND_OPS * 94 + (work.WALL_OPS + work.UPDATE_OPS) * 100


def test_least_time_takes_the_larger_bound_and_knows_its_cards():
    card = "NVIDIA H100 80GB HBM3"
    assert work.least_seconds(work.Work(67e12, 1.0), card) == pytest.approx(1.0)
    assert work.least_seconds(work.Work(1.0, 3.35e12), card) == pytest.approx(1.0)
    assert work.least_seconds(work.Work(1.0, 1.0), "some other card") is None
