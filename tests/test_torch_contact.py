"""Contact tick and window accumulator of the port against the JAX package.

Pairs are compared as sets (the two searches list them in other orders);
accumulator rows are compared exactly: integer ids and counts, and both sides
sort by the key i << 32 | j.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from genome_cycle_tpu.ops import contact as jcontact
from genome_cycle_tpu.ops.block_pairs import BlockGrid, block_contact_events
from genome_cycle_tpu_torch.ops import contact as tcontact
from genome_cycle_tpu_torch.ops.pair_kernels import build_cell_layout

# The suite runs in several worker processes at once: one thread each keeps
# torch from oversubscribing the cores (sizes here are tiny).
torch.set_num_threads(1)

PAD = np.iinfo(np.int32).max


def _positions(n=700, seed=0, half=1.0):
    return np.random.default_rng(seed).uniform(-half, half, (n, 3)).astype(np.float32)


def _layout(x, bound=1.5, cell=0.3):
    zeros = torch.zeros(len(x))
    return build_cell_layout(torch.as_tensor(x), zeros, zeros, bound, cell)


def _pairs(events):
    ev = np.asarray(events)
    ev = ev[ev[:, 0] >= 0]
    lo, hi = np.minimum(ev[:, 0], ev[:, 1]), np.maximum(ev[:, 0], ev[:, 1])
    return sorted(zip(lo.tolist(), hi.tolist()))


@pytest.mark.parametrize("cutoff", [0.12, 0.24, 0.28])
def test_tick_pairs_match_block_engine_and_kdtree(cutoff):
    x = _positions()
    events = tcontact.contact_events(_layout(x), cutoff)
    assert events.dtype == torch.int32 and events.shape[1] == 3
    ev = events.numpy()
    assert (ev[:, 0] < ev[:, 1]).all() and (ev[:, 2] == 1).all()
    got = _pairs(ev)
    assert len(set(got)) == len(got)                      # each pair exactly once

    grid = BlockGrid.cubic(bound=1.5, cell_size=0.3, width=512, block=128)
    jev, n_events, width_ov, _ = block_contact_events(grid, jnp.asarray(x), cutoff, 16384)
    assert int(width_ov) == 0 and int(n_events) <= 16384
    assert got == _pairs(jev)

    tree = cKDTree(x.astype(np.float64))
    d = np.linalg.norm(x[:, None].astype(np.float64) - x[None].astype(np.float64), axis=-1)
    want = sorted(tree.query_pairs(cutoff))
    # Pairs within float32 rounding of the cutoff may fall either way.
    edge = {(i, j) for i, j in set(want) ^ set(got) if abs(d[i, j] - cutoff) < 1e-6}
    assert set(want) ^ set(got) == edge


def test_tick_pairs_with_clipped_beads_and_small_piece_size(monkeypatch):
    x = _positions(400, seed=1, half=1.3)                 # some beyond bound 1.0
    layout = _layout(x, bound=1.0)
    want = sorted(cKDTree(x.astype(np.float64)).query_pairs(0.25))
    assert _pairs(tcontact.contact_events(layout, 0.25).numpy()) == want
    import functools
    from genome_cycle_tpu_torch.ops import pair_kernels
    monkeypatch.setattr(
        tcontact, "expand_ranges",
        functools.partial(pair_kernels.expand_ranges, max_pairs=257),
    )
    assert _pairs(tcontact.contact_events(layout, 0.25).numpy()) == want


def test_tick_refuses_a_cutoff_beyond_the_cell():
    with pytest.raises(ValueError, match="cell edge"):
        tcontact.contact_events(_layout(_positions(50)), 0.31)


def test_no_contacts_gives_an_empty_event_list():
    x = np.asarray([[0, 0, 0], [1, 1, 1]], np.float32)
    events = tcontact.contact_events(_layout(x), 0.2)
    assert events.shape == (0, 3)
    acc, n = tcontact.empty_window_acc(8)
    acc, n, ov = tcontact.merge_events_acc(acc, n, events)
    assert n == 0 and ov == 0 and (acc[:, 2] == 0).all()


def _tick_events(n_ticks=4, n=300, seed=2):
    rng = np.random.default_rng(seed)
    x = _positions(n, seed, half=0.7)
    ticks = []
    for _ in range(n_ticks):
        x = x + rng.normal(0, 0.02, x.shape).astype(np.float32)
        ticks.append(tcontact.contact_events(_layout(x), 0.24))
    return ticks


def test_merge_events_acc_rows_equal_jax_and_merge_window():
    ticks = _tick_events()
    cap = 8192
    acc_t, n_t = tcontact.empty_window_acc(cap)
    acc_j, n_j = jcontact.empty_window_acc(cap)
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    for ev in ticks:
        # Flip half the rows: events may own either end of the pair.
        flipped = ev.clone()
        flipped[::2, 0], flipped[::2, 1] = ev[::2, 1], ev[::2, 0]
        acc_t, n_t, ov_t = tcontact.merge_events_acc(acc_t, n_t, flipped)
        acc_j, n_j, ov_j = jcontact.merge_events_acc(acc_j, n_j, jnp.asarray(flipped.numpy()))
        assert ov_t == 0 and int(ov_j) == 0
    assert n_t == int(n_j)
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    assert (acc_t[n_t:, :2] == PAD).all() and (acc_t[n_t:, 2] == 0).all()

    for host_merge, to_host in (
        (tcontact.merge_window, tcontact.events_to_host),
        (jcontact.merge_window, lambda ev: jcontact.events_to_host(ev.numpy())),
    ):
        coo = host_merge([to_host(ev) for ev in ticks])
        np.testing.assert_array_equal(acc_t[:n_t].numpy(), coo)
    coo = acc_t[:n_t].numpy().astype(np.int64)
    assert (np.diff((coo[:, 0] << 32) | coo[:, 1]) > 0).all()
    assert coo[:, 2].sum() == sum(len(ev) for ev in ticks)
    assert coo[:, 2].max() > 1                            # repeated contacts summed


def test_merge_ignores_padding_rows():
    ev = torch.tensor([[3, 1, 1], [-1, -1, 0], [1, 3, 2], [0, 2, 1]], dtype=torch.int32)
    acc, n = tcontact.empty_window_acc(4)
    acc, n, ov = tcontact.merge_events_acc(acc, n, ev)
    assert (n, ov) == (2, 0)
    np.testing.assert_array_equal(acc[:2].numpy(), [[0, 2, 1], [1, 3, 3]])
    i, j, w = tcontact.events_to_host(ev)
    np.testing.assert_array_equal(np.stack([i, j, w], 1), [[1, 3, 1], [1, 3, 2], [0, 2, 1]])


def test_accumulator_overflow_grows_and_remerges_without_loss():
    ticks = _tick_events()
    want = tcontact.merge_window([tcontact.events_to_host(ev) for ev in ticks])
    cap = 64
    assert len(want) > cap
    acc, n = tcontact.empty_window_acc(cap)
    grown = 0
    for ev in ticks:
        while True:
            acc2, n2, ov = tcontact.merge_events_acc(acc, n, ev)
            if ov > 0:
                # Truncated, never mutated: same overflow as the JAX merge.
                _, _, ov_j = jcontact.merge_events_acc(
                    jnp.asarray(acc.numpy()), jnp.asarray(n, jnp.int32), jnp.asarray(ev.numpy())
                )
                assert ov == int(ov_j) and n2 == cap
                cap = cap + ov
                pad, _ = tcontact.empty_window_acc(cap)
                acc = torch.cat([acc, pad[acc.shape[0]:]])
                grown += 1
                continue
            acc, n = acc2, n2
            break
    assert grown >= 1
    np.testing.assert_array_equal(acc[:n].numpy(), want)
