"""The A/B pair force of the port against the JAX package's Pallas kernel.

On the CPU the port's wrapper takes its plain version, which walks the same
cell layout the CUDA kernel walks; the JAX kernel runs in interpret mode.
Inputs are those of tests/test_pallas_kernel.py, made with numpy from a seed.
Tolerance: max|dF| <= 1e-4 * max(|F|, 1), that test's own limit (float32 sums
in another order); energies 1e-5 relative.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_cycle_tpu.ops import potentials as jpot
from genome_cycle_tpu.ops.dense_grid import DenseGrid
from genome_cycle_tpu.ops.pallas_kernels import (
    ab_pair_forces_pallas,
    build_padded_slab,
    forces_to_beads,
)
from genome_cycle_tpu_torch.ops import pair_kernels as pk
from genome_cycle_tpu_torch.ops.contact import contact_events
from genome_cycle_tpu_torch.ops import potentials as tpot
from genome_cycle_tpu_torch.ops.neighbor import pairwise_forces_dense
from genome_cycle_tpu_torch.utils import tracing

# The suite runs in several worker processes at once: one thread each keeps
# torch from oversubscribing the cores (sizes here are tiny).
torch.set_num_threads(1)


def _beads(n=300, seed=1234):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    af = rng.uniform(0, 1, n).astype(np.float32)
    return x, af, (1.0 - af).astype(np.float32)


def _kparams(core_scale):
    a_d, b_d = 0.3 * core_scale, 0.24 * core_scale
    pp = dict(a_energy=2.5, a_diameter=a_d, b_energy=2.5, b_diameter=b_d)
    return (2.5, 1 / (a_d * a_d), 2.5, 1 / (b_d * b_d)), pp


def _dense(x, af, bf, pp, with_energy=True):
    af, bf = torch.as_tensor(af), torch.as_tensor(bf)

    def coeff(r2, i, j):
        return tpot.ab_pair_force_coeff(r2, 0.5 * (af[i] + af[j]), 0.5 * (bf[i] + bf[j]), pp)

    def energy(r2, i, j):
        return tpot.ab_pair_energy(r2, 0.5 * (af[i] + af[j]), 0.5 * (bf[i] + bf[j]), pp)

    return pairwise_forces_dense(torch.as_tensor(x), coeff, energy if with_energy else None)


def _layout(x, af, bf, bound=1.2, cell=0.3):
    return pk.build_cell_layout(
        torch.as_tensor(x), torch.as_tensor(af), torch.as_tensor(bf), bound, cell
    )


def _assert_close(got, want):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= 1e-4 * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("core_scale", [0.5, 1.0])
def test_plain_version_matches_pallas_interpret(core_scale):
    x, af, bf = _beads()
    grid = DenseGrid.cubic(bound=1.2, cell_size=0.3, capacity=16)
    slab, ids, overflow, _ = build_padded_slab(
        grid, jnp.asarray(x), jnp.asarray(af), jnp.asarray(bf)
    )
    assert int(overflow) == 0
    kparams, _ = _kparams(core_scale)
    planes = ab_pair_forces_pallas(
        slab, jnp.asarray(kparams, jnp.float32), grid.dims, grid.capacity,
        jb=8, interpret=True,
    )
    f_jax = np.asarray(forces_to_beads(planes, ids, len(x)))
    assert np.abs(f_jax).max() > 1.0

    layout = _layout(x, af, bf)
    f_ref, _ = pk.ab_pair_forces_reference(layout, kparams)
    f_wrap, e_wrap = pk.ab_pair_forces(layout, kparams)     # CPU -> plain version
    _assert_close(f_ref, f_jax)
    assert torch.equal(f_ref, f_wrap) and float(e_wrap) == 0.0


@pytest.mark.parametrize("core_scale", [0.5, 1.0])
def test_plain_version_matches_dense_oracle_and_energy(core_scale):
    x, af, bf = _beads()
    kparams, pp = _kparams(core_scale)
    f, e = pk.ab_pair_forces(_layout(x, af, bf), kparams, with_energy=True)
    f_dense, e_dense = _dense(x, af, bf, pp)
    _assert_close(f, f_dense)
    assert float(e) == pytest.approx(float(e_dense), rel=1e-5)
    # The energy is the JAX package's ab_pair_energy summed over pairs i < j.
    i, j = np.triu_indices(len(x), 1)
    r2 = ((x[i] - x[j]) ** 2).sum(axis=1)
    u = jpot.ab_pair_energy(
        jnp.asarray(r2), jnp.asarray(0.5 * (af[i] + af[j])),
        jnp.asarray(0.5 * (bf[i] + bf[j])), pp,
    )
    assert float(e) == pytest.approx(float(np.asarray(u, np.float64).sum()), rel=1e-5)


def test_dense_oracle_matches_jax_dense():
    from genome_cycle_tpu.ops.neighbor import pairwise_forces_dense as jdense

    x, af, bf = _beads(150, seed=5)
    _, pp = _kparams(1.0)
    ja, jb = jnp.asarray(af), jnp.asarray(bf)
    fj, ej = jdense(
        jnp.asarray(x),
        lambda r2, i, j: jpot.ab_pair_force_coeff(r2, 0.5 * (ja[i] + ja[j]), 0.5 * (jb[i] + jb[j]), pp),
        lambda r2, i, j: jpot.ab_pair_energy(r2, 0.5 * (ja[i] + ja[j]), 0.5 * (jb[i] + jb[j]), pp),
    )
    ft, et = _dense(x, af, bf, pp)
    _assert_close(ft, fj)
    assert float(et) == pytest.approx(float(ej), rel=1e-5)
    # targets: only the listed beads interact, the others get no force.
    targets = np.asarray([3, 17, 40, 41, 99])
    fj, _ = jdense(
        jnp.asarray(x),
        lambda r2, i, j: jpot.softwell_force_coeff(r2, 0.3, 0.2, 6),
        targets=jnp.asarray(targets),
    )
    ft, _ = pairwise_forces_dense(
        torch.as_tensor(x), lambda r2, i, j: tpot.softwell_force_coeff(r2, 0.3, 0.2, 6),
        targets=torch.as_tensor(targets),
    )
    _assert_close(ft, fj)
    rest = np.setdiff1d(np.arange(len(x)), targets)
    assert not ft[rest].any()


def test_dense_oracle_row_blocks(monkeypatch):
    """Row-blocked evaluation gives what one block gives."""
    from genome_cycle_tpu_torch.ops import neighbor

    x, af, bf = _beads(130, seed=6)
    _, pp = _kparams(1.0)
    f_one, e_one = _dense(x, af, bf, pp)
    monkeypatch.setattr(neighbor, "_BLOCK_ELEMENTS", 130 * 7)
    f_blk, e_blk = _dense(x, af, bf, pp)
    _assert_close(f_blk, f_one)
    assert float(e_blk) == pytest.approx(float(e_one), rel=1e-6)


def test_boundary_cells():
    """Beads in the corner cells: clipped ranges, no phantom forces."""
    x = np.asarray(
        [[-1.15, -1.15, -1.15], [1.15, 1.15, 1.15], [1.15, -1.15, 1.15],
         [-1.1, -1.1, -1.1]], np.float32)
    af, bf = np.ones(4, np.float32), np.zeros(4, np.float32)
    kparams = (2.5, 1 / 0.09, 2.5, 1 / 0.0576)
    pp = dict(a_energy=2.5, a_diameter=0.3, b_energy=2.5, b_diameter=0.24)
    f, _ = pk.ab_pair_forces(_layout(x, af, bf), kparams)
    f_dense, _ = _dense(x, af, bf, pp, with_energy=False)
    np.testing.assert_allclose(f.numpy(), f_dense.numpy(), atol=1e-5)
    assert f[0].abs().max() > 0
    np.testing.assert_allclose(f[1].numpy(), 0.0, atol=1e-6)


def test_out_of_grid_beads_still_interact():
    """Beads beyond the grid are clipped into edge cells and keep their true
    coordinates (as tests/test_block_pairs.py checks for the JAX engine)."""
    x = np.asarray(
        [[1.95, 0.0, 0.0], [2.15, 0.0, 0.0], [-2.4, 0.0, 0.0], [-2.5, 0.1, 0.0],
         [5.0, 5.0, 5.0], [5.1, 5.0, 5.1]], np.float32)
    af, bf = np.ones(6, np.float32), np.zeros(6, np.float32)
    pp = dict(a_energy=2.0, a_diameter=0.4, b_energy=1.0, b_diameter=0.3)
    kparams = (2.0, 1 / 0.16, 1.0, 1 / 0.09)
    layout = _layout(x, af, bf, bound=2.0, cell=0.4)
    f, e = pk.ab_pair_forces(layout, kparams, with_energy=True)
    f_dense, e_dense = _dense(x, af, bf, pp)
    np.testing.assert_allclose(f.numpy(), f_dense.numpy(), atol=1e-5)
    assert float(e) == pytest.approx(float(e_dense), rel=1e-5)
    assert f[4].abs().max() > 0 and f[2].abs().max() > 0


@pytest.mark.parametrize("bound,cell", [(1.2, 0.3), (0.45, 0.3), (1.0, 0.37)])
def test_cell_layout_against_numpy_bincount(bound, cell):
    x, af, bf = _beads(500, seed=7)
    layout = _layout(x, af, bf, bound, cell)
    dims = max(int(np.ceil(2.0 * bound / cell)), 1)
    assert layout.dims == dims == pk.grid_dims(bound, cell)
    coords = np.clip(np.floor((x + np.float32(bound)) / np.float32(cell)).astype(np.int64), 0, dims - 1)
    flat = (coords[:, 0] * dims + coords[:, 1]) * dims + coords[:, 2]
    counts = np.bincount(flat, minlength=dims ** 3)
    start = np.concatenate([[0], np.cumsum(counts)])
    np.testing.assert_array_equal(layout.cell_start.numpy(), start)
    assert layout.cell_start.dtype == torch.int32 and layout.cell_id.dtype == torch.int32
    order = layout.order.numpy()
    assert sorted(order.tolist()) == list(range(len(x)))        # a permutation
    np.testing.assert_array_equal(layout.cell_id.numpy(), flat[order])
    assert (np.diff(layout.cell_id.numpy()) >= 0).all()
    np.testing.assert_array_equal(layout.xyz[:, :3].numpy(), x[order])
    assert not layout.xyz[:, 3].any()
    np.testing.assert_array_equal(layout.ab.numpy(), np.stack([af, bf], 1)[order])
    assert layout.xyz.is_contiguous() and layout.ab.is_contiguous()


@pytest.mark.parametrize("case", ["one system", "3 replicas stacked", "padded"])
def test_cell_layout_on_the_cpu_is_the_plain_version(case):
    """On a CPU tensor the layout's wrapper takes its plain version, field
    for field, launches nothing and keeps its ``layout`` span."""
    x, af, bf = _beads(600, seed=9)
    valid = None
    if case == "3 replicas stacked":
        x = np.stack([x, -x, x[::-1] * 1.5])
    elif case == "padded":
        valid = torch.as_tensor(np.arange(len(x)) < 450)
    args = (torch.as_tensor(x), torch.as_tensor(af), torch.as_tensor(bf), 1.2, 0.3)
    before = tracing.counters()
    tracing.start()
    try:
        layout = pk.build_cell_layout(*args, valid=valid)
        spans = tracing.snapshot()["spans"]
    finally:
        tracing.stop()
    want = pk.build_cell_layout_reference(*args, valid=valid)
    assert tracing.counters_since(before).get("launch.cell_layout", 0) == 0
    assert [(s["name"], s["calls"]) for s in spans] == [("layout", 1)]
    for field in pk.CellLayout._fields:
        got, ref = getattr(layout, field), getattr(want, field)
        assert torch.equal(got, ref) if torch.is_tensor(ref) else got == ref, field
    assert layout.padded == (valid is not None) and layout.replicas == x.size // x.shape[-1] // 600


def test_stencil_covers_each_pair_once():
    x, af, bf = _beads(400, seed=8)
    layout = _layout(x, af, bf)
    seen = []
    for start, count in pk.stencil_ranges(layout):
        for i, j in pk.expand_ranges(start, count, max_pairs=1000):
            seen.append(torch.stack([i, j], 1))
    seen = torch.cat(seen)
    assert len(torch.unique(seen, dim=0)) == len(seen)          # no pair twice
    assert len(seen) - layout.n == pk.candidate_pairs(layout)
    # Every pair closer than one cell is among the candidates.
    pos = layout.xyz[:, :3]
    d = torch.cdist(pos.double(), pos.double())
    close = torch.nonzero(d < 0.3)
    have = set(map(tuple, seen.tolist()))
    assert all(tuple(p) in have for p in close.tolist())


def test_wrapper_refuses_a_cell_smaller_than_the_cores():
    x, af, bf = _beads(50, seed=9)
    layout = _layout(x, af, bf, bound=1.2, cell=0.2)
    kparams, _ = _kparams(1.0)                                   # d_a = 0.3 > 0.2
    with pytest.raises(ValueError, match="cell edge"):
        pk.ab_pair_forces(layout, kparams)


def test_cpu_wrapper_counts_no_launch():
    x, af, bf = _beads(50, seed=10)
    before = tracing.counters().get("launch.ab_pair_forces", 0)
    pk.ab_pair_forces(_layout(x, af, bf), _kparams(1.0)[0])
    assert tracing.counters().get("launch.ab_pair_forces", 0) == before


def _padded_layout(n=400, real=300, seed=12):
    """A buffer of ``n`` rows of which ``real`` hold beads, the padding
    interleaved and all at one point inside the grid (where clipping would
    stack them at r = 0 from each other)."""
    x, af, bf = _beads(n, seed)
    rng = np.random.default_rng(seed)
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:real]] = True
    x[~valid] = x[0]
    layout = pk.build_cell_layout(torch.as_tensor(x), torch.as_tensor(af), torch.as_tensor(bf),
                                  1.2, 0.3, valid=torch.as_tensor(valid))
    return layout, (x, af, bf, valid)


@pytest.mark.parametrize("core_scale", [0.5, 1.0])
def test_padded_layout_and_home_range(core_scale):
    """Padded rows take part in no pair and no event and come back zero;
    the forces of a home range equal the same rows of a full launch, the
    rows outside it are zero; home ranges that tile the sorted order list
    every contact once between them."""
    layout, (x, af, bf, valid) = _padded_layout()
    kparams, _ = _kparams(core_scale)
    real = int(valid.sum())
    assert layout.padded and int(layout.cell_start[-1]) == real
    assert (layout.cell_id[real:] == layout.num_cells).all()
    assert (layout.cell_id[:real] < layout.num_cells).all()
    assert not valid[layout.order[real:].numpy()].any()
    unpadded = _layout(x[valid], af[valid], bf[valid])
    assert pk.candidate_pairs(layout) == pk.candidate_pairs(unpadded)
    assert pk.pairs_in_reach(layout, kparams) == pk.pairs_in_reach(unpadded, kparams)

    f, e = pk.ab_pair_forces(layout, kparams, per_bead=True)
    f_ref, e_ref = pk.ab_pair_forces(unpadded, kparams, per_bead=True)
    assert not f[~valid].any() and not e[~valid].any()
    _assert_close(f[valid], f_ref)
    assert float(e.sum()) == pytest.approx(float(e_ref.sum()), rel=1e-5)

    ids = np.flatnonzero(valid)
    want = contact_events(unpadded, 0.24 * core_scale)
    got = contact_events(layout, 0.24 * core_scale)
    want = {(int(ids[i]), int(ids[j])) for i, j, _ in want.tolist()}
    assert {(i, j) for i, j, _ in got.tolist()} == want and want
    tiles = [contact_events(layout, 0.24 * core_scale, b, b + 97) for b in range(0, layout.n, 97)]
    rows = [(i, j) for t in tiles for i, j, _ in t.tolist()]
    assert len(rows) == len(want) and set(rows) == want

    for begin, end in ((0, 120), (50, real), (200, layout.n), (real, layout.n)):
        f_h, e_h = pk.ab_pair_forces(layout, kparams, begin=begin, end=end, per_bead=True)
        home = layout.order[begin:min(end, real)]
        outside = torch.ones(layout.n, dtype=torch.bool)
        outside[home] = False
        assert not f_h[outside].any() and not e_h[outside].any()
        assert torch.equal(f_h[home], f[home]) and torch.equal(e_h[home], e[home])
    f_h, e_h = pk.ab_pair_forces(layout, kparams, with_energy=True, begin=50, end=real)
    assert float(e_h) == pytest.approx(float(e[layout.order[50:real]].sum()), rel=1e-6)


def _overfull_cell(dense=600, spread=100, seed=21):
    """One cell ([0, 0.3)^3 of the grid over [-1.2, 1.2]^3) that holds more
    beads than a block owns and more than one tile of candidates, beside
    spread beads that leave the grid's upper corner empty."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        rng.uniform(0.02, 0.27, (dense, 3)), rng.uniform(-1.1, 0.85, (spread, 3)),
    ]).astype(np.float32)
    af = rng.uniform(0, 1, len(x)).astype(np.float32)
    return x, af, (1.0 - af).astype(np.float32)


@pytest.mark.parametrize("core_scale", [0.5, 1.0])
def test_early_rejection_is_value_neutral(core_scale):
    """Dropping the candidates beyond the larger core diameter before the
    softcore terms changes no bit of the forces or the energy: every term
    dropped is exactly zero."""
    x, af, bf = _beads()
    layout = _layout(x, af, bf)
    kparams, _ = _kparams(core_scale)
    e_a, inv_da2, e_b, inv_db2 = kparams
    pos, a, b = layout.xyz[:, :3], layout.ab[:, 0], layout.ab[:, 1]
    dropped = kept = 0
    for start, count in pk.stencil_ranges(layout):
        for i, j in pk.expand_ranges(start, count):
            dx = pos[i] - pos[j]
            r2 = torch.sum(dx * dx, dim=-1)
            out = ~pk.in_reach(r2, inv_da2, inv_db2)
            i, j, r2 = i[out], j[out], r2[out]
            # The plain version's terms, for the candidates out of reach.
            a_mix, b_mix = 0.5 * (a[i] + a[j]), 0.5 * (b[i] + b[j])
            core_a = torch.clamp(1.0 - r2 * inv_da2, min=0.0)
            s_b = r2 * inv_db2
            core_b = torch.clamp(1.0 - s_b ** 4, min=0.0)
            coeff = (a_mix * (6.0 * e_a * inv_da2) * core_a ** 2
                     + b_mix * (24.0 * e_b * inv_db2) * s_b ** 3 * core_b ** 2)
            u = a_mix * e_a * core_a ** 3 + b_mix * e_b * core_b ** 3
            assert not coeff.any() and not u.any()
            dropped += len(i)
            kept += len(out) - len(i)
    f_all, _ = pk.ab_pair_forces_reference(layout, kparams)
    assert f_all.abs().max() > 1.0
    # And the test does drop most of them.
    assert kept - layout.n == pk.pairs_in_reach(layout, kparams)
    assert dropped > kept and dropped + kept - layout.n == pk.candidate_pairs(layout)


def test_in_reach_is_exactly_where_a_core_is_positive():
    """At squared distances around both diameters, to the last bit."""
    inv_da2, inv_db2 = np.float32(1 / 0.09), np.float32(1 / 0.0576)
    centre = np.asarray([0.0576, 0.09], np.float32)
    r2 = np.concatenate([
        np.nextafter(centre, np.float32(0.0)), np.nextafter(centre, np.float32(1.0)),
        centre, np.linspace(0.0, 0.2, 4001, dtype=np.float32),
    ]).astype(np.float32)
    r2 = torch.as_tensor(r2)
    core_a = torch.clamp(1.0 - r2 * float(inv_da2), min=0.0)
    core_b = torch.clamp(1.0 - (r2 * float(inv_db2)) ** 4, min=0.0)
    reach = pk.in_reach(r2, float(inv_da2), float(inv_db2))
    assert torch.equal(reach, (core_a > 0) | (core_b > 0))
    assert reach.any() and not reach.all()


@pytest.mark.parametrize("core_scale", [0.5, 1.0])
def test_pairs_in_reach_against_numpy(core_scale):
    x, af, bf = _beads(400, seed=8)
    kparams, _ = _kparams(core_scale)
    d2 = ((x[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1)
    reach2 = (0.3 * core_scale) ** 2
    edge = np.abs(d2 - reach2) < 1e-6            # either way in float32
    want = int((d2 < reach2).sum()) - len(x)
    got = pk.pairs_in_reach(_layout(x, af, bf), kparams)
    assert abs(got - want) <= int(edge.sum())
    assert 0 < got < pk.candidate_pairs(_layout(x, af, bf))


def _kernel_constants():
    """The compile-time constants of the CUDA kernel as its source sets them."""
    source = pathlib.Path(pk.__file__).resolve().parent.parent / "csrc" / "ab_pair_forces.cu"
    text = source.read_text()
    return tuple(
        int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
        for name in ("kBlock", "kLanes", "kTile", "kWiden")
    )


def _kernel_work_split(layout, threads, lanes, tile, widen, home_begin=0, home_end=None):
    """Pure-Python model of ab_pair_forces_cell_kernel's work split: every
    (i, j) a thread evaluates, from block to run of sorted beads to home-cell
    segment, through the nine stencil ranges cut into tiles, each bead's
    lanes striding through a tile, the bead itself left out.

    It is a transcript of the kernel's control flow, not a check of the
    kernel: edit the two together.  (The kernel's other two constants, the
    unrolling and the blocks an SM must hold, do not enter the split; the
    card tests hold the kernel itself against the plain version on the same
    three inputs.)"""
    n, d = layout.n, layout.dims
    cell_id, starts = layout.cell_id.tolist(), layout.cell_start.tolist()
    run = threads // lanes
    pairs = []
    home_end = n if home_end is None else home_end
    rows_end = min(home_end, starts[layout.num_cells])     # padded rows sort last
    for block in range(-(-(home_end - home_begin) // run)):
        run_begin = home_begin + block * run
        run_end = min(rows_end, run_begin + run)
        seg_begin = run_begin
        while seg_begin < run_end:
            c = cell_id[seg_begin]
            seg_end = min(run_end, starts[c + 1])
            beads = seg_end - seg_begin
            cz, cy, cx = c % d, (c // d) % d, c // (d * d)
            begin, length = [0] * 9, [0] * 9
            for r in range(9):
                x, y = cx + r // 3 - 1, cy + r % 3 - 1
                if 0 <= x < d and 0 <= y < d:
                    column = (x * d + y) * d
                    begin[r] = starts[column + max(cz - 1, 0)]
                    length[r] = starts[column + min(cz + 1, d - 1) + 1] - begin[r]
            prefix = [sum(length[:r]) for r in range(10)]
            total = prefix[9]
            shift = lanes.bit_length() - 1
            while widen and shift < 5 and (beads << (shift + 1)) <= threads:
                shift += 1
            width = 1 << shift
            for t in range(-(-total // tile)):
                base = t * tile
                size = min(tile, total - base)
                staged = []
                for k in range(size):
                    v = base + k
                    r = sum(v >= prefix[q] for q in range(1, 9))
                    staged.append(begin[r] + v - prefix[r])
                for tid in range(threads):
                    bead, lane = tid >> shift, tid & (width - 1)
                    if bead >= beads:
                        continue
                    i = seg_begin + bead
                    self_here = prefix[4] + (i - begin[4]) - base
                    pairs += [(i, staged[v]) for v in range(lane, size, width) if v != self_here]
            seg_begin = seg_end
    return pairs


@pytest.mark.parametrize("constants", ["as built", (64, 4, 16, 1), (32, 32, 8, 0), (64, 1, 40, 0)])
@pytest.mark.parametrize("case", ["overfull cell", "single-cell grid", "one bead",
                                  "padded, home range"])
def test_kernel_work_split_covers_each_pair_once(case, constants):
    threads, lanes, tile, widen = _kernel_constants() if constants == "as built" else constants
    begin, end = 0, None
    if case == "overfull cell":
        x, af, bf = _overfull_cell()
        layout = _layout(x, af, bf)
        counts = np.diff(layout.cell_start.numpy())
        assert counts.max() > threads // lanes and counts.max() > tile
        assert counts[-1] == 0 and layout.num_cells == 512           # empty corner
    elif case == "single-cell grid":
        rng = np.random.default_rng(22)
        x = rng.uniform(-0.1, 0.1, (150, 3)).astype(np.float32)
        layout = _layout(x, np.ones(150, np.float32), np.zeros(150, np.float32), bound=0.1)
        assert layout.num_cells == 1
    elif case == "one bead":
        layout = _layout(np.zeros((1, 3), np.float32), np.ones(1, np.float32),
                         np.zeros(1, np.float32))
    else:
        layout, _ = _padded_layout()
        begin, end = 40, layout.n        # ends inside the padding
    real = int(layout.cell_start[-1])
    want = []
    for start, count in pk.stencil_ranges(layout):
        for i, j in pk.expand_ranges(start, count):
            keep = (i != j) & (i >= begin) & (i < min(end or real, real))
            want += list(zip(i[keep].tolist(), j[keep].tolist()))
    got = _kernel_work_split(layout, threads, lanes, tile, widen, begin, end)
    if case == "padded, home range":
        assert want and all(j < real for _, j in got)        # no padded row is a neighbour
    else:
        assert len(got) == len(want) == pk.candidate_pairs(layout)
    assert sorted(got) == sorted(want)
    assert len(set(got)) == len(got)
