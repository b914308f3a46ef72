"""The port's analysis chain against the JAX package's, on the CPU.

Each test of tests/test_analysis.py has a counterpart here that feeds the
same seeded inputs through the JAX function and the port's (``device="cpu"``)
and compares what comes out.  Then come the places where torch can silently
differ from numpy, one test each, and the whole chain ``cool -> dephase ->
pc1 -> dumpgsd`` through both CLIs on a trajectory the port wrote.

Tolerances:
- merged pixels, counts, bins, projections, dense raw maps, GSD bytes and
  host-side copies: equal;
- ICE weights: relative 1e-9 when both take the same number of rounds (sums
  of float64 in another order), 1e-5 otherwise (a round apart at the stopping
  test, tol 1e-5);
- O/E expected: cis profile relative 1e-6 (float64 sums cast to float32),
  trans mean relative 1e-6 (the JAX package sums float32 values in float32);
- PC1 and ev1: sign-aligned, absolute 1e-4 of a unit vector's entries and of
  PC1's; explained-variance ratio relative 1e-4 (the port iterates in
  float32, the JAX package in float64); power-iteration steps equal or one
  apart.
"""

import json

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from genome_cycle_tpu.analysis import annotate as j_annotate
from genome_cycle_tpu.analysis import cool as j_cool
from genome_cycle_tpu.analysis import coolio as j_coolio
from genome_cycle_tpu.analysis import cyto as j_cyto
from genome_cycle_tpu.analysis import dephase as j_dephase
from genome_cycle_tpu.analysis import dumpgsd as j_dumpgsd
from genome_cycle_tpu.analysis import gsdio as j_gsdio
from genome_cycle_tpu.analysis import nci as j_nci
from genome_cycle_tpu.analysis import pc1 as j_pc1
from genome_cycle_tpu_torch.analysis import annotate as t_annotate
from genome_cycle_tpu_torch.analysis import cool as t_cool
from genome_cycle_tpu_torch.analysis import coolio as t_coolio
from genome_cycle_tpu_torch.analysis import cyto as t_cyto
from genome_cycle_tpu_torch.analysis import dephase as t_dephase
from genome_cycle_tpu_torch.analysis import dumpgsd as t_dumpgsd
from genome_cycle_tpu_torch.analysis import gsdio as t_gsdio
from genome_cycle_tpu_torch.analysis import nci as t_nci
from genome_cycle_tpu_torch.analysis import pc1 as t_pc1

torch.set_num_threads(1)

CPU = "cpu"
WEIGHT_RTOL_SAME_ROUNDS = 1e-9
WEIGHT_RTOL = 1e-5
PC_ATOL = 1e-4
EVR_RTOL = 1e-4


def make_bins(chroms):
    rows = []
    for chrom, n in chroms:
        for i in range(n):
            rows.append((chrom, i * 100, (i + 1) * 100))
    return pd.DataFrame(rows, columns=["chrom", "start", "end"])


def cool_contents(path):
    """Every dataset and attribute of a .cool file but the two that name
    the writer and the time."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, node: out.__setitem__(name, node[()])
                     if isinstance(node, h5py.Dataset) else None)
        attrs = {k: v for k, v in f.attrs.items() if k not in ("generated-by", "creation-date")}
    return out, attrs


def assert_same_cool(a, b, weights_rtol=None):
    da, attrs_a = cool_contents(a)
    db, attrs_b = cool_contents(b)
    assert da.keys() == db.keys()
    for name in da:
        if name == "bins/weight" and weights_rtol is not None:
            np.testing.assert_allclose(da[name], db[name], rtol=weights_rtol, equal_nan=True)
            continue
        assert np.asarray(da[name]).dtype == np.asarray(db[name]).dtype, name
        np.testing.assert_array_equal(da[name], db[name], err_msg=name)
    assert attrs_a.keys() == attrs_b.keys()
    for key in attrs_a:
        assert attrs_a[key] == attrs_b[key], key
        assert type(attrs_a[key]) is type(attrs_b[key]), key


def write_both(tmp_path, bins, pixels, name="m"):
    j_path, t_path = str(tmp_path / f"{name}_jax.cool"), str(tmp_path / f"{name}_port.cool")
    j_coolio.create_cooler(j_path, bins, iter(pixels))
    t_coolio.create_cooler(t_path, bins, iter(pixels), device=CPU)
    return j_path, t_path


def sign_aligned(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ok = np.isfinite(want)
    return got if np.dot(got[ok], want[ok]) >= 0 else -got


# -- counterparts of tests/test_analysis.py ---------------------------------


def test_cool_round_trip_matches_jax(tmp_path):
    bins = make_bins([("chr1:a", 5), ("chr2:a", 3)])
    pixels = [
        {"bin1_id": [0, 0, 1], "bin2_id": [1, 2, 1], "count": [3, 2, 7]},
        {"bin1_id": [1, 6], "bin2_id": [0, 7], "count": [1, 5]},  # dup (0,1) via (1,0)
    ]
    j_path, t_path = write_both(tmp_path, bins, pixels)
    assert_same_cool(t_path, j_path)
    clr, jclr = t_coolio.Cooler(t_path), j_coolio.Cooler(j_path)
    assert clr.chromnames == jclr.chromnames and clr.extent("chr2:a") == (5, 8)
    mat = clr.matrix(balance=False, device=CPU)[:, :]
    assert mat.dtype == torch.float64
    np.testing.assert_array_equal(mat.numpy(), jclr.matrix(balance=False)[:, :])
    assert mat[0, 1] == 4 and mat[1, 1] == 7
    for rows, cols in ((slice(0, 3), slice(5, 8)), (slice(5, 8), slice(0, 3)), (1, slice(None))):
        np.testing.assert_array_equal(
            clr.matrix(balance=False, device=CPU)[rows, cols].numpy(),
            jclr.matrix(balance=False)[rows, cols])


def _biased_counts(rng, n=20):
    bias = rng.uniform(0.2, 3.0, n)
    base = rng.poisson(40, size=(n, n)) + 1
    counts = np.triu((base + base.T) * np.outer(bias, bias), 0).astype(int)
    iu, ju = np.nonzero(counts)
    return [{"bin1_id": iu, "bin2_id": ju, "count": counts[iu, ju]}]


def test_balance_matches_jax_and_has_unit_marginals(tmp_path, rng):
    bins = make_bins([("chr1:a", 20)])
    j_path, t_path = write_both(tmp_path, bins, _biased_counts(rng))
    want = j_coolio.balance_cooler(j_coolio.Cooler(j_path), store=True)
    got = t_coolio.balance_cooler(t_coolio.Cooler(t_path), store=True, device=CPU)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=WEIGHT_RTOL_SAME_ROUNDS)
    assert_same_cool(t_path, j_path, weights_rtol=WEIGHT_RTOL_SAME_ROUNDS)
    mat = t_coolio.Cooler(t_path).matrix(balance=True, device=CPU)[:, :]
    marg = torch.nansum(mat, 0).numpy()
    assert marg.std() / marg.mean() < 0.01
    assert marg.mean() == pytest.approx(1.0, rel=0.05)


def test_nci_matches_jax(tmp_path):
    n = 6
    mat = np.zeros((n, n), int)
    for i, d in enumerate([4, 9, 16, 25, 36, 49]):
        mat[i, i] = d
    for i, s in enumerate([6, 12, 20, 30, 42]):
        mat[i, i + 1] = s
    iu, ju = np.triu_indices(n)
    sel = mat[iu, ju] > 0
    pixels = [{"bin1_id": iu[sel], "bin2_id": ju[sel], "count": mat[iu, ju][sel]}]
    j_path, t_path = write_both(tmp_path, make_bins([("chr1", n)]), pixels)
    clr, jclr = t_coolio.Cooler(t_path), j_coolio.Cooler(j_path)
    for got, want in zip(t_nci.extract_diagonals(clr, 0, n), j_nci.extract_diagonals(jclr, 0, n)):
        np.testing.assert_array_equal(got, want)
    d, s = t_nci.extract_diagonals(clr, 0, n)
    np.testing.assert_array_equal(t_nci.nci_scores(d, s), j_nci.nci_scores(d, s))
    for halve in (False, True):
        pd.testing.assert_frame_equal(t_nci.make_nci_track(clr, "chr1", halve=halve),
                                      j_nci.make_nci_track(jclr, "chr1", halve=halve))
    out_t, out_j = tmp_path / "nci_t.tsv", tmp_path / "nci_j.tsv"
    t_nci.main(cool=t_path, output=str(out_t))
    j_nci.main(cool=j_path, output=str(out_j))
    assert out_t.read_bytes() == out_j.read_bytes()


def test_power_iteration_matches_jax(rng):
    data = rng.normal(size=(40, 15))
    want, want_steps, want_delta = j_pc1.leading_singular_vector(data, tol=1e-10, max_iters=5000)
    got, steps, delta = t_pc1.leading_singular_vector(
        torch.as_tensor(data), tol=1e-10, max_iters=5000)
    assert abs(steps - want_steps) <= 1 and delta < 1e-10
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9)
    _, _, vt = np.linalg.svd(data, full_matrices=False)
    assert abs(float(np.dot(got.numpy(), vt[0]))) == pytest.approx(1.0, abs=1e-6)


def test_power_iteration_leaves_out_rows_with_nan_as_jax_does(rng):
    data = rng.normal(size=(30, 8))
    data[[3, 17], [2, 5]] = np.nan
    want, want_steps, _ = j_pc1.leading_singular_vector(data, tol=1e-10)
    got, steps, _ = t_pc1.leading_singular_vector(torch.as_tensor(data), tol=1e-10)
    assert abs(steps - want_steps) <= 1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9)


def _checkerboard(rng, n=60):
    comp = np.where((np.arange(n) // 6) % 2 == 0, 1.0, -1.0)
    base = np.exp(-np.abs(np.subtract.outer(np.arange(n), np.arange(n))) / 10.0)
    mat = base * (1 + 0.4 * np.outer(comp, comp))
    mat += rng.normal(0, 0.01, (n, n))
    return ((mat + mat.T) / 2 * 1000).astype(np.float32), comp


def _both_pc1(mat, ranges, **kwargs):
    want = j_pc1.compute_pc1(mat.copy(), ranges, **kwargs)
    timings = {}
    got = t_pc1.compute_pc1(torch.as_tensor(mat.copy()), ranges, timings=timings, **kwargs)
    return got, want, timings


def _assert_pc1_close(got, want):
    pc1, ev1, evr, expected = got
    w_pc1, w_ev1, w_evr, w_expected = want
    np.testing.assert_array_equal(np.isnan(ev1.numpy()), np.isnan(w_ev1))
    np.testing.assert_allclose(sign_aligned(ev1.numpy(), w_ev1), w_ev1, atol=PC_ATOL)
    np.testing.assert_allclose(sign_aligned(pc1.numpy(), w_pc1), w_pc1, atol=PC_ATOL)
    assert evr == pytest.approx(w_evr, rel=EVR_RTOL)
    np.testing.assert_allclose(expected.cis_by_separation.numpy(),
                               w_expected.cis_by_separation, rtol=1e-6)
    assert expected.trans_mean == pytest.approx(w_expected.trans_mean, rel=1e-6, nan_ok=True)


def test_pc1_matches_jax_and_recovers_compartments(rng):
    mat, comp = _checkerboard(rng)
    got, want, timings = _both_pc1(mat, {"chr1": (0, 60)}, svd_tolerance=1e-8)
    _assert_pc1_close(got, want)
    pc1, _, evr, _ = got
    assert abs(np.corrcoef(pc1.numpy(), comp)[0, 1]) > 0.95
    assert 0 < evr <= 1 and float(torch.var(pc1, unbiased=False)) == pytest.approx(evr, rel=1e-3)
    assert timings["kept"] == 60 and timings["power_steps"] >= 1


def test_pc1_two_chromosomes_with_trans_and_options_match_jax(rng):
    mat, _ = _checkerboard(rng, 60)
    mat[:30, 30:] *= 0.05
    mat[30:, :30] *= 0.05
    mat[7, :] = mat[:, 7] = np.nan
    ranges = {"chr1": (0, 30), "chr2": (30, 60)}
    for kwargs in ({}, {"mask_intra": True}, {"use_covariance": True}):
        got, want, _ = _both_pc1(mat, ranges, svd_tolerance=1e-7, **kwargs)
        _assert_pc1_close(got, want)


def test_dephase_mapping_matches_jax():
    bins = make_bins([("chr1:a", 4), ("chr1:b", 4), ("chr2:a", 2), ("nucleoli", 3), ("odd", 2)])
    for got, want in zip(t_dephase.split_chain_names(bins["chrom"]),
                         j_dephase.split_chain_names(bins["chrom"])):
        pd.testing.assert_series_equal(got, want)
    out_bins, projection = t_dephase.project_bins(bins)
    want_bins, want_projection = j_dephase.project_bins(bins)
    pd.testing.assert_frame_equal(out_bins, want_bins)
    np.testing.assert_array_equal(projection, want_projection)
    assert projection[[0, 5, 8, 9, 11]].tolist() == [0, 1, 4, 5, -1]


def test_annotate_typing_matches_jax():
    none = int(t_cyto.CytoCat.NONE)
    z = np.asarray([2.0, -2.0, 0.2, np.nan, np.nan, np.nan, np.nan])
    cats = np.asarray([none, none, none, int(t_cyto.CytoCat.CEN), int(t_cyto.CytoCat.NOR),
                       int(t_cyto.CytoCat.NOR), none])
    for activate in (True, False):
        types = t_annotate.classify_beads(z, cats, activate_nor=activate, tristate=0.5)
        want = j_annotate.classify_beads(z, cats, activate_nor=activate, tristate=0.5)
        np.testing.assert_array_equal(types, want)
        np.testing.assert_array_equal(t_annotate.compose_tags(cats, types, activate),
                                      j_annotate.compose_tags(cats, want, activate))


def test_diploid_chain_design_matches_jax():
    for chroms, active in ((["chr1", "chr2", "chrX"], ["chr2:a"]), (["chr1", "chrX", "chrY"], [])):
        got = t_annotate.plan_diploid_chains(chroms, active)
        want = j_annotate.plan_diploid_chains(chroms, active)
        assert [tuple(c) for c in got] == [tuple(c) for c in want]


def _annotate_inputs(tmp_path):
    rows = [("chr1", i * 100, (i + 1) * 100, 3.0 if i < 6 else -3.0) for i in range(12)]
    rows += [("chr2", i * 100, (i + 1) * 100, np.nan) for i in range(6)]
    nci_path = tmp_path / "nci.tsv"
    pd.DataFrame(rows, columns=["chrom", "start", "end", "score"]).to_csv(
        nci_path, sep="\t", index=False)
    band_path = tmp_path / "bands.tsv"
    pd.DataFrame({"chrom": ["chr1", "chr2", "chr2"], "start": [0, 0, 200],
                  "end": [1200, 200, 600], "name": ["q", "p", "q"],
                  "stain": ["gneg", "stalk", "gneg"]}).to_csv(
        band_path, sep="\t", index=False, header=False)
    return str(nci_path), str(band_path)


def test_annotate_end_to_end_writes_what_jax_writes(tmp_path):
    nci_path, band_path = _annotate_inputs(tmp_path)
    for module, name in ((t_annotate, "port.tsv"), (j_annotate, "jax.tsv")):
        module.main(tristate=0.5, activate_nor=["chr2:a"], output_filename=str(tmp_path / name),
                    nci_filename=nci_path, band_filename=band_path)
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()
    table = pd.read_csv(tmp_path / "port.tsv", sep="\t")
    assert list(table["chain"].unique()) == ["chr1:a", "chr2:a", "chr1:b", "chr2:b"]


def test_normalizer_median_mad_matches_jax():
    for vals in ([1.0, 2.0, 3.0, 4.0, 100.0], [1.0, 2.0, 3.0, 4.0], [np.nan, 2.0, 5.0]):
        assert t_annotate.mad_normalizer(np.asarray(vals)) == j_annotate.mad_normalizer(
            np.asarray(vals))


def test_cyto_categories_match_jax():
    nci = pd.DataFrame({"chrom": ["chr1"] * 5, "start": [0, 100, 200, 300, 400],
                        "end": [100, 200, 300, 400, 500], "score": [1.0] * 5})
    bands = pd.DataFrame({"chrom": ["chr1"] * 3, "start": [0, 200, 300],
                          "end": [200, 300, 500], "name": ["p1", "p2", "q1"],
                          "stain": ["stalk", "acen", "gpos50"]})
    got = t_cyto.attach_cyto_category(nci, bands)
    want = j_cyto.attach_cyto_category(nci, bands)
    assert got["cat"].tolist() == [int(c) for c in want["cat"]]
    assert [int(c) for c in t_cyto.do_extend_nor(got)["cat"]] == [
        int(c) for c in j_cyto.do_extend_nor(want)["cat"]]


def _gsd_frames(module, path, rng):
    with module.GSDWriter(path) as w:
        for step, pos in [(0, rng.normal(size=(7, 3)).astype(np.float32)),
                          (1000, rng.normal(size=(7, 3)).astype(np.float32))]:
            module.write_hoomd_frame(
                w, step=step, box=(100, 100, 100, 0, 0, 0), positions=pos,
                type_ids=np.arange(7) % 2, type_names=["arm", "kinetochore"],
                bond_pairs=np.asarray([[0, 1], [1, 2]]), bond_type_ids=[0, 0],
                bond_type_names=["chrom"])


def test_gsd_round_trip_writes_jax_bytes(tmp_path):
    port, jax_ = str(tmp_path / "p.gsd"), str(tmp_path / "j.gsd")
    _gsd_frames(t_gsdio, port, np.random.default_rng(5))
    _gsd_frames(j_gsdio, jax_, np.random.default_rng(5))
    assert open(port, "rb").read() == open(jax_, "rb").read()
    with t_gsdio.GSDReader(jax_) as r:
        assert r.schema == "hoomd" and r.nframes == 2
        assert int(r.chunk(1, "configuration/step")[0]) == 1000
        assert t_gsdio.decode_type_names(r.chunk(0, "particles/types")) == ["arm", "kinetochore"]


def test_encode_decode_type_names_match_jax():
    names = ["unknown", "a", "nucleolus"]
    encoded = t_gsdio.encode_type_names(names)
    np.testing.assert_array_equal(encoded, j_gsdio.encode_type_names(names))
    assert t_gsdio.decode_type_names(encoded) == names


# -- where torch can differ from numpy without an error ----------------------


def test_median_of_an_even_count_is_numpy_s_not_torch_s():
    x = torch.tensor([4.0, 1.0, 3.0, 2.0], dtype=torch.float64)
    assert float(t_coolio._median(x)) == np.median(x.numpy()) == 2.5
    assert float(torch.median(x)) == 2.0           # the trap: the lower middle value
    assert float(t_coolio._median(x[:3])) == np.median(x[:3].numpy())


def test_mad_filter_on_an_even_coverage_count_masks_what_jax_masks(tmp_path):
    """Six covered bins: numpy's median masks one of them; the lower
    middle value (``torch.median``) would mask three."""
    diag = np.asarray([125, 116, 179, 60, 180, 134])
    pixels = [{"bin1_id": np.arange(6), "bin2_id": np.arange(6), "count": diag}]
    j_path, t_path = write_both(tmp_path, make_bins([("chr1:a", 6)]), pixels)
    want = j_coolio.balance_cooler(j_coolio.Cooler(j_path), store=False, mad_max=2.0)
    got = t_coolio.balance_cooler(t_coolio.Cooler(t_path), store=False, mad_max=2.0, device=CPU)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).sum() == 1
    logc = torch.log(torch.as_tensor(diag, dtype=torch.float64))
    lower = torch.median(logc)
    mad_lower = torch.median(torch.abs(logc - lower)) * 1.4826
    assert int((torch.abs(logc - lower) > 2.0 * mad_lower).sum()) == 3
    np.testing.assert_allclose(got, want, rtol=WEIGHT_RTOL_SAME_ROUNDS, equal_nan=True)


def test_column_moments_are_numpy_s_nanmean_and_nanstd_with_ddof_0(rng):
    data = rng.normal(size=(50, 7)).astype(np.float32)
    data[rng.uniform(size=data.shape) < 0.2] = np.nan
    data[:, 3] = np.nan
    data[4, 1] = np.inf
    mean, std = t_pc1.column_moments(torch.as_tensor(data))
    finite = np.where(np.isfinite(data), data, np.nan).astype(np.float64)
    with np.errstate(invalid="ignore"), pytest.warns(RuntimeWarning):
        np.testing.assert_allclose(mean.numpy(), np.nanmean(finite, 0), rtol=1e-12)
        np.testing.assert_allclose(std.numpy(), np.nanstd(finite, 0), rtol=1e-12)
    assert torch.isnan(std[3])


def test_zero_variance_and_empty_columns_are_dropped_as_jax_drops_them(rng):
    mat, _ = _checkerboard(rng, 40)
    # Column 9: one finite entry, so coverage but no variance; bin 20: no
    # contacts.
    ranges = {"chr1": (0, 20), "chr2": (20, 40)}
    mat[20, :] = mat[:, 20] = 0.0
    mat[:, 9] = np.nan
    mat[9, 9] = 500.0
    got, want, timings = _both_pc1(mat, ranges, svd_tolerance=1e-7)
    dropped = np.flatnonzero(np.isnan(want[1]))
    assert dropped.tolist() == [9, 20]
    np.testing.assert_array_equal(np.flatnonzero(np.isnan(got[1].numpy())), dropped)
    assert timings["kept"] == 40 - len(dropped)


def test_expected_sums_cis_in_float64_and_trans_to_float_rounding(rng):
    mat, _ = _checkerboard(rng, 40)
    mat[3, 5] = mat[5, 3] = np.nan
    ranges = {"chr1": (0, 25), "chr2": (25, 40)}
    got = t_pc1.estimate_expected(torch.as_tensor(mat), ranges)
    want = j_pc1.estimate_expected(mat, ranges)
    assert got.cis_by_separation.dtype == torch.float32
    np.testing.assert_allclose(got.cis_by_separation.numpy(), want.cis_by_separation, rtol=1e-6)
    assert got.trans_mean == pytest.approx(want.trans_mean, rel=1e-6)


def test_power_iteration_stop_near_tol_agrees_within_one_step(rng):
    """tol set to the JAX iteration's own delta at step 15 (and just above
    and below it): both stop there, or one step apart.  Noise data: the
    leading singular values lie close, so the delta falls slowly, from
    float32's rounding far above it."""
    data = rng.normal(size=(80, 30)).astype(np.float32)
    probe = j_pc1.leading_singular_vector(data, tol=0.0, max_iters=15)[2]
    assert 1e-4 < probe < 1e-1
    for tol in (probe * (1 - 1e-6), probe, probe * (1 + 1e-6)):
        _, want_steps, _ = j_pc1.leading_singular_vector(data, tol=tol)
        _, steps, _ = t_pc1.leading_singular_vector(torch.as_tensor(data), tol=tol)
        assert abs(steps - want_steps) <= 1, (tol, steps, want_steps)


def test_merge_sums_in_any_order_and_rounds_half_to_even(tmp_path, rng):
    """Many duplicates in shuffled order: integer counts merge to equal
    sums; non-integer counts round half to even, as ``np.rint``."""
    b1 = rng.integers(0, 30, 5000)
    b2 = rng.integers(0, 30, 5000)
    halves = np.asarray([0.5, 1.5, 2.5, 3.5, -0.5, 2.4999, 2.5001])
    pixels = [{"bin1_id": b1, "bin2_id": b2, "count": rng.integers(1, 9, 5000)},
              {"bin1_id": np.arange(7) + 31, "bin2_id": np.arange(7) + 31, "count": halves}]
    j_path, t_path = write_both(tmp_path, make_bins([("chr1:a", 40)]), pixels)
    assert_same_cool(t_path, j_path)
    with h5py.File(t_path, "r") as f:
        assert f["pixels/count"][-7:].tolist() == [0, 2, 2, 4, 0, 2, 3]


def test_masked_bins_give_nan_rows_and_the_product_rounds_as_jax(tmp_path, rng):
    """A masked bin's NaN weight makes its whole row and column NaN, its
    zeros too; count x (w_i w_j) is formed in float64, then cast to
    float32: the dense map equals the JAX package's."""
    pixels = _biased_counts(rng, 24)        # bins 24 and 25 hold no contact
    pixels.append({"bin1_id": [23], "bin2_id": [23], "count": [10 ** 9]})   # an outlier
    j_path, t_path = write_both(tmp_path, make_bins([("chr1:a", 26)]), pixels)
    j_coolio.balance_cooler(j_coolio.Cooler(j_path), store=True)
    t_coolio.balance_cooler(t_coolio.Cooler(t_path), store=True, device=CPU)
    with h5py.File(j_path, "r") as f:
        weights = f["bins/weight"][:]
    with h5py.File(t_path, "r+") as f:            # same weights in both, to compare the fetch
        f["bins/weight"][...] = weights
    want = np.ascontiguousarray(j_coolio.Cooler(j_path).matrix(balance=True)[:, :], np.float32)
    got = t_coolio.Cooler(t_path).matrix(balance=True, device=CPU, dtype=torch.float32)[:, :]
    masked = np.flatnonzero(np.isnan(weights))
    assert {23, 24, 25} <= set(masked.tolist())
    assert np.isnan(want[masked]).all() and np.isnan(want[:, masked]).all()
    np.testing.assert_array_equal(got.numpy(), want)


# -- the chain on a trajectory the port wrote --------------------------------

CHAIN_CONFIG = {
    "mitotic_phase": {"coarse_graining": 10},
    "interphase": {
        "steps": 240, "sampling_interval": 40, "logging_interval": 240,
        "relaxation_steps": 40, "relaxation_sampling_interval": 20,
        "contactmap_update_interval": 10, "contactmap_output_window": 2,
    },
}


def _write_diploid_inputs(tmp_path):
    """Two chromosomes in two copies each (chr1 with an active NOR on its
    first copy), 500 beads."""
    (tmp_path / "config.json").write_text(json.dumps(CHAIN_CONFIG))
    rows = ["chain\tstart\tend\tA\tB\ttags"]
    for name, nbeads, cen in (("chr1:a", 150, (70, 80)), ("chr2:a", 100, (45, 55)),
                              ("chr1:b", 150, (70, 80)), ("chr2:b", 100, (45, 55))):
        for i in range(nbeads):
            if cen[0] <= i < cen[1]:
                tag, a, b = "cen,B", 0, 1
            elif name == "chr1:a" and i < 2:
                tag, a, b = "anor,A", 1, 0
            elif (i // 10) % 2 == 0:
                tag, a, b = "A", 1, 0
            else:
                tag, a, b = "B", 0, 1
            rows.append(f"{name}\t{i * 100000}\t{(i + 1) * 100000}\t{a}\t{b}\t{tag}")
    (tmp_path / "chains.tsv").write_text("\n".join(rows) + "\n")
    return str(tmp_path / "config.json"), str(tmp_path / "chains.tsv")


def _port_trajectory(store, config_path, chains_path):
    from genome_cycle_tpu_torch.models.interphase import EngineSettings, run_interphase
    from genome_cycle_tpu_torch.models.prepare import run_prepare
    from genome_cycle_tpu_torch.models.transitions import transition_interphase
    from test_torch_interphase import _seed_telophase
    from genome_cycle_tpu_torch.store import SimulationStore

    quiet = lambda m: None  # noqa: E731
    run_prepare(store, config_path, chains_path, seed=9, log=quiet)
    opened = SimulationStore(store) if isinstance(store, str) else store
    _seed_telophase(opened)
    transition_interphase(opened, log=quiet)
    run_interphase(opened, EngineSettings(brute_force_threshold=0), log=quiet, device=CPU)
    return opened


@pytest.fixture(scope="module")
def trajectory(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_analysis")
    config_path, chains_path = _write_diploid_inputs(tmp)
    path = str(tmp / "run.h5")
    _port_trajectory(path, config_path, chains_path).close()
    return path, config_path, chains_path, tmp


def test_chain_on_a_port_trajectory_matches_jax(trajectory):
    """cool -> dephase -> pc1 -> dumpgsd through both CLIs, the port's on
    the CPU, on a trajectory the port wrote."""
    from genome_cycle_tpu import cli as jcli
    from genome_cycle_tpu_torch import cli as tcli

    path, _, _, tmp = trajectory
    out = {}
    for tag, cli, device in (("jax", jcli, []), ("port", tcli, ["--device", "cpu"])):
        d = tmp / tag
        d.mkdir()
        cli.main(["cool", *device, "--output", str(d / "sim.cool"), path])
        cli.main(["dephase", *device, "--output", str(d / "hap.cool"), str(d / "sim.cool")])
        cli.main(["pc1", *device, "--output", str(d / "pc1.tsv"), "--aux-output",
                  str(d / "aux.json"), str(d / "hap.cool")])
        cli.main(["dumpgsd", path, str(d / "run.gsd")])
        out[tag] = d
    port, jax_ = out["port"], out["jax"]
    for name in ("sim.cool", "hap.cool"):
        assert_same_cool(str(port / name), str(jax_ / name), weights_rtol=WEIGHT_RTOL)
    with h5py.File(port / "sim.cool", "r") as f:
        assert f.attrs["nbins"] == 504 and f.attrs["sum"] > 1000
    with h5py.File(port / "hap.cool", "r") as f:
        assert f.attrs["nbins"] == 250
    got = pd.read_csv(port / "pc1.tsv", sep="\t")
    want = pd.read_csv(jax_ / "pc1.tsv", sep="\t")
    pd.testing.assert_frame_equal(got[["chrom", "start", "end"]], want[["chrom", "start", "end"]])
    assert got["ev1"].notna().sum() > 200
    for column in ("ev1", "pc1"):
        np.testing.assert_array_equal(got[column].isna(), want[column].isna())
        np.testing.assert_allclose(sign_aligned(got[column], want[column]), want[column],
                                   atol=PC_ATOL, equal_nan=True)
    aux, want_aux = (json.loads((d / "aux.json").read_text()) for d in (port, jax_))
    assert aux.keys() == want_aux.keys()
    assert aux["explained_variance_ratio"] == pytest.approx(
        want_aux["explained_variance_ratio"], rel=EVR_RTOL)
    np.testing.assert_allclose(aux["cis_decay_profile"], want_aux["cis_decay_profile"], rtol=1e-6)
    assert aux["trans_contact"] == pytest.approx(want_aux["trans_contact"], rel=1e-6)
    assert (port / "run.gsd").read_bytes() == (jax_ / "run.gsd").read_bytes()


def test_cool_over_a_memory_store_equals_cool_over_the_file(trajectory):
    from genome_cycle_tpu_torch.store import MemoryStore, SimulationStore

    path, config_path, chains_path, tmp = trajectory
    memory = _port_trajectory(MemoryStore(), config_path, chains_path)
    with SimulationStore(path, "r") as store:
        store.set_stage("interphase")
        memory.set_stage("interphase")
        assert store.load_steps() == memory.load_steps()
        np.testing.assert_array_equal(memory.load_contacts(240), store.load_contacts(240))
    from_file = t_cool.contact_pixels([path], device=CPU)
    from_memory = t_cool.contact_pixels([memory], device=CPU)
    pd.testing.assert_frame_equal(from_file[0], from_memory[0])
    for a, b in zip(from_file[1:], from_memory[1:]):
        assert torch.equal(a, b)
    t_cool.main(output=str(tmp / "mem.cool"), input_sims=[memory], device=CPU)
    t_cool.main(output=str(tmp / "file.cool"), input_sims=[path], device=CPU)
    assert_same_cool(str(tmp / "mem.cool"), str(tmp / "file.cool"))


def test_cool_merges_replicas_and_selects_frames_as_jax(trajectory):
    path, _, _, tmp = trajectory
    frames = t_cool.parse_frame_ranges("1-3,8-")
    assert frames == j_cool.parse_frame_ranges("1-3,8-")
    j_cool.main(output=str(tmp / "sel_j.cool"), input_sims=[path, path, str(tmp / "missing.h5")],
                frames=frames)
    t_cool.main(output=str(tmp / "sel_t.cool"), input_sims=[path, path, str(tmp / "missing.h5")],
                frames=frames, device=CPU)
    assert_same_cool(str(tmp / "sel_t.cool"), str(tmp / "sel_j.cool"), weights_rtol=WEIGHT_RTOL)
    pd.testing.assert_frame_equal(t_cool.bin_table(path), j_cool.bin_table(path))


def test_dumpgsd_stages_match_jax(trajectory):
    path, _, _, tmp = trajectory
    for stage in ("relaxation", "telophase"):
        t_dumpgsd.main(input_filename=path, output_filename=str(tmp / f"{stage}_t.gsd"),
                       stage=stage)
        j_dumpgsd.main(input_filename=path, output_filename=str(tmp / f"{stage}_j.gsd"),
                       stage=stage)
        assert (tmp / f"{stage}_t.gsd").read_bytes() == (tmp / f"{stage}_j.gsd").read_bytes()
    with pytest.raises(ValueError, match="unknown stage"):
        t_dumpgsd.main(input_filename=path, output_filename=str(tmp / "x.gsd"), stage="nope")
