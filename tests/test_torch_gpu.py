"""The CUDA pair-force kernels against their plain version, on the card, also
on a layout of several replicas; an ensemble run on the card; the
interphase step through the kernel against the C++ surrogate; and the
analysis chain's device numerics on the card against the host.

These tests need a CUDA card and ``nvcc`` and skip where there is none.  The
file imports only torch and the port, so that it also runs on a machine
without JAX:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerance: max|dF| <= 1e-4 * max(|F|, 1) (float32 sums in another order),
energy 1e-5 relative.  The statistical gate is that of
tests/test_torch_correlation.py (Pearson r >= 0.95 and its other bounds); it
also needs ``g++``.
"""

import numpy as np
import pytest
import torch

from genome_cycle_tpu_torch.ops import pair_kernels as pk

import test_torch_correlation as gate
from test_torch_correlation import surrogate_exe  # noqa: F401  (fixture)


def _beads(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    af = rng.uniform(0, 1, n).astype(np.float32)
    return x, af, (1.0 - af).astype(np.float32)


def _kparams(core_scale):
    a_d, b_d = 0.3 * core_scale, 0.24 * core_scale
    return (2.5, 1 / (a_d * a_d), 2.5, 1 / (b_d * b_d))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no interpret mode")
    return torch.device("cuda")


def _layout(beads, device, bound=1.2):
    x, af, bf = (torch.as_tensor(v, device=device) for v in beads)
    return pk.build_cell_layout(x, af, bf, bound, 0.3)


def _control_flow_layout(case, device):
    """Inputs made for the kernel's control flow: a cell that holds more
    beads than a block owns and more than one tile of candidates, a grid of a
    single cell, a single bead."""
    rng = np.random.default_rng(21)
    if case == "overfull cell":
        x = np.concatenate([
            rng.uniform(0.02, 0.27, (3000, 3)), rng.uniform(-1.1, 1.1, (300, 3)),
        ]).astype(np.float32)
        bound = 1.2
    elif case == "single-cell grid":
        x, bound = rng.uniform(-0.1, 0.1, (700, 3)).astype(np.float32), 0.1
    else:
        x, bound = np.zeros((1, 3), np.float32), 1.2
    af = rng.uniform(0, 1, len(x)).astype(np.float32)
    return _layout((x, af, 1.0 - af), device, bound)


def _assert_matches_plain(layout, kparams, forces, energy):
    f_ref, e_ref = pk.ab_pair_forces_reference(layout, kparams, with_energy=True)
    err = float((forces - f_ref).abs().max())
    assert err <= 1e-4 * max(float(f_ref.abs().max()), 1.0)
    assert float(energy) == pytest.approx(float(e_ref), rel=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["overfull cell", "single-cell grid", "one bead"])
def test_cuda_kernel_control_flow_matches_plain_version(cuda_device, case):
    layout = _control_flow_layout(case, cuda_device)
    kparams = _kparams(1.0)
    f, e = pk.ab_pair_forces(layout, kparams, with_energy=True)
    torch.cuda.synchronize()
    _assert_matches_plain(layout, kparams, f, e)
    if case == "one bead":
        assert not f.any() and float(e) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("with_energy", [False, True])
def test_two_launches_are_bitwise_equal(cuda_device, with_energy):
    layout = _control_flow_layout("overfull cell", cuda_device)
    first = pk.ab_pair_forces(layout, _kparams(1.0), with_energy)
    second = pk.ab_pair_forces(layout, _kparams(1.0), with_energy)
    torch.cuda.synchronize()
    assert first[0].abs().max() > 1.0
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.gpu
def test_first_version_of_the_kernel_matches_plain_version(cuda_device):
    layout = _layout(_beads(3000, seed=11), cuda_device)
    kparams = _kparams(1.0)
    before = pk.ab_pair_forces.launches
    f, e = pk._ab_pair_forces_thread_per_bead(layout, kparams, with_energy=True)
    torch.cuda.synchronize()
    assert pk.ab_pair_forces.launches == before     # the yardstick counts apart
    _assert_matches_plain(layout, kparams, f, e)


@pytest.mark.gpu
@pytest.mark.parametrize("core_scale", [0.5, 1.0])
def test_cuda_kernel_matches_plain_version(cuda_device, core_scale):
    layout = _layout(_beads(3000, seed=11), cuda_device)
    kparams = _kparams(core_scale)
    before = pk.ab_pair_forces.launches
    f, e = pk.ab_pair_forces(layout, kparams, with_energy=True)
    torch.cuda.synchronize()
    assert pk.ab_pair_forces.launches == before + 1
    _assert_matches_plain(layout, kparams, f, e)


@pytest.mark.gpu
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    layout = _layout(_beads(100, seed=12), cuda_device)
    with pytest.raises(TypeError):
        pk.ab_pair_forces(layout._replace(xyz=layout.xyz.double()), _kparams(1.0))
    with pytest.raises(ValueError):
        pk.ab_pair_forces(layout._replace(ab=layout.ab.t().contiguous().t()), _kparams(1.0))
    with pytest.raises(ValueError):
        pk.ab_pair_forces(layout._replace(cell_start=layout.cell_start[:-1]), _kparams(1.0))
    with pytest.raises(ValueError, match="aligned"):
        shifted = torch.zeros((101, 2), device=cuda_device).view(-1)[1:-1].view(100, 2)
        pk.ab_pair_forces(layout._replace(ab=shifted), _kparams(1.0))


def _stacked_beads(replicas, n=3000, seed=13):
    """R replicas of n beads, a few of each beyond the grid's bound."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.9, 0.9, (replicas, n, 3)).astype(np.float32)
    x[:, :20] *= 1.6
    af = rng.uniform(0, 1, n).astype(np.float32)
    return x, af, (1.0 - af).astype(np.float32)


@pytest.mark.gpu
def test_cuda_kernel_on_stacked_replicas_matches_plain_and_single_launches(cuda_device):
    """One launch for three replicas side by side: as the plain version on
    the same layout, and as three launches, one a replica on its own."""
    x, af, bf = (torch.as_tensor(v, device=cuda_device) for v in _stacked_beads(3))
    stacked = pk.build_cell_layout(x, af, bf, 1.2, 0.3)
    assert stacked.shape == (26, 8, 8)
    kparams = _kparams(1.0)
    before = pk.ab_pair_forces.launches
    f, e = pk.ab_pair_forces(stacked, kparams, with_energy=True)
    torch.cuda.synchronize()
    assert pk.ab_pair_forces.launches == before + 1
    _assert_matches_plain(stacked, kparams, f, e)
    f = f.reshape(x.shape)
    for r in range(3):
        single, e_r = pk.ab_pair_forces(pk.build_cell_layout(x[r], af, bf, 1.2, 0.3), kparams, True)
        torch.cuda.synchronize()
        assert float((f[r] - single).abs().max()) <= 1e-4 * max(float(single.abs().max()), 1.0)


def _ensemble_stores(tmp_path, device, replicas=2):
    """Prepared stores of a 600-bead two-chain system, through a short
    anatelophase and the transition, for an ensemble run."""
    import json

    from genome_cycle_tpu_torch.models.anatelophase import run_anatelophase
    from genome_cycle_tpu_torch.models.prepare import run_prepare
    from genome_cycle_tpu_torch.models.transitions import transition_interphase
    from genome_cycle_tpu_torch.store import MemoryStore

    config = {
        "mitotic_phase": {"coarse_graining": 10, "anaphase_steps": 2000,
                          "telophase_steps": 4000, "sampling_interval": 1000},
        "interphase": {"steps": 80, "relaxation_steps": 40, "sampling_interval": 20,
                       "relaxation_sampling_interval": 20, "logging_interval": 40,
                       "contactmap_output_window": 2},
    }
    (tmp_path / "config.json").write_text(json.dumps(config))
    rows = ["chain\tstart\tend\tA\tB\ttags"]
    for name in ("chr1:a", "chr2:a"):
        for i in range(300):
            tag = "cen,B" if 140 <= i < 160 else ("A" if i % 2 else "B")
            a, b = (1, 0) if tag == "A" else (0, 1)
            rows.append(f"{name}\t{i * 100000}\t{(i + 1) * 100000}\t{a}\t{b}\t{tag}")
    (tmp_path / "chains.tsv").write_text("\n".join(rows) + "\n")
    stores = []
    for k in range(replicas):
        store = MemoryStore()
        run_prepare(store, str(tmp_path / "config.json"), str(tmp_path / "chains.tsv"),
                    seed=20 + k, log=lambda m: None)
        run_anatelophase(store, log=lambda m: None, device=device)
        transition_interphase(store, log=lambda m: None)
        stores.append(store)
    return stores


@pytest.mark.gpu
def test_cuda_ensemble_launches_the_kernel_once_a_step(cuda_device, tmp_path):
    from genome_cycle_tpu_torch.models.interphase import EngineSettings
    from genome_cycle_tpu_torch.parallel.ensemble import run_ensemble_interphase

    stores = _ensemble_stores(tmp_path, cuda_device)
    before = pk.ab_pair_forces.launches
    final = run_ensemble_interphase(
        stores, settings=EngineSettings(brute_force_threshold=0), log=lambda m: None,
        device=cuda_device)
    assert pk.ab_pair_forces.launches - before == 40 + 80     # relaxation + G1 steps
    assert final.shape == (2, 600, 3) and np.isfinite(final).all()
    assert np.abs(final[0] - final[1]).max() > 1e-2
    for store in stores:
        store.set_stage("interphase")
        assert store.load_steps() == [0, 20, 40, 60, 80]
        assert store.load_contacts(80) is not None


@pytest.mark.gpu
def test_contact_map_pearson_vs_surrogate_through_the_kernel(
        cuda_device, surrogate_exe, tmp_path):  # noqa: F811
    """The gate of tests/test_torch_correlation.py with the port's steps on
    the card: every pair force comes from the CUDA kernel, one launch a step
    for all the replicas."""
    before = pk.ab_pair_forces.launches
    gate.contact_map_gate(surrogate_exe, tmp_path, cuda_device)
    assert pk.ab_pair_forces.launches - before == gate.STEPS


@pytest.mark.gpu
def test_analysis_numerics_on_the_card_match_the_host(cuda_device):
    """The analysis chain's device functions on the card against the same
    functions on the host: pixel merge and dephase equal, ICE weights to
    float64 rounding (or a round apart: 1e-5), the dense balanced map
    equal, PC1 sign-aligned within 1e-4 with the power step in true
    float32 (TF32 off, the default)."""
    import pandas as pd

    from genome_cycle_tpu_torch.analysis import coolio, dephase, pc1

    assert torch.backends.cuda.matmul.allow_tf32 is False
    rng = np.random.default_rng(31)
    names = [f"chr{c}:{copy}" for copy in "ab" for c in (1, 2, 3)]
    sizes = [120, 90, 70] * 2
    bins = pd.DataFrame([(name, i * 100, (i + 1) * 100) for name, size in zip(names, sizes)
                         for i in range(size)], columns=["chrom", "start", "end"])
    n = len(bins)
    i = rng.integers(0, n, 200_000)
    j = np.clip(i + rng.geometric(0.05, 200_000) * rng.choice([-1, 1], 200_000), 0, n - 1)
    chunk = {"bin1_id": i, "bin2_id": j, "count": rng.integers(1, 4, 200_000)}
    merged = [coolio.merge_pixels([chunk], n, where) for where in (cuda_device, "cpu")]
    assert all(torch.equal(a.cpu(), b) for a, b in zip(*merged))
    stats = [{}, {}]
    weights = [coolio.ice_weights(*px, n, stats=st) for px, st in zip(merged, stats)]
    assert abs(stats[0]["rounds"] - stats[1]["rounds"]) <= 1
    rtol = 1e-9 if stats[0]["rounds"] == stats[1]["rounds"] else 1e-5
    np.testing.assert_allclose(weights[0].cpu().numpy(), weights[1].numpy(), rtol=rtol,
                               equal_nan=True)
    hap_bins, projection = dephase.project_bins(bins)
    hap = [coolio.merge_pixels([dephase.dephase_pixels(*px, projection)], len(hap_bins), where)
           for px, where in zip(merged, (cuda_device, "cpu"))]
    assert all(torch.equal(a.cpu(), b) for a, b in zip(*hap))
    nh = len(hap_bins)
    hw = coolio.ice_weights(*hap[1], nh)
    dense = [coolio.dense_matrix(*px, (0, nh), (0, nh), hw.to(px[0].device), torch.float32)
             for px in hap]
    np.testing.assert_array_equal(dense[0].cpu().numpy(), dense[1].numpy())   # NaN rows too
    ranges = {"chr1": (0, 120), "chr2": (120, 210), "chr3": (210, 280)}
    got_t, want_t = {}, {}
    got = pc1.compute_pc1(dense[0], ranges, timings=got_t)
    want = pc1.compute_pc1(dense[1], ranges, timings=want_t)
    assert abs(got_t["power_steps"] - want_t["power_steps"]) <= 1
    ev1, ev1_want = got[1].cpu().numpy(), want[1].numpy()
    ok = np.isfinite(ev1_want)
    np.testing.assert_array_equal(np.isfinite(ev1), ok)
    sign = 1.0 if np.dot(ev1[ok], ev1_want[ok]) >= 0 else -1.0
    np.testing.assert_allclose(sign * ev1[ok], ev1_want[ok], atol=1e-4)
    np.testing.assert_allclose(sign * got[0].cpu().numpy(), want[0].numpy(), atol=1e-4)
    assert got[2] == pytest.approx(want[2], rel=1e-4)
