"""The CUDA pair-force kernels against their plain version, on the card, also
on a layout of several replicas; the cell layout's kernels against theirs,
bit for bit; the step kernels (the contact tick, the rest kernel with its
wall reaction and nucleolar rows, the update) against theirs; the mitotic
stage driver's frames, written while the next chunk runs, against a serial
loop's, bit for bit; an ensemble run on the card; the
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
from genome_cycle_tpu_torch.utils import tracing

import test_torch_correlation as gate
from test_torch_correlation import surrogate_exe  # noqa: F401  (fixture)


def _launches(kernel="ab_pair_forces"):
    """The launches of ``kernel`` the port has counted in this process."""
    return tracing.counters().get("launch." + kernel, 0)


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
@pytest.mark.parametrize("core_scale", [0.5, 1.0])
def test_cuda_kernel_matches_plain_version(cuda_device, core_scale):
    layout = _layout(_beads(3000, seed=11), cuda_device)
    kparams = _kparams(core_scale)
    before = _launches()
    f, e = pk.ab_pair_forces(layout, kparams, with_energy=True)
    torch.cuda.synchronize()
    assert _launches() == before + 1
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
    before = _launches()
    f, e = pk.ab_pair_forces(stacked, kparams, with_energy=True)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    _assert_matches_plain(stacked, kparams, f, e)
    f = f.reshape(x.shape)
    for r in range(3):
        single, e_r = pk.ab_pair_forces(pk.build_cell_layout(x[r], af, bf, 1.2, 0.3), kparams, True)
        torch.cuda.synchronize()
        assert float((f[r] - single).abs().max()) <= 1e-4 * max(float(single.abs().max()), 1.0)


@pytest.mark.gpu
def test_cuda_kernel_padded_layout_and_home_range(cuda_device):
    """A padded buffer through the kernel: the padded rows take part in no
    pair and get zeros; a home range of the sorted order gets the forces and
    energies of those rows of the full launch, every other row zeros; the
    launch needs no host sync to learn where the padding starts."""
    x, af, bf = _beads(3000, seed=31)
    valid = np.ones(len(x), bool)
    valid[2200:] = False                 # padding, stacked on the real beads
    x[2200:] = x[0]
    x, af, bf = (torch.as_tensor(v, device=cuda_device) for v in (x, af, bf))
    valid = torch.as_tensor(valid, device=cuda_device)
    padded = pk.build_cell_layout(x, af, bf, 1.2, 0.3, valid=valid)
    real = pk.build_cell_layout(x[:2200], af[:2200], bf[:2200], 1.2, 0.3)
    kparams = _kparams(1.0)
    f_full, e_full = pk.ab_pair_forces(padded, kparams, per_bead=True)
    f_real, e_real = pk.ab_pair_forces(real, kparams, with_energy=True)
    torch.cuda.synchronize()
    assert not f_full[2200:].any() and not e_full[2200:].any()
    assert float((f_full[:2200] - f_real).abs().max()) <= 1e-4 * max(float(f_real.abs().max()), 1.0)
    assert float(e_full.sum()) == pytest.approx(float(e_real), rel=1e-5)
    for begin, end in ((700, 1900), (1000, padded.n), (0, 1)):
        f, e = pk.ab_pair_forces(padded, kparams, begin=begin, end=end, per_bead=True)
        f_p, e_p = pk.ab_pair_forces_reference(padded, kparams, begin=begin, end=end, per_bead=True)
        torch.cuda.synchronize()
        home = padded.order[begin:min(end, 2200)]
        outside = torch.ones(len(x), dtype=torch.bool, device=cuda_device)
        outside[home] = False
        assert not f[outside].any() and not e[outside].any()
        assert float((f[home] - f_full[home]).abs().max()) <= 1e-4 * max(float(f_full.abs().max()), 1.0)
        assert float((f - f_p).abs().max()) <= 1e-4 * max(float(f_p.abs().max()), 1.0)
        assert float(e.sum()) == pytest.approx(float(e_p.sum()), rel=1e-5, abs=1e-6)


# -- the cell layout: csrc/cell_layout.cu against its plain version -------------

LAYOUT_CASES = ["random", "clipped", "4 replicas stacked", "padded", "over 65,536 cells"]


def _edge_values(bound, cell=0.3, ulps=4):
    """float32 coordinates on every cell edge of the grid over [-bound,
    bound] and up to ``ulps`` steps to either side, and how many of them a
    true quotient by the cell puts in another cell than the product with its
    float32 reciprocal (PyTorch's quotient by a host scalar on the card)."""
    lower, c = np.float32(-bound), np.float32(cell)
    values = []
    for k in range(pk.grid_dims(bound, cell) + 1):
        below = above = np.float32(lower + np.float32(k) * c)
        values.append(below)
        for _ in range(ulps):
            below = np.nextafter(below, np.float32(-np.inf))
            above = np.nextafter(above, np.float32(np.inf))
            values += [below, above]
    values = np.array(values, np.float32)
    apart = np.floor((values - lower) / c) != np.floor((values - lower) * (np.float32(1) / c))
    return values, int(apart.sum())


def _layout_inputs(case, device):
    """(positions, af, bf, bound, valid) of a layout case, on ``device``:
    random beads at the production grid's bound with beads on and beside
    every cell edge; beads far beyond the bound; four replicas stacked on the
    four-replica grid (80,919 cells); a padded buffer; a grid of 74,088
    cells."""
    rng = np.random.default_rng(61)
    bound, valid = 4.0, None
    if case == "clipped":
        bound = 1.2
        x = rng.uniform(-3.0, 3.0, (3000, 3))
        x[:6] = [[1.2, 1.2, 1.2], [-1.2, -1.2, -1.2], [2.5, 0.0, -2.5],
                 [1e6, -1e6, 0.0], [1.19999, 1.2000001, -1.2000001], [-0.0, 0.0, 0.0]]
    elif case == "over 65,536 cells":
        bound = 6.15
        x = rng.uniform(-6.3, 6.3, (20000, 3))
    elif case == "4 replicas stacked":
        x = rng.uniform(-3.8, 3.8, (4, 3000, 3))
        x[:, :20] *= 1.2
    else:
        x = rng.uniform(-3.8, 3.8, (3000, 3))
    if case != "clipped":
        values, apart = _edge_values(bound)
        assert apart > 0, "no edge bead tells the quotient from the product"
        rows = x.reshape(-1, 3)
        picks = rng.choice(len(rows), size=(len(values),), replace=False)
        rows[picks, rng.integers(0, 3, len(values))] = values
    n = x.shape[-2]
    af = rng.uniform(0, 1, n).astype(np.float32)
    if case == "padded":
        valid = np.ones(n, bool)
        valid[2200:] = False
        x[2200:] = x[0]
        valid = torch.as_tensor(valid, device=device)
    x, af = (torch.as_tensor(v.astype(np.float32), device=device) for v in (x, af))
    return x, af, 1.0 - af, bound, valid


def _sorted_rows(events):
    ev = events.cpu().numpy()
    return ev[np.lexsort(ev.T[::-1])]


@pytest.mark.gpu
@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_cell_layout_kernel_matches_plain_version_to_the_bit(cuda_device, case):
    """The layout the kernels build equals the plain version's in every
    field, bit for bit, with one counted launch; the pair kernel and the
    tick give the same bits from either layout."""
    from genome_cycle_tpu_torch.ops import contact

    x, af, bf, bound, valid = _layout_inputs(case, cuda_device)
    before = _launches("cell_layout")
    got = pk.build_cell_layout(x, af, bf, bound, 0.3, valid=valid)
    want = pk.build_cell_layout_reference(x, af, bf, bound, 0.3, valid=valid)
    torch.cuda.synchronize()
    assert _launches("cell_layout") == before + 1
    assert (got.replicas, got.padded) == (4 if x.dim() == 3 else 1, valid is not None)
    if case in ("4 replicas stacked", "over 65,536 cells"):
        assert got.num_cells > 65536
    for field in pk.CellLayout._fields:
        a, b = getattr(got, field), getattr(want, field)
        if torch.is_tensor(b):
            assert a.dtype == b.dtype and a.shape == b.shape, field
            assert torch.equal(a, b), field
        else:
            assert a == b, field
    kparams = _kparams(1.0)
    f_got, e_got = pk.ab_pair_forces(got, kparams, per_bead=True)
    f_want, e_want = pk.ab_pair_forces(want, kparams, per_bead=True)
    torch.cuda.synchronize()
    assert float(f_want.abs().max()) > 0
    assert torch.equal(f_got, f_want) and torch.equal(e_got, e_want)
    events = [contact.contact_events(layout, 0.24) for layout in (got, want)]
    assert len(events[0]) > 0
    np.testing.assert_array_equal(_sorted_rows(events[0]), _sorted_rows(events[1]))


def _chain_walk(n, chains, radius, bond_rms=0.1, seed=0):
    """Chains as ball-confined random walks (as ``bench._chain_walk``, which
    this file cannot import: it runs where JAX is not installed)."""
    rng = np.random.default_rng(seed)
    per = n // chains
    out = np.empty((per * chains, 3), np.float32)
    for c in range(chains):
        walk = np.empty((per, 3))
        walk[0] = rng.normal(size=3) * radius * 0.3
        for i in range(1, per):
            q = walk[i - 1] + rng.normal(0.0, bond_rms / np.sqrt(3.0), 3)
            r = np.sqrt(q @ q)
            walk[i] = q * (2.0 * radius - r) / r if r > radius else q
        out[c * per:(c + 1) * per] = walk
    return out


@pytest.mark.gpu
def test_two_rank_halo_step_on_one_card(cuda_device):
    """Two ranks on the one card (gloo, staged through the host): one halo
    step's assembled forces and wall reaction equal the single step's, and
    each rank's local layout through the kernel equals the plain version."""
    import json

    from genome_cycle_tpu_torch.config import parse_config
    from genome_cycle_tpu_torch.models.interphase import (
        EngineSettings, InterphaseModel, design_arrays,
    )
    from genome_cycle_tpu_torch.parallel import mesh, ranks
    from genome_cycle_tpu_torch.store import StageDesign
    from genome_cycle_tpu_torch.topology import ChainAssignment

    n = 4000
    ab = np.zeros((n, 2))
    ab[::2, 0] = 1.0
    ab[1::2, 1] = 1.0
    design = StageDesign(seed=7, chains=[ChainAssignment(f"chr{i}:a", i * n // 4, (i + 1) * n // 4)
                                         for i in range(4)],
                         ab_factors=ab, nucleolar_bonds=np.zeros((0, 2), np.int64))
    config = parse_config(json.dumps({})).interphase
    arrays = design_arrays(design, config)
    settings = EngineSettings(brute_force_threshold=0)
    x = _chain_walk(n, 4, 1.5, seed=3)
    semi = np.asarray([2.0, 2.0, 2.0], np.float32)
    model = InterphaseModel(config, arrays, settings, cuda_device)
    model.update_bound(float(np.abs(x).max()))
    results = mesh.spawn(ranks.halo_forces, 2, [cuda_device] * 2, None,
                         config, arrays, settings, x, semi, 1, model.bound)
    assert [r["backend"] for r in results] == ["gloo", "gloo"]
    assert sum(r["own"] for r in results) == n and min(r["own"] for r in results) > 0
    core, bond = model.scales(0.0)
    f, reaction, _ = model._assemble_forces(torch.as_tensor(x, device=cuda_device), core, bond,
                                            torch.as_tensor(semi, device=cuda_device))
    f = f.cpu().numpy()
    assert np.abs(results[0]["forces"] - f).max() <= 1e-4 * max(np.abs(f).max(), 1.0)
    np.testing.assert_allclose(results[1]["reaction"], reaction.cpu().numpy(), rtol=1e-4)
    for r in results:
        assert not r["foreign_modules"]
        # The rank's local layout, padded rows and all, rebuilt on the card:
        # the full range, and a home range from past 0 into the padding.
        layout = pk.CellLayout(**{k: torch.as_tensor(v, device=cuda_device)
                                  if isinstance(v, np.ndarray) else v
                                  for k, v in r["layout"].items()})
        real = int(layout.cell_start[-1])
        assert real < layout.n
        for begin, end in ((0, None), (real // 3, layout.n)):
            f_k, e_k = pk.ab_pair_forces(layout, r["params"], begin=begin, end=end, per_bead=True)
            f_p, e_p = pk.ab_pair_forces_reference(layout, r["params"], begin=begin, end=end,
                                                   per_bead=True)
            inside = torch.zeros(layout.n, dtype=torch.bool, device=cuda_device)
            inside[layout.order[begin:real]] = True
            assert (f_k[~inside] == 0).all()
            assert (f_k - f_p).abs().max() <= 1e-4 * max(float(f_p.abs().max()), 1.0)
            assert float(e_k.sum()) == pytest.approx(float(e_p.sum()), rel=1e-5)


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
    before = _launches()
    final = run_ensemble_interphase(
        stores, settings=EngineSettings(brute_force_threshold=0), log=lambda m: None,
        device=cuda_device)
    assert _launches() - before == 40 + 80     # relaxation + G1 steps
    assert final.shape == (2, 600, 3) and np.isfinite(final).all()
    assert np.abs(final[0] - final[1]).max() > 1e-2
    for store in stores:
        store.set_stage("interphase")
        assert store.load_steps() == [0, 20, 40, 60, 80]
        assert store.load_contacts(80) is not None


@pytest.mark.gpu
@pytest.mark.parametrize("replicas", [1, 2])
def test_every_host_sync_of_the_g1_is_a_marked_site(cuda_device, tmp_path, replicas):
    """The G1 of ``run_interphase`` (one replica) or of the ensemble (two),
    80 steps with 4 ticks, 4 frames, 2 window dumps and checkpoints, under
    ``torch.cuda.set_sync_debug_mode("warn")`` with tracing on: from the
    first G1 step on, every synchronising call the debug mode flags is made
    inside a ``sync.*`` span, and none inside ``g1.step``."""
    import warnings

    from genome_cycle_tpu_torch.models.interphase import EngineSettings, run_interphase
    from genome_cycle_tpu_torch.parallel.ensemble import run_ensemble_interphase

    stores = _ensemble_stores(tmp_path, cuda_device, replicas)
    flagged = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        names = [s.name for s in tracing._state.stack]
        started = flagged or "g1.step" in names or any(
            s["name"] == "g1.step" for s in tracing.snapshot()["spans"])
        if started:
            flagged.append(names)

    settings = EngineSettings(brute_force_threshold=0)
    before = tracing.counters()
    tracing.start()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                if replicas == 1:
                    run_interphase(stores[0], settings=settings, log=lambda m: None,
                                   device=cuda_device)
                else:
                    run_ensemble_interphase(stores, settings=settings, log=lambda m: None,
                                            device=cuda_device)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        tracing.stop()
    since = tracing.counters_since(before)
    assert since["sync.tick_count"] >= 4 and since["sync.merge_unique"] == 4
    assert flagged, "the debug mode flagged no synchronising call"
    unmarked = [names for names in flagged if not names or not names[-1].startswith("sync.")]
    assert not unmarked, unmarked[:5]
    assert not [names for names in flagged if "g1.step" in names]


@pytest.mark.gpu
def test_contact_map_pearson_vs_surrogate_through_the_kernel(
        cuda_device, surrogate_exe, tmp_path):  # noqa: F811
    """The gate of tests/test_torch_correlation.py with the port's steps on
    the card: every pair force comes from the CUDA kernel, one launch a step
    for all the replicas."""
    before = _launches()
    gate.contact_map_gate(surrogate_exe, tmp_path, cuda_device)
    assert _launches() - before == gate.STEPS


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


# -- the rest of the step: tick, bonds + wall, update ---------------------------
#
# Tolerances: the tick's pair sets are equal (r2 is formed in one fixed order
# on both sides); forces, reaction and positions within 1e-5 of their largest
# magnitude (the wall's derivatives in closed form against autograd, float32
# sums in another order), energies 1e-5 relative.

def _pair_set(events):
    ev = events.cpu().numpy().reshape(-1, 3)
    return sorted(zip(ev[:, 0].tolist(), ev[:, 1].tolist()))


def _tick_layouts(device):
    """Layouts made for the tick's control flow, with the home range each is
    searched over: random beads, a cell fuller than a warp, a single-cell
    grid, one bead, a padded buffer searched from past its first row into
    the padding, and four replicas side by side."""
    cases = []
    x, af, bf = _beads(3000, seed=11)
    cases.append(("3,000 beads", _layout((x, af, bf), device), 0, None))
    for case in ("overfull cell", "single-cell grid", "one bead"):
        cases.append((case, _control_flow_layout(case, device), 0, None))
    valid = np.ones(len(x), bool)
    valid[2200:] = False
    xp = x.copy()
    xp[2200:] = xp[0]
    padded = pk.build_cell_layout(*(torch.as_tensor(v, device=device) for v in (xp, af, bf)),
                                  1.2, 0.3, valid=torch.as_tensor(valid, device=device))
    cases.append(("padded, home range", padded, 700, padded.n))
    xs, af, bf = _stacked_beads(4, n=2000, seed=43)
    cases.append(("4 replicas stacked", pk.build_cell_layout(
        *(torch.as_tensor(v, device=device) for v in (xs, af, bf)), 1.2, 0.3), 0, None))
    return cases


@pytest.mark.gpu
def test_contact_tick_kernel_matches_plain_version(cuda_device):
    from genome_cycle_tpu_torch.ops import contact

    for name, layout, begin, end in _tick_layouts(cuda_device):
        before = _launches("contact_tick")
        got = contact.contact_events(layout, 0.24, begin, end)
        want = contact.contact_events_reference(layout, 0.24, begin, end)
        torch.cuda.synchronize()
        # A fresh capacity holds 16 rows a bead: the overfull cell's pairs
        # exceed it, and the tick runs again with more.
        rerun = len(want) > 16 * layout.n
        assert _launches("contact_tick") == before + 1 + rerun, name
        assert got.dtype == torch.int32 and (got[:, 2] == 1).all(), name
        assert _pair_set(got) == _pair_set(want), name
        if name == "one bead":
            assert got.shape == (0, 3)
        else:
            assert len(want) > 0, name


@pytest.mark.gpu
def test_contact_tick_overflow_reruns_and_two_launches_merge_equal(cuda_device):
    """A capacity too small: the tick grows it and searches again, and lists
    the plain version's pairs.  Two launches list rows in their own orders;
    the merged windows are equal to the bit."""
    from genome_cycle_tpu_torch.ops import contact

    layout = _layout(_beads(3000, seed=11), cuda_device)
    want = contact.contact_events_reference(layout, 0.24)
    capacity = contact.EventCapacity(64)
    before = _launches("contact_tick")
    got = contact.contact_events(layout, 0.24, capacity=capacity)
    torch.cuda.synchronize()
    assert _launches("contact_tick") == before + 2
    assert capacity.rows >= len(want) and capacity.rows % 4096 == 0
    assert _pair_set(got) == _pair_set(want)
    merged = []
    for _ in range(2):
        acc, rows = contact.empty_window_acc(4 * len(want), cuda_device)
        acc, rows, overflow = contact.merge_events_acc(
            acc, rows, contact.contact_events(layout, 0.24, capacity=capacity))
        assert overflow == 0
        merged.append(acc[:rows])
    assert torch.equal(*merged)
    assert _launches("contact_tick") == before + 4


def _rest_inputs(device, replicas=None, n=300, seed=31):
    """Positions around an ellipsoidal wall (inside, outside, a bead at the
    origin, one exactly on the wall), chains with tails and with bond and
    loop masks switched off in a run, a force buffer, weights; (R, N, 3) for
    ``replicas``, each with its own semiaxes."""
    from genome_cycle_tpu_torch.ops.step_rest import BondRows, WallRows

    rng = np.random.default_rng(seed)
    shape = (n, 3) if replicas is None else (replicas, n, 3)
    lead = () if replicas is None else (replicas,)
    semiaxes = (np.asarray([1.0, 0.9, 0.8]) * (1.0 + 0.05 * rng.uniform(size=lead + (1,))))
    directions = rng.normal(size=shape)
    directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
    scale = rng.uniform(0.0, 1.15, shape[:-1] + (1,))
    x = directions * semiaxes[..., None, :] * scale
    x[..., 0, :] = 0.0
    x[..., 1, :] = 0.0
    x[..., 1, 0] = semiaxes[..., 0]
    mask = np.ones(n, bool)
    loop = np.ones(n, bool)
    for tail in (119, 120, 299):              # chains [0, 120), [120, 121), [121, 300)
        mask[tail] = False
    for tail in (118, 119, 120, 298, 299):
        loop[tail] = False
    mask[50:60] = False
    loop[70:75] = False

    def t(v, dtype=torch.float32):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)

    bonds = BondRows(t(mask, torch.bool), t(rng.uniform(50, 100, n)),
                     t(rng.uniform(0.05, 0.08, n)), t(loop, torch.bool),
                     t(rng.uniform(1, 5, n)), 0.8)
    params = dict(a_energy=2.5, a_diameter=0.15 * 0.7, b_energy=2.5, b_diameter=0.12 * 0.7,
                  packing_spring=1000.0)
    wall = WallRows(t(semiaxes.reshape(lead + (3,))), t(rng.uniform(0.5, 1.0, n)),
                    t(rng.uniform(0.5, 5.5, n)), params)
    forces = t(rng.normal(0, 10.0, shape))
    return t(x), forces, bonds, wall


def _rest_plain(x, forces, bonds, wall):
    """The plain composition the rest kernel replaces
    (``step_rest.rest_reference``: ``shift_bond_forces`` for chain bonds and
    loops, the autograd wall), in float64 on the same inputs: the wall
    distance is a small difference near the wall, which a float32 evaluation
    rounds to about 1e-5 of max|F|."""
    from genome_cycle_tpu_torch.ops.step_rest import rest_reference

    wide = rest_reference(x.double(), forces.double(), bonds,
                          wall._replace(semiaxes=wall.semiaxes.double()), with_energy=True)
    return wide.out, wide.reaction, wide.bonded_energy, wide.wall_energy


def _assert_close(got, want, tol=1e-5):
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("replicas", [None, 4])
def test_rest_kernel_matches_plain_version(cuda_device, replicas):
    from genome_cycle_tpu_torch.ops import step_rest
    from genome_cycle_tpu_torch.ops.wall import wall_forces_reference

    x, forces, bonds, wall = _rest_inputs(cuda_device, replicas)
    before = _launches("step_rest")
    rest = step_rest.launch_rest(x, forces, bonds, wall, with_energy=True)
    again = step_rest.launch_rest(x, forces, bonds, wall, with_energy=True)
    f_p, r_p, eb_p, ew_p = _rest_plain(x, forces, bonds, wall)
    torch.cuda.synchronize()
    assert _launches("step_rest") == before + 2
    assert torch.isfinite(rest.out).all()
    _assert_close(rest.out, f_p)
    _assert_close(rest.reaction, r_p)
    assert float(rest.bonded_energy) == pytest.approx(float(eb_p), rel=1e-5)
    assert float(rest.wall_energy) == pytest.approx(float(ew_p), rel=1e-5)
    for a, b in zip(rest, again):                  # two launches, the same bits
        assert a is None or torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    # Masks off: the bonds alone, the wall alone.
    only_bonds = step_rest.launch_rest(x, bonds=bonds._replace(
        mask=torch.zeros_like(bonds.mask), loop_mask=torch.zeros_like(bonds.loop_mask)))
    only_wall = step_rest.launch_rest(x, wall=wall)
    torch.cuda.synchronize()
    assert not only_bonds.out.any() and only_bonds.reaction is None
    wide_wall = wall_forces_reference(x.double(), wall.semiaxes.double(), wall.a_mix,
                                      wall.b_mix, wall.params)[0]
    _assert_close(only_wall.out, wide_wall)
    assert not only_wall.out[..., 0, :].any()      # the bead at the origin
    # The bead on the wall: eps leaves it 1e-12 from the wall in float64.
    assert float(only_wall.out[..., 1, :].abs().max()) < 1e-6


def _with_nucleolus(x, bonds, device):
    """``bonds`` with nucleolar rows live on the beads of ``_rest_inputs``:
    NOR beads 5 and 200 bonded to two nucleolar particles each (290 to 293,
    stretched), and a droplet over those four and 294 to 296, all within its
    cutoff of each other; the positions moved to match."""
    from genome_cycle_tpu_torch.ops.step_rest import NucleolarRows, nucleolar_table

    rng = np.random.default_rng(41)
    x = x.clone()
    pairs = torch.tensor([[5, 290], [5, 291], [200, 292], [200, 293]], device=device)
    targets = torch.arange(290, 297, device=device)
    centre = x[..., 5:6, :]
    x[..., 290:297, :] = centre + torch.as_tensor(
        rng.uniform(-0.12, 0.12, tuple(x[..., 290:297, :].shape)), dtype=x.dtype, device=device)
    nucleolar = NucleolarRows(pairs, targets, 10.0, 0.05, 0.3, 0.2, 0.4,
                              nucleolar_table(pairs, targets))
    return x, bonds._replace(nucleolar=nucleolar)


@pytest.mark.gpu
@pytest.mark.parametrize("replicas", [None, 4])
def test_rest_kernel_with_nucleolar_rows_matches_plain_version(cuda_device, replicas):
    """NOR bonds and the droplet in the kernel's own rows, in place and fused
    with the update, against the plain version in float64; two launches the
    same bits; one launch a call."""
    from genome_cycle_tpu_torch.ops import integrator, step_rest

    x, forces, bonds, wall = _rest_inputs(cuda_device, replicas, seed=34)
    x, bonds = _with_nucleolus(x, bonds, cuda_device)
    f_p, r_p, eb_p, ew_p = _rest_plain(x, forces, bonds, wall)
    plain_bonds = _rest_plain(x, forces, bonds._replace(nucleolar=None), wall)[0]
    before = _launches("step_rest")
    got = [step_rest.rest(x, forces.clone(), bonds, wall, with_energy=True) for _ in range(2)]
    mobility = torch.as_tensor(np.random.default_rng(5).uniform(0.5, 2.0, x.shape[-2]),
                               dtype=torch.float32, device=cuda_device)
    update = step_rest.UpdateRows(mobility, torch.randn(x.shape, device=cuda_device), 1.0,
                                  1e-5, 1e-5 * 2e-4, (3e4, 2e4, 1e4))
    fused = step_rest.launch_rest(x, forces, bonds, wall, update)
    want = integrator.bd_update_reference(x, f_p, mobility, None,
                                          integrator.BDParams(1.0, 1e-5), noise=update.noise)
    torch.cuda.synchronize()
    assert _launches("step_rest") == before + 3
    assert float((f_p - plain_bonds).abs().max()) > 1e-2      # the nucleolar terms count
    for a, b in zip(got[0][:4], got[1][:4]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    _assert_close(got[0].out, f_p)
    _assert_close(got[0].reaction, r_p)
    assert float(got[0].bonded_energy) == pytest.approx(float(eb_p), rel=1e-5)
    assert float(got[0].wall_energy) == pytest.approx(float(ew_p), rel=1e-5)
    _assert_close(fused.out, want)
    _assert_close(fused.out - x, want - x, 1e-4)


@pytest.mark.gpu
def test_rest_kernel_keeps_its_tickets_per_stream(cuda_device):
    """Launches on two streams at once each find their own last block: the
    same reaction and energies as a launch alone."""
    from genome_cycle_tpu_torch.ops import step_rest

    x, forces, bonds, wall = _rest_inputs(cuda_device, 4)
    want = step_rest.launch_rest(x, forces, bonds, wall, with_energy=True)
    torch.cuda.synchronize()
    got = []
    for stream in (torch.cuda.current_stream(cuda_device), torch.cuda.Stream(cuda_device)):
        with torch.cuda.stream(stream):
            got.append(step_rest.launch_rest(x, forces, bonds, wall, with_energy=True))
    torch.cuda.synchronize()
    for rest in got:
        for a, b in zip(rest[:4], want[:4]):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("replicas", [None, 4])
@pytest.mark.parametrize("spacestep", [None, 1e-3])
def test_update_kernel_matches_plain_version(cuda_device, replicas, spacestep):
    from genome_cycle_tpu_torch.ops import integrator, step_rest

    x, forces, bonds, wall = _rest_inputs(cuda_device, replicas, seed=32)
    mobility = torch.as_tensor(np.random.default_rng(3).uniform(0.5, 2.0, x.shape[-2]),
                               dtype=torch.float32, device=cuda_device)
    noise = torch.randn(x.shape, device=cuda_device)
    params = integrator.BDParams(1.0, 1e-4, spacestep)
    before = _launches("bd_update")
    got = integrator.bd_update(x, forces * 100, mobility, None, params, noise=noise)
    again = integrator.bd_update(x, forces * 100, mobility, None, params, noise=noise)
    want = integrator.bd_update_reference(x, forces * 100, mobility, None, params, noise=noise)
    torch.cuda.synchronize()
    assert _launches("bd_update") == before + 2
    assert torch.equal(got, again)
    _assert_close(got, want)
    _assert_close(got - x, want - x, 1e-4)         # the displacement itself


@pytest.mark.gpu
@pytest.mark.parametrize("replicas", [None, 4])
def test_fused_g1_update_matches_plain_composition(cuda_device, replicas):
    """Bonds + wall + update + wall ODE in one launch against the plain
    composition on the same noise."""
    from genome_cycle_tpu_torch.ops import integrator, step_rest

    x, forces, bonds, wall = _rest_inputs(cuda_device, replicas, seed=33)
    mobility = torch.as_tensor(np.random.default_rng(4).uniform(0.5, 2.0, x.shape[-2]),
                               dtype=torch.float32, device=cuda_device)
    noise = torch.randn(x.shape, device=cuda_device)
    spring = (3e4, 2e4, 1e4)
    update = step_rest.UpdateRows(mobility, noise, 1.0, 1e-5, 1e-5 * 2e-4, spring)
    rest = step_rest.launch_rest(x, forces, bonds, wall, update)
    again = step_rest.launch_rest(x, forces, bonds, wall, update)
    f_p, r_p, _, _ = _rest_plain(x, forces, bonds, wall)
    want = integrator.bd_update_reference(x, f_p, mobility, None,
                                          integrator.BDParams(1.0, 1e-5), noise=noise)
    springs = torch.as_tensor(spring, device=cuda_device)
    semi = wall.semiaxes + 1e-5 * 2e-4 * (r_p - springs * wall.semiaxes)
    torch.cuda.synchronize()
    assert torch.equal(rest.out, again.out) and torch.equal(rest.semiaxes, again.semiaxes)
    _assert_close(rest.out, want)
    _assert_close(rest.out - x, want - x, 1e-4)
    _assert_close(rest.semiaxes, semi)


@pytest.mark.gpu
def test_step_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """Wrong dtype, device or contiguity raise; nothing falls back to the
    plain version."""
    from genome_cycle_tpu_torch.ops import contact, integrator, step_rest
    from genome_cycle_tpu_torch.ops.wall import wall_forces

    x, forces, bonds, wall = _rest_inputs(cuda_device)
    with pytest.raises(TypeError):
        step_rest.launch_rest(x.double(), forces, bonds, wall)
    with pytest.raises(ValueError):
        step_rest.launch_rest(x, forces.t().contiguous().t(), bonds, wall)
    with pytest.raises(ValueError):
        step_rest.launch_rest(x.cpu(), forces.cpu())
    with pytest.raises(ValueError):                 # weights on another device
        wall_forces(x, wall.semiaxes, wall.a_mix.cpu(), wall.b_mix, wall.params)
    with pytest.raises(TypeError):
        integrator.bd_update(x.double(), forces.double(), wall.a_mix, None,
                             integrator.BDParams(1.0, 1e-4), noise=forces.double())
    with pytest.raises(ValueError):
        integrator.bd_update(x, forces, wall.a_mix[:10], None,
                             integrator.BDParams(1.0, 1e-4), noise=forces)
    layout = _layout(_beads(100, seed=12), cuda_device)
    with pytest.raises(TypeError):
        contact.contact_events(layout._replace(xyz=layout.xyz.double()), 0.24)
    with pytest.raises(ValueError):
        contact.contact_events(layout, 0.31)



# -- the mitotic chunk kernel ---------------------------------------------------

def _mitotic_store(tmp_path, **fields):
    """A store prepared for a small design, a 300- and a 200-bead chain with
    a centromere each, coarse-grained by 10 (that of
    tests/test_torch_mitotic.py), ``fields`` added to its mitotic phase."""
    import json

    from genome_cycle_tpu_torch.models.prepare import run_prepare
    from genome_cycle_tpu_torch.store import MemoryStore

    config = {"mitotic_phase": {"coarse_graining": 10, "kfiber_length_anaphase": 0.2,
                                "kfiber_length_prometaphase": 0.1,
                                "telophase_bond_spring_multiplier": 0.5,
                                "telophase_bending_energy_multiplier": 2.0, **fields}}
    (tmp_path / "config.json").write_text(json.dumps(config))
    rows = ["chain\tstart\tend\tA\tB\ttags"]
    for name, beads, cen in (("chr1:a", 300, (140, 160)), ("chr2:a", 200, (90, 110))):
        for i in range(beads):
            tag, a, b = ("cen,B", 0, 1) if cen[0] <= i < cen[1] else (
                ("A", 1, 0) if i % 2 == 0 else ("B", 0, 1))
            rows.append(f"{name}\t{i * 100000}\t{(i + 1) * 100000}\t{a}\t{b}\t{tag}")
    (tmp_path / "chains.tsv").write_text("\n".join(rows) + "\n")
    store = MemoryStore()
    run_prepare(store, str(tmp_path / "config.json"), str(tmp_path / "chains.tsv"), seed=42,
                log=lambda m: None)
    return store


def _mitotic_phase(tmp_path, device, phase, **fields):
    """(model, terms, start positions) of ``phase`` on ``device`` for the
    design of :func:`_mitotic_store`: rods for the anaphase, rods next to the
    pole for the telophase; for the prometaphase each target chromatid a walk
    of 0.3 steps, its sister 0.3 beside it."""
    from genome_cycle_tpu_torch.models.anatelophase import AnatelophaseModel
    from genome_cycle_tpu_torch.models.prometaphase import PrometaphaseModel

    store = _mitotic_store(tmp_path, **fields)
    rng = np.random.default_rng(7)
    if phase != "prometaphase":
        design = store.load_anatelophase_design()
        model = AnatelophaseModel.from_design(design, store.load_config(), device)
        x = model.initial_rods(rng, design.chains)
        if phase == "telophase":
            x = x + [0.0, 5.0, 0.0]
        terms = model.mitotic_terms(phase == "telophase")
    else:
        design = store.load_prometaphase_design()
        model = PrometaphaseModel.from_design(design, store.load_config(), device)
        x = np.zeros((model.n, 3))
        for target, sister in design.sister_chromatids:
            t, s = design.chains[int(target)], design.chains[int(sister)]
            steps = rng.normal(size=(t.end - t.start, 3))
            walk = 0.3 * np.cumsum(steps / np.linalg.norm(steps, axis=1, keepdims=True), axis=0)
            x[t.start:t.end] = walk - walk.mean(axis=0)
            x[s.start:s.end] = x[t.start:t.end] - [0.0, 0.3, 0.0]
        terms = model.mitotic_terms()
    return model, terms, torch.as_tensor(x, dtype=torch.float32, device=device)


MITOTIC_PHASES = [("anaphase", {}), ("telophase", {}), ("prometaphase", {}),
                  ("prometaphase", {"polar_ejection_force": 40.0,
                                    "polar_ejection_cross_section": 0.5})]
MITOTIC_IDS = ["anaphase", "telophase", "prometaphase", "prometaphase-ejection"]


@pytest.mark.gpu
@pytest.mark.parametrize("phase, fields", MITOTIC_PHASES, ids=MITOTIC_IDS)
def test_mitotic_chunk_kernel_matches_plain_version_at_temperature_0(
        cuda_device, tmp_path, phase, fields):
    """200 steps in one launch against 200 plain steps on the card, within
    1e-4 (coordinates of order 1 to 10, float32 sums in another order)."""
    from genome_cycle_tpu_torch.ops import mitotic

    model, terms, x = _mitotic_phase(tmp_path, cuda_device, phase, temperature=0.0, **fields)
    noise = torch.randn((200, model.n, 3), device=cuda_device)
    before = _launches("mitotic_chunk")
    got = mitotic.run_chunk(x, terms, model.mobility, noise, 0.0, model.config.timestep)
    want = mitotic.run_chunk_reference(x, terms.forces, model.mobility, noise, 0.0,
                                       model.config.timestep)
    torch.cuda.synchronize()
    assert _launches("mitotic_chunk") == before + 1
    assert float((want - x).abs().max()) > 0.05
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("phase, fields", MITOTIC_PHASES, ids=MITOTIC_IDS)
def test_mitotic_chunk_kernel_one_step_with_handed_in_noise(cuda_device, tmp_path, phase, fields):
    """One step at temperature 1 on the same standard normals, within 1e-5."""
    from genome_cycle_tpu_torch.ops import mitotic

    model, terms, x = _mitotic_phase(tmp_path, cuda_device, phase, temperature=1.0, **fields)
    noise = torch.randn((1, model.n, 3), device=cuda_device)
    got = mitotic.run_chunk(x, terms, model.mobility, noise, 1.0, model.config.timestep)
    want = mitotic.run_chunk_reference(x, terms.forces, model.mobility, noise, 1.0,
                                       model.config.timestep)
    forces = mitotic.forces_from_terms_reference(x, terms)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5
    assert float((forces - terms.forces(x)).abs().max()) <= 1e-5 * float(forces.abs().max())


@pytest.mark.gpu
def test_mitotic_chunk_kernel_two_launches_are_bitwise_equal(cuda_device, tmp_path):
    from genome_cycle_tpu_torch.ops import mitotic

    model, terms, x = _mitotic_phase(tmp_path, cuda_device, "prometaphase", temperature=1.0,
                                     polar_ejection_force=40.0, polar_ejection_cross_section=0.5)
    noise = torch.randn((500, model.n, 3), device=cuda_device)
    runs = [mitotic.run_chunk(x, terms, model.mobility, noise, 1.0, 1e-4) for _ in range(2)]
    torch.cuda.synchronize()
    assert float((runs[0] - x).abs().max()) > 0.01
    assert torch.equal(runs[0], runs[1])


@pytest.mark.gpu
def test_mitotic_chunk_kernel_refuses_a_system_past_its_capacity(cuda_device, tmp_path):
    """A system larger than the cluster's shared memory holds raises, with
    the capacity in the message; so do other inputs the kernel does not take.
    Nothing falls back to the plain version."""
    from genome_cycle_tpu_torch.ops import mitotic

    model, terms, x = _mitotic_phase(tmp_path, cuda_device, "anaphase")
    n = mitotic.device_capacity(cuda_device) + 1
    big = terms._replace(table=torch.zeros((n, 1, 4), dtype=torch.int32, device=cuda_device))
    before = _launches("mitotic_chunk")
    with pytest.raises(ValueError, match="holds at most"):
        mitotic.run_chunk(torch.zeros((n, 3), device=cuda_device), big,
                          torch.ones(n, device=cuda_device),
                          torch.zeros((2, n, 3), device=cuda_device), 1.0, 1e-4)
    assert _launches("mitotic_chunk") == before
    noise = torch.zeros((2, model.n, 3), device=cuda_device)
    with pytest.raises(TypeError):
        mitotic.run_chunk(x.double(), terms, model.mobility, noise, 1.0, 1e-4)
    with pytest.raises(ValueError):
        mitotic.run_chunk(x, terms, model.mobility, noise.cpu(), 1.0, 1e-4)


@pytest.mark.gpu
def test_mitotic_frames_written_while_the_next_chunk_runs_equal_a_serial_loop(
        cuda_device, tmp_path):
    """A short anaphase + telophase through ``run_anatelophase``, which writes
    each frame while the next chunk runs, stores the frames of a serial loop
    (chunk, ``.cpu()``, write) bit for bit and ends in its state; a stage of
    n chunks counts n frames under ``mitotic.frames_overlapped``."""
    from genome_cycle_tpu_torch.models.anatelophase import (
        AnatelophaseModel, run_anatelophase, seeded_generator,
    )
    from genome_cycle_tpu_torch.store import MemoryStore

    store = _mitotic_store(tmp_path, anaphase_steps=600, telophase_steps=300,
                           sampling_interval=50, logging_interval=100)
    design = store.load_anatelophase_design()
    model = AnatelophaseModel.from_design(design, store.load_config(), cuda_device)
    m = model.config
    stages = (("anaphase", False, m.anaphase_steps, design.seed),
              ("telophase", True, m.telophase_steps, design.seed + 1))

    want = MemoryStore()
    x = torch.as_tensor(model.initial_rods(np.random.default_rng(design.seed), design.chains),
                        dtype=torch.float32, device=cuda_device)
    for stage, telophase, steps, seed in stages:
        want.set_stage(stage)
        state = (x, seeded_generator(seed, cuda_device))
        for k in range(steps // m.sampling_interval + 1):
            if k:
                state = model.run_chunk(state, m.sampling_interval, telophase)
            want.save_positions(k * m.sampling_interval, state[0].cpu().numpy())
            want.append_frame(k * m.sampling_interval)
        x = state[0]

    marks, clear = [], store.clear_frames

    def clear_frames():
        marks.append(tracing.counters().get("mitotic.frames_overlapped", 0))
        clear()

    store.clear_frames = clear_frames
    final = run_anatelophase(store, log=lambda line: None, device=cuda_device)
    marks.append(tracing.counters().get("mitotic.frames_overlapped", 0))

    assert np.array_equal(final, x.cpu().numpy())
    for stage, _, steps, _ in stages:
        store.set_stage(stage)
        want.set_stage(stage)
        assert store.load_steps() == want.load_steps() == list(
            range(0, steps + 1, m.sampling_interval))
        for step in want.load_steps():
            assert np.array_equal(store.load_positions(step), want.load_positions(step))
    assert np.diff(marks).tolist() == [s[2] // m.sampling_interval for s in stages]


# ---- the G1 step as one CUDA graph replay (models/g1_graph.py) ---------------

G1_FRAME = 20      # sampling_interval and tick interval: ticks and frames at 20, 40
G1_STEPS = 45


def _g1_model(device, replicas, n=3000, seed=3):
    """A chain of ``n`` beads with loops, ten NOR bonds onto ten nucleolar
    particles (a droplet among them), on the card through the cell-range
    path; ``replicas`` random-walk starts inside the wall, their generators
    seeded apart."""
    from genome_cycle_tpu_torch.config import InterphaseConfig
    from genome_cycle_tpu_torch.models import interphase as tinter

    chain = n - 10
    rng = np.random.default_rng(seed)
    af = (np.arange(n) % 2).astype(np.float64)
    af[chain:] = 0.0
    bonded = np.arange(n) < chain - 1
    looped = np.arange(n) < chain - 2
    rows = np.arange(chain - 1)
    nuc = np.stack([np.arange(10) * (chain // 10), chain + np.arange(10)], 1)
    arrays = dict(
        af=af, bf=1.0 - af, mobility=np.ones(n),
        bond_pairs=np.stack([rows, rows + 1], 1), bond_spring=np.full(chain - 1, 40.0),
        bond_length=np.full(chain - 1, 0.05),
        loop_pairs=np.stack([rows[:-1], rows[:-1] + 2], 1), loop_spring=np.full(chain - 2, 5.0),
        bond_mask=bonded, bond_k_row=np.where(bonded, 40.0, 0.0),
        bond_l_row=np.where(bonded, 0.05, 0.0), loop_mask=looped,
        loop_k_row=np.where(looped, 5.0, 0.0), nuc_bonds=nuc.astype(np.int64),
        nuc_targets=np.unique(nuc[:, 1]).astype(np.int64))
    config = InterphaseConfig(sampling_interval=G1_FRAME, contactmap_update_interval=G1_FRAME)
    model = tinter.InterphaseModel(config, arrays, tinter.EngineSettings(brute_force_threshold=0),
                                   device)
    walks = []
    for _ in range(replicas):
        walk = np.cumsum(rng.normal(scale=0.03, size=(n, 3)), axis=0)
        walks.append(1.2 * walk / np.abs(walk).max())
    x = torch.as_tensor(np.stack(walks) if replicas > 1 else walks[0], dtype=torch.float32,
                        device=device)
    model.update_bound(float(x.abs().max()))
    semiaxes = torch.as_tensor(config.wall_semiaxes_init, dtype=torch.float32, device=device)
    if replicas > 1:
        semiaxes = semiaxes.expand(replicas, 3).contiguous()
    return model, x, semiaxes


def _generators(device, replicas, seed=11):
    gens = [torch.Generator(device=device).manual_seed(seed + r) for r in range(replicas)]
    return gens if replicas > 1 else gens[0]


def _states(generators):
    gens = generators if isinstance(generators, list) else [generators]
    return [g.get_state() for g in gens]


@pytest.mark.gpu
@pytest.mark.parametrize("replicas", [1, 4])
def test_g1_graph_matches_the_eager_step_to_the_bit_on_handed_in_noise(cuda_device, replicas):
    """45 G1 steps on handed-in noise, through two ticks and two frames, the
    grid's bound moved at the first frame (one capture anew): the replays
    give the eager step's positions and semiaxes to the bit, and the ticks
    its pairs; 45 replays, 2 captures, no eager step."""
    model, x, semiaxes = _g1_model(cuda_device, replicas)
    noise_gen = torch.Generator(device=cuda_device).manual_seed(5)
    graph = eager = (x, _generators(cuda_device, replicas), semiaxes)
    before = tracing.counters()
    for step in range(1, G1_STEPS + 1):
        noise = torch.randn(x.shape, generator=noise_gen, device=cuda_device)
        graph = model._bd_step4(graph, step, noise)
        eager = model._eager_step(eager, step, noise)
        assert torch.equal(graph[0], eager[0]) and torch.equal(graph[2], eager[2]), step
        if step % G1_FRAME == 0:
            assert _pair_set(model.contact_events_tick(graph[0], step)) == _pair_set(
                model.contact_events_tick(eager[0], step))
            if step == G1_FRAME:
                model.bound += 1.0
    assert float((graph[0] - x).abs().max()) > 1e-3
    since = tracing.counters_since(before)
    assert since["graph.step_replays"] == G1_STEPS
    assert since["graph.step_captures"] == 2
    assert since.get("graph.step_eager", 0) == 0
    for kernel in ("ab_pair_forces", "cell_layout", "step_rest"):
        assert since["launch." + kernel] >= G1_STEPS


@pytest.mark.gpu
@pytest.mark.parametrize("replicas", [1, 4])
def test_g1_graph_draws_what_the_generators_draw_eagerly(cuda_device, replicas):
    """Replays that draw their own noise follow the eager steps on generators
    seeded alike to the bit over 45 steps, and leave the generators in the
    eager run's states; two replays from one state draw different normals."""
    model, x, semiaxes = _g1_model(cuda_device, replicas)
    gens_graph, gens_eager = (_generators(cuda_device, replicas) for _ in range(2))
    graph, eager = (x, gens_graph, semiaxes), (x, gens_eager, semiaxes)
    for step in range(1, G1_STEPS + 1):
        graph = model._bd_step4(graph, step)
        eager = model._eager_step(eager, step)
    assert torch.equal(graph[0], eager[0]) and torch.equal(graph[2], eager[2])
    for a, b in zip(_states(gens_graph), _states(gens_eager)):
        assert torch.equal(a, b)
    start = (graph[0].clone(), gens_graph, graph[2].clone())
    first = model._bd_step4(start, G1_STEPS + 1)[0].clone()
    second = model._bd_step4(start, G1_STEPS + 1)[0]
    assert not torch.equal(first, second)
    assert torch.isfinite(second).all()


@pytest.mark.gpu
@pytest.mark.parametrize("replicas", [1, 4])
def test_g1_graph_resumes_from_a_checkpoint_as_the_eager_step_does(cuda_device, replicas):
    """A checkpoint after 30 replays (positions, semiaxes, generator states
    on the host), resumed into the same generators through replays and into
    fresh ones through the eager step, continues as the uninterrupted run
    does, to the bit."""
    model, x, semiaxes = _g1_model(cuda_device, replicas)
    gens = _generators(cuda_device, replicas)
    state = (x, gens, semiaxes)
    for step in range(1, 31):
        state = model._bd_step4(state, step)
    saved = (state[0].cpu(), state[2].cpu(), _states(gens))
    for step in range(31, G1_STEPS + 1):
        state = model._bd_step4(state, step)
    through = (state[0].clone(), state[2].clone())

    def resumed(generators):
        for g, s in zip(generators if isinstance(generators, list) else [generators], saved[2]):
            g.set_state(s)
        return (saved[0].to(cuda_device), generators, saved[1].to(cuda_device))

    again = resumed(gens)
    eager = resumed(_generators(cuda_device, replicas, seed=99))
    for step in range(31, G1_STEPS + 1):
        again = model._bd_step4(again, step)
        eager = model._eager_step(eager, step)
    for got in (again, eager):
        assert torch.equal(got[0], through[0]) and torch.equal(got[2], through[1])
