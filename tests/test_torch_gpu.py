"""The CUDA pair-force kernels against their plain version, on the card, and
the interphase step through the kernel against the C++ surrogate.

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


@pytest.mark.gpu
def test_contact_map_pearson_vs_surrogate_through_the_kernel(
        cuda_device, surrogate_exe, tmp_path):  # noqa: F811
    """The gate of tests/test_torch_correlation.py with the port's steps on
    the card: every pair force comes from the CUDA kernel."""
    before = pk.ab_pair_forces.launches
    gate.contact_map_gate(surrogate_exe, tmp_path, cuda_device)
    assert pk.ab_pair_forces.launches - before == gate.REPLICAS * gate.STEPS
