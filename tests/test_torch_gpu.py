"""The CUDA pair-force kernel against its plain version, on the card.

These tests need a CUDA card and ``nvcc`` and skip where there is none.  The
file imports only torch and the port, so that it also runs on a machine
without JAX:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerance: max|dF| <= 1e-4 * max(|F|, 1) (float32 sums in another order),
energy 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from genome_cycle_tpu_torch.ops import pair_kernels as pk


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


@pytest.mark.gpu
@pytest.mark.parametrize("core_scale", [0.5, 1.0])
def test_cuda_kernel_matches_plain_version(cuda_device, core_scale):
    x, af, bf = _beads(3000, seed=11)
    layout = pk.build_cell_layout(
        torch.as_tensor(x, device=cuda_device), torch.as_tensor(af, device=cuda_device),
        torch.as_tensor(bf, device=cuda_device), 1.2, 0.3,
    )
    kparams = _kparams(core_scale)
    before = pk.ab_pair_forces.launches
    f, e = pk.ab_pair_forces(layout, kparams, with_energy=True)
    torch.cuda.synchronize()
    assert pk.ab_pair_forces.launches == before + 1
    f_ref, e_ref = pk.ab_pair_forces_reference(layout, kparams, with_energy=True)
    err = float((f - f_ref).abs().max())
    assert err <= 1e-4 * max(float(f_ref.abs().max()), 1.0)
    assert float(e) == pytest.approx(float(e_ref), rel=1e-5)


@pytest.mark.gpu
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x, af, bf = _beads(100, seed=12)
    layout = pk.build_cell_layout(
        torch.as_tensor(x, device=cuda_device), torch.as_tensor(af, device=cuda_device),
        torch.as_tensor(bf, device=cuda_device), 1.2, 0.3,
    )
    with pytest.raises(TypeError):
        pk.ab_pair_forces(layout._replace(xyz=layout.xyz.double()), _kparams(1.0))
    with pytest.raises(ValueError):
        pk.ab_pair_forces(layout._replace(ab=layout.ab.t().contiguous().t()), _kparams(1.0))
    with pytest.raises(ValueError):
        pk.ab_pair_forces(layout._replace(cell_start=layout.cell_start[:-1]), _kparams(1.0))
