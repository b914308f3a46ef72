"""The nucleolus-bearing configuration of the port through the statistical
gate against the C++ surrogate (the twin of
tests/test_correlation.py::test_nucleolus_droplet_vs_surrogate).

Engines, sizes, replicas and thresholds are those of the JAX gate; the gate
is ``test_torch_correlation.nucleolus_gate``, which ``chip_smoke.py`` (phase
"gate") also runs through the CUDA kernel.  On the CPU it takes minutes, so
the test is marked ``slow``.
"""

import pytest
import torch

import test_torch_correlation as gate
from test_torch_correlation import surrogate_exe  # noqa: F401  (fixture)

torch.set_num_threads(1)


@pytest.mark.slow
def test_nucleolus_droplet_vs_surrogate(surrogate_exe, tmp_path):  # noqa: F811
    """NOR semispring bonds, the softwell droplet and the (0, 10) nucleolar
    a/b factors live in both engines; besides the map, the droplet's radius
    of gyration and the NOR-bond length are gated."""
    gate.nucleolus_gate(surrogate_exe, tmp_path, "cpu")
