"""The nucleolus-bearing configuration of the port through the statistical
gate against the C++ surrogate (the twin of
tests/test_correlation.py::test_nucleolus_droplet_vs_surrogate).

Engines, sizes, replicas and thresholds are those of the JAX gate; see
tests/test_torch_correlation.py for the set-up, which this file shares.
"""

import numpy as np
import pytest
import torch

import test_torch_correlation as gate
from test_torch_correlation import surrogate_exe  # noqa: F401  (fixture)

torch.set_num_threads(1)

N, N_SITES, NUC_REPLICAS = gate.N, gate.N_SITES, gate.NUC_REPLICAS


def test_nucleolus_droplet_vs_surrogate(surrogate_exe, tmp_path):
    """The nucleolus-bearing configuration through the same gate: NOR
    semispring bonds, the softwell droplet and the (0, 10) nucleolar a/b
    factors are live in both engines; besides the map, the droplet's radius of
    gyration and the NOR-bond length are gated."""
    x0 = gate.with_nucleoli(gate.walk_init(N, gate.CHAINS))
    n_tot = len(x0)
    sites = np.asarray(gate.nor_sites(N_SITES)).repeat(2)

    ref_map = np.zeros((n_tot, n_tot))
    ref_nuc_rg, ref_nuc_bond = [], []
    for s in range(NUC_REPLICAS):
        coo, stats = gate.run_surrogate(surrogate_exe, x0, tmp_path, 5252 + s, n_sites=N_SITES)
        ref_map += gate.dense_map(coo, n_tot)
        ref_nuc_rg.append(stats["nuc_rg"])
        ref_nuc_bond.append(stats["nuc_bond_r2_mean"])

    port_map = np.zeros((n_tot, n_tot))
    port_nuc_rg, port_nuc_bond = [], []
    for s in range(NUC_REPLICAS):
        coo, _, _, x_final = gate.run_port_engine(x0, 888 + s, "cpu", n_sites=N_SITES)
        port_map += gate.dense_map(coo, n_tot)
        nuc = x_final[N:]
        c = nuc.mean(axis=0)
        port_nuc_rg.append(float(np.sqrt(np.mean(np.sum((nuc - c) ** 2, 1)))))
        port_nuc_bond.append(float(np.mean(np.sum((x_final[sites] - nuc) ** 2, axis=1))))

    iu, ju = np.triu_indices(n_tot, k=1)
    r = float(np.corrcoef(ref_map[iu, ju], port_map[iu, ju])[0, 1])
    ratio = port_map.sum() / max(ref_map.sum(), 1)
    print(f"nucleolus gate: map r = {r:.4f}, event ratio {ratio:.3f}")
    assert r >= 0.95
    assert 0.85 < ratio < 1.15

    # Droplet clustering: without the softwell the nucleolar Rg tracks the
    # NOR spread, several-fold larger.
    rr, pr = float(np.mean(ref_nuc_rg)), float(np.mean(port_nuc_rg))
    print(f"nucleolar Rg: ref={rr:.4f} port={pr:.4f}")
    assert pr == pytest.approx(rr, rel=0.25)

    # NOR-bond stretch equilibrium.
    rb, pb = float(np.mean(ref_nuc_bond)), float(np.mean(port_nuc_bond))
    print(f"NOR-bond <r^2>: ref={rb:.5f} port={pb:.5f}")
    assert pb == pytest.approx(rb, rel=0.25)
