"""The port's interphase step through the statistical gate against the C++
surrogate (the twin of tests/test_correlation.py, which gates the JAX package).

``genome_cycle_tpu/native/surrogate_ref.cpp`` re-implements the complete G1
step with the reference's semantics and defaults in single-threaded C++.  Both
engines integrate the SAME small system from the SAME initial structure with
independent random numbers at temperature 1; their time-integrated contact
maps must agree to Pearson r >= 0.95, and equilibrium statistics (bond-length
second moment, radius of gyration, contact probability against separation)
must match within the tolerances of the JAX gate: 10 % (25 % for the
nucleolar droplet's), 0.15 in log10 per octave of P(s).

The port runs its production formulation: the cell-range pair force and the
contact tick over the sorted layout (``brute_force_threshold=0``), on the CPU
through the plain versions.  The nucleolus-bearing variant of the gate is in
tests/test_torch_correlation_nucleolus.py, a file of its own so that the two
run side by side.  This file imports neither JAX nor the JAX package, so
tests/test_torch_gpu.py can run the same gate through the CUDA kernel on a
machine that has only torch.
"""

import json
import pathlib
import subprocess

import numpy as np
import pytest
import torch

from genome_cycle_tpu_torch import convert
from genome_cycle_tpu_torch.config import parse_config
from genome_cycle_tpu_torch.models.interphase import EngineSettings, InterphaseModel
from genome_cycle_tpu_torch.ops.contact import events_to_host, merge_window
from genome_cycle_tpu_torch.store import StageDesign
from genome_cycle_tpu_torch.topology import ChainAssignment

REPO = pathlib.Path(__file__).resolve().parents[1]

# The suite runs in several worker processes at once (sizes here are tiny).
torch.set_num_threads(1)

N, CHAINS = 600, 2
STEPS, BURNIN, CHUNK = 6000, 2000, 1000
# Contact maps of SINGLE runs decorrelate from the shared initial structure,
# so two matched engines only agree to r ~ 0.88 run against run.  Summing an
# ensemble of short runs averages the configuration-specific part away (six
# surrogate replicas against six more reach r = 0.978), so the 0.95 gate has
# headroom against noise while still failing on a force-field discrepancy.
REPLICAS = 6
N_SITES = 6  # -> 12 nucleolar particles (2 per active NOR, config default)
NUC_REPLICAS = 4


@pytest.fixture(scope="module")
def surrogate_exe(tmp_path_factory):
    exe = tmp_path_factory.mktemp("native") / "surrogate_ref"
    src = REPO / "genome_cycle_tpu" / "native" / "surrogate_ref.cpp"
    subprocess.run(
        ["g++", "-O2", "-march=native", "-funsafe-math-optimizations",
         "-std=c++17", "-o", str(exe), str(src)],
        check=True, capture_output=True,
    )
    return exe


def walk_init(n, chains, radius=0.8, bond_rms=0.1, seed=11):
    """Chains as ball-confined Gaussian random walks at the equilibrium bond
    length; a walk that leaves the ball is mirrored back across its surface.
    The same numbers as the JAX gate's start (numpy's generator, same seed)."""
    rng = np.random.default_rng(seed)
    per = n // chains
    out = np.empty((per * chains, 3), np.float32)
    sigma = bond_rms / np.sqrt(3.0)
    for c in range(chains):
        steps = rng.normal(0.0, sigma, size=(per, 3))
        start_dir = rng.normal(size=3)
        start_dir /= np.linalg.norm(start_dir)
        walk = np.empty((per, 3))
        walk[0] = start_dir * radius * rng.uniform(0, 0.9) ** (1 / 3)
        for i in range(1, per):
            q = walk[i - 1] + steps[i]
            r = np.sqrt(q @ q)
            if r > radius:
                q *= (2.0 * radius - r) / r
            walk[i] = q
        out[c * per: (c + 1) * per] = walk
    return out


def nor_sites(n_sites):
    return [(t + 1) * N // (n_sites + 1) for t in range(n_sites)]


def with_nucleoli(x0c):
    """The chain start plus two nucleolar particles beside each NOR site."""
    rows = [
        x0c[site] + np.asarray([0.03 * (u + 1), 0.02, 0.01], np.float32)
        for site in nor_sites(N_SITES) for u in range(2)
    ]
    return np.concatenate([x0c, np.asarray(rows, np.float32)])


def make_model(device, n_sites=0):
    """Synthetic interphase model: CHAINS chains of alternating A and B beads;
    ``n_sites`` > 0 appends two nucleolar particles per site, the layout the
    surrogate's nucleolus mode mirrors."""
    per = N // CHAINS
    chains = [
        ChainAssignment(f"chr{i}:a", i * per, (i + 1) * per, kinetochore=None)
        for i in range(CHAINS)
    ]
    ab = np.zeros((N, 2))
    ab[::2, 0] = 1.0
    ab[1::2, 1] = 1.0
    bonds = [(site, N + 2 * t + u) for t, site in enumerate(nor_sites(n_sites))
             for u in range(2)]
    if bonds:
        ab = np.concatenate([ab, np.tile([0.0, 10.0], (len(bonds), 1))])  # nucleolus_ab_factor
    design = StageDesign(
        seed=1, chains=chains, ab_factors=ab,
        nucleolar_bonds=np.asarray(bonds, np.int64).reshape(-1, 2),
    )
    config = parse_config(json.dumps({"interphase": {"temperature": 1.0}}))
    settings = EngineSettings(brute_force_threshold=0, dense_bound=2.0)
    return InterphaseModel.from_design(design, config, settings, device)


def dense_map(coo, n):
    m = np.zeros((n, n))
    np.add.at(m, (coo[:, 0], coo[:, 1]), coo[:, 2])
    return m


def run_port_engine(x0, seed, device, n_sites=0):
    """STEPS G1 steps of the port from ``x0``; contacts of the ticks after the
    burn-in, merged.  Returns (coo, bond <r^2>, Rg, final positions)."""
    model = make_model(device, n_sites)
    assert model.n == len(x0) and model.use_droplet == (n_sites > 0)
    assert model.n > model.settings.brute_force_threshold       # the cell-range path
    tick = model.config.contactmap_update_interval
    state = convert.state_from_numpy(x0, [2.0, 2.0, 2.0], seed=seed, device=device)
    window = []
    for step in range(1, STEPS + 1):
        state = model._bd_step4(state, step)
        if step % tick == 0 and step > BURNIN:
            window.append(events_to_host(model.contact_events_tick(state[0], step)))
        if step % CHUNK == 0:
            model.update_bound(float(state[0].abs().max()))
    coo = merge_window(window)
    x_final = state[0].cpu().numpy()
    per = N // CHAINS
    bonds = np.concatenate([
        np.sum(np.diff(x_final[c * per: (c + 1) * per], axis=0) ** 2, axis=1)
        for c in range(CHAINS)
    ])
    center = x_final.mean(axis=0)
    rg = float(np.sqrt(np.mean(np.sum((x_final - center) ** 2, axis=1))))
    return coo, float(bonds.mean()), rg, x_final


def run_surrogate(exe, x0, tmp_path, seed, n_sites=0):
    init = tmp_path / "init.txt"
    np.savetxt(init, x0, fmt="%.7f")
    out = tmp_path / "ref_contacts.tsv"
    proc = subprocess.run(
        [str(exe), str(init), str(len(x0)), str(CHAINS), str(STEPS),
         str(BURNIN), str(seed), str(out), str(n_sites)],
        check=True, capture_output=True, text=True, timeout=600,
    )
    stats = json.loads(proc.stdout.strip())
    data = np.loadtxt(out, dtype=np.int64).reshape(-1, 3)
    return data, stats


def contact_map_gate(surrogate_exe, tmp_path, device):
    """The gate of the chain-only system; shared with the card's test."""
    x0 = walk_init(N, CHAINS)

    ref_map = np.zeros((N, N))
    ref_bonds, ref_rgs = [], []
    for s in range(REPLICAS):
        coo, stats = run_surrogate(surrogate_exe, x0, tmp_path, 4242 + s)
        ref_map += dense_map(coo, N)
        ref_bonds.append(stats["bond_r2_mean"])
        ref_rgs.append(stats["rg"])

    port_map = np.zeros((N, N))
    port_bonds, port_rgs = [], []
    for s in range(REPLICAS):
        coo, bond_r2, rg, _ = run_port_engine(x0, 777 + s, device)
        port_map += dense_map(coo, N)
        port_bonds.append(bond_r2)
        port_rgs.append(rg)

    iu, ju = np.triu_indices(N, k=1)
    a, b = ref_map[iu, ju], port_map[iu, ju]
    r = float(np.corrcoef(a, b)[0, 1])
    total_ratio = port_map.sum() / max(ref_map.sum(), 1)
    print(f"contact-map Pearson r = {r:.4f}  (events ref={int(ref_map.sum())}, "
          f"port={int(port_map.sum())}, ratio {total_ratio:.3f})")
    assert r >= 0.95

    # Total contact activity within 10% (same physics, independent noise).
    assert 0.9 < total_ratio < 1.1

    # Bond-length second moment: equilibrium thermal value, both engines.
    print(f"bond <r^2>: ref={np.mean(ref_bonds):.5f} port={np.mean(port_bonds):.5f}")
    assert np.mean(port_bonds) == pytest.approx(np.mean(ref_bonds), rel=0.1)

    # Radius of gyration of the final structure.
    print(f"Rg: ref={np.mean(ref_rgs):.4f} port={np.mean(port_rgs):.4f}")
    assert np.mean(port_rgs) == pytest.approx(np.mean(ref_rgs), rel=0.1)

    # Contact probability against separation P(s), octave-binned (single
    # separations are count noise); the truncated last octave is dropped
    # (chain ends are configuration-specific).
    sep = ju - iu
    max_s = N // CHAINS
    ref_ps = np.bincount(sep, weights=a, minlength=max_s)[1:max_s]
    port_ps = np.bincount(sep, weights=b, minlength=max_s)[1:max_s]
    octave = np.floor(np.log2(np.arange(1, max_s))).astype(int)
    ref_oct = np.bincount(octave, weights=ref_ps)
    port_oct = np.bincount(octave, weights=port_ps)
    both = (ref_oct > 100) & (port_oct > 100)
    both &= np.arange(len(ref_oct)) < int(np.log2(max_s - 1))
    dev = np.abs(np.log10(ref_oct[both]) - np.log10(port_oct[both]))
    print(f"P(s) octave curve: max |dlog10| = {dev.max():.4f} over {both.sum()} octaves")
    assert both.sum() >= 4 and dev.max() <= 0.15


def test_contact_map_pearson_vs_surrogate(surrogate_exe, tmp_path):
    contact_map_gate(surrogate_exe, tmp_path, "cpu")


def test_walk_init_is_the_gate_s_start():
    """Seeded, inside the ball, bonds at the thermal length."""
    x = walk_init(N, CHAINS)
    assert x.shape == (N, 3) and x.dtype == np.float32
    assert np.array_equal(x, walk_init(N, CHAINS))
    assert np.linalg.norm(x, axis=1).max() <= 0.8 + 1e-6
    per = N // CHAINS
    bond_r2 = np.sum(np.diff(x[:per], axis=0) ** 2, axis=1).mean()
    assert bond_r2 == pytest.approx(0.01, rel=0.2)
    assert len(with_nucleoli(x)) == N + 2 * N_SITES
