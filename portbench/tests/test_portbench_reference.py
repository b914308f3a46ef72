"""The benchmark's frozen reference against the program's plain versions
at a tiny size on the CPU, so that a drift of either shows.  This is the
only test that imports both."""

import dataclasses

import numpy as np
import pytest
import torch

from genome_cycle_tpu_torch import config as port_config
from genome_cycle_tpu_torch import topology as port_topology
from genome_cycle_tpu_torch.models.anatelophase import AnatelophaseModel
from genome_cycle_tpu_torch.models.interphase import EngineSettings, InterphaseModel
from genome_cycle_tpu_torch.models.prometaphase import PrometaphaseModel
from genome_cycle_tpu_torch.ops import mitotic as port_mitotic
from genome_cycle_tpu_torch.store import StageDesign
from portbench.reference import config as ref_config
from portbench.reference import topology as ref_topology
from portbench.reference.g1 import G1System
from portbench.reference.mitotic import MitoticSystem
from portbench.tests import tiny

TEXT = tiny.chains_text()
SOURCE = '{"interphase": {"a_core_2nd_bond_spring": 5.0}, "mitotic_phase": {"coarse_graining": 10}}'


def _configs():
    return port_config.parse_config(SOURCE), ref_config.parse_config(SOURCE)


def test_config_and_topology_copies_agree():
    port, ref = _configs()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    a = port_topology.compile_topology(port_topology.load_chains(TEXT), port)
    b = ref_topology.compile_topology(ref_topology.load_chains(TEXT), ref)
    for stage in ("interphase", "anatelophase", "prometaphase"):
        sa, sb = getattr(a, stage), getattr(b, stage)
        for field in dataclasses.fields(sa):
            va, vb = getattr(sa, field.name), getattr(sb, field.name)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb)
            else:
                assert [dataclasses.asdict(c) for c in va] == [dataclasses.asdict(c) for c in vb]
    seed = 2 ** 31 + 5
    assert port_topology.derive_stage_seeds(seed) == ref_topology.derive_stage_seeds(seed)


def _g1(step=3000):
    port, ref = _configs()
    topo = port_topology.compile_topology(port_topology.load_chains(TEXT), port).interphase
    design = StageDesign(seed=0, chains=topo.chains, ab_factors=topo.ab_factors,
                         nucleolar_bonds=topo.nucleolar_bonds)
    model = InterphaseModel.from_design(
        design, port, EngineSettings(brute_force_threshold=0, dtype="float64"), "cpu")
    system = G1System(ref, TEXT, "cpu", torch.float64)
    g = torch.Generator().manual_seed(3)
    n = system.n
    x = (torch.rand((n, 3), generator=g, dtype=torch.float64) - 0.5) * 2.4
    noise = torch.randn((n, 3), generator=g, dtype=torch.float64)
    semi = torch.tensor([1.4, 1.5, 1.6], dtype=torch.float64)
    return model, system, x, noise, semi, step


def test_g1_step_agrees_with_the_program_plain_step():
    model, system, x, noise, semi, step = _g1()
    assert system.use_loops and system.use_droplet
    x_port, _, semi_port = model._bd_step4((x, None, semi), step, noise)
    x_ref, semi_ref, drift = system.step(x, semi, noise, step)
    assert float(drift) > 0
    # The program's cell layout holds float32 positions, so its pair force
    # carries float32 rounding even in a float64 model.
    assert torch.max(torch.abs(x_port - x_ref)) <= 1e-6 * float(drift)
    assert torch.allclose(semi_port, semi_ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("spread", [0.6, 2.4, 6.0])
def test_g1_pair_terms_over_tiles_equal_every_pair(spread):
    """The reference's tiled pair sums against a dense sum over all N x N
    pairs, on packings dense and sparse."""
    from portbench.reference import potentials as pot

    _, system, _, _, _, step = _g1()
    g = torch.Generator().manual_seed(11)
    x = (torch.rand((system.n, 3), generator=g, dtype=torch.float64) - 0.5) * spread
    core = system.scales(step * system.config.timestep)[0]
    forces, energy = system.pair_forces(x, core, with_energy=True)
    dx = x[:, None] - x[None]
    r2 = torch.sum(dx * dx, dim=-1).fill_diagonal_(float("inf"))
    a_mix = 0.5 * (system.af[:, None] + system.af[None])
    b_mix = 0.5 * (system.bf[:, None] + system.bf[None])
    params = system._ab(core)
    dense = torch.sum(pot.ab_pair_force_coeff(r2, a_mix, b_mix, params)[..., None] * dx, dim=1)
    assert torch.max(torch.abs(forces - dense)) <= 1e-12 * max(1.0, float(dense.abs().max()))
    e_dense = 0.5 * torch.sum(pot.ab_pair_energy(r2, a_mix, b_mix, params))
    assert float(energy) == pytest.approx(float(e_dense), rel=1e-12, abs=1e-12)
    cutoff2 = (system.config.contactmap_distance * core) ** 2
    i, j = torch.nonzero((r2 < cutoff2) & (torch.arange(system.n)[None] > torch.arange(
        system.n)[:, None]), as_tuple=True)
    found, _ = system.contacts(x, step, 1e-5)
    np.testing.assert_array_equal(found, np.sort((i << 32 | j).numpy()))


def test_g1_energy_and_tick_agree_with_the_program():
    model, system, x, _, semi, step = _g1()
    core, bond = model.scales(step * model.config.timestep)
    e_port = float(model.total_energy(x, core, bond, semi)) / model.n
    assert float(system.mean_energy(x, semi, step)) == pytest.approx(e_port, rel=1e-9)
    events = model.contact_events_tick(x, step).numpy().astype(np.int64)
    lo, hi = np.minimum(events[:, 0], events[:, 1]), np.maximum(events[:, 0], events[:, 1])
    keys = np.sort((lo << 32) | hi)
    found, near = system.contacts(x, step, 1e-9)
    assert len(found) > 0
    assert np.setdiff1d(np.setxor1d(found, keys), near).size == 0


@pytest.mark.parametrize("phase", ["anaphase", "telophase", "prometaphase"])
def test_mitotic_forces_and_steps_agree_with_the_program(phase):
    port, ref = _configs()
    topology = port_topology.compile_topology(port_topology.load_chains(TEXT), port)
    if phase == "prometaphase":
        p = topology.prometaphase
        model = PrometaphaseModel.from_design(StageDesign(
            seed=0, chains=p.chains, sister_chromatids=p.sister_chromatids,
            pole_positions=p.pole_positions), port, "cpu")
        terms = model.mitotic_terms()
        forces = lambda x: model.forces(x)[0]  # noqa: E731
    else:
        model = AnatelophaseModel.from_design(
            StageDesign(seed=0, chains=topology.anatelophase.chains), port, "cpu")
        telophase = phase == "telophase"
        terms = model.mitotic_terms(telophase)
        forces = lambda x: model.forces(x, telophase)[0]  # noqa: E731
    system = MitoticSystem(ref, TEXT, phase, "cpu", torch.float64)
    g = torch.Generator().manual_seed(5)
    x = (torch.rand((system.n, 3), generator=g) - 0.5) * 3.0
    f_port = forces(x.double())
    f_ref = system.forces(x.double())
    scale = float(torch.max(torch.abs(f_ref)))
    assert float(torch.max(torch.abs(f_port - f_ref))) <= 1e-6 * scale
    noise = torch.randn((20, system.n, 3), generator=g)
    m = port.mitotic_phase
    x_port = port_mitotic.run_chunk(x, terms, model.mobility, noise, m.temperature, m.timestep)
    x_ref = system.run(x.double(), noise.double())
    moved = float(torch.max(torch.abs(x_ref - x.double())))
    assert float(torch.max(torch.abs(x_port.double() - x_ref))) <= 1e-4 * moved
