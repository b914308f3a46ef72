"""The plain halves of the step kernels of csrc/step_rest.cu and
csrc/contact_tick.cu, on the CPU.

- The wall's derivatives in closed form (``wall_forces_analytic``, the rest
  kernel's arithmetic) against autograd (``wall_forces_reference``) and
  against the JAX package's ``jax.value_and_grad`` wall: beads inside,
  outside, at the origin and on the wall, positions (N, 3) and (R, N, 3), in
  float32 and float64.  Both plain versions are evaluated in float64 on the
  same inputs: the wall distance is a small difference near the wall, so a
  float32 evaluation of either lies up to about 1e-5 of max|F| from the
  exact wall, and the closed form takes that difference wider.  Tolerance
  1e-5 of the largest magnitude of each of forces and reaction, energies
  1e-5 relative; in float32 the closed form also lies no further from the
  float64 wall than float32 autograd does.
- The rest kernel's plain version with the nucleolar rows live
  (``rest_reference``: chain bonds, loops, NOR bonds, droplet, wall) against
  the JAX package's ``bonded_forces`` + ``wall_forces`` on the same inputs,
  in float32 on both sides: forces within 1e-4 of max|F|, reaction and
  energies 1e-4 relative (sums in another order, the wall's autograd in
  float32 on both sides); at R = 2 against two single runs within 1e-6.
  The nucleolar table the kernel reads, evaluated row by row as the kernel
  walks it, against the plain nucleolar terms in float64 (1e-12).
- The tick's grow-and-rerun loop (``events_with_capacity``) driven by the
  plain search, cut to a capacity that is too small, as the kernel cuts it.
- The G1 step and the relaxation step as the port now assembles them
  (pair + nucleolar terms, then bonds + wall, update and wall ODE) against
  the JAX package at T = 0 (positions within 1e-5 of max|x| after 50 steps),
  and against the composition before the rest kernel (pair + all bonded
  terms + autograd wall, update, ODE) with the same noise at T = 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_cycle_tpu.ops import wall as jwall
from genome_cycle_tpu_torch import convert
from genome_cycle_tpu_torch.models import interphase as tinter
from genome_cycle_tpu_torch.ops import contact as tcontact
from genome_cycle_tpu_torch.ops import integrator as tint
from genome_cycle_tpu_torch.ops import step_rest
from genome_cycle_tpu_torch.ops import wall as twall
from genome_cycle_tpu_torch.ops.pair_kernels import build_cell_layout

from test_torch_interphase import models, prepared  # noqa: F401  (fixtures)

torch.set_num_threads(1)

WALL_PARAMS = dict(a_energy=2.5, a_diameter=0.15, b_energy=2.5, b_diameter=0.12,
                   packing_spring=1000.0)
SEMIAXES = np.asarray([[2.0, 1.7, 1.4], [1.9, 1.9, 1.5], [2.1, 1.6, 1.45]])


def _wall_beads(replicas, n=240, seed=5):
    """Beads along random rays at 0 to 1.15 of the wall's radius (inside,
    within the soft core's reach, outside), one at the origin and one on the
    wall in each replica; (N, 3) for ``replicas`` None."""
    rng = np.random.default_rng(seed)
    count = 1 if replicas is None else replicas
    semi = SEMIAXES[:count]
    directions = rng.normal(size=(count, n, 3))
    directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
    fraction = np.concatenate([rng.uniform(0.0, 0.9, (count, n // 3, 1)),
                               rng.uniform(0.93, 0.999, (count, n // 3, 1)),
                               rng.uniform(1.001, 1.15, (count, n - 2 * (n // 3), 1))], axis=1)
    x = directions * semi[:, None, :] * fraction
    x[:, 0] = 0.0
    x[:, 1] = 0.0
    x[:, 1, 0] = semi[:, 0]
    a = rng.uniform(0, 1, n)
    a_mix, b_mix = 0.5 * a, 0.5 * (1 - a) + 5.0
    if replicas is None:
        return x[0], semi[0], a_mix, b_mix
    return x, semi, a_mix, b_mix


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("replicas", [None, 3], ids=["(N,3)", "(R,N,3)"])
def test_wall_forces_analytic_matches_autograd_and_jax(dtype, replicas):
    x, semi, a_mix, b_mix = (np.asarray(v, dtype) for v in _wall_beads(replicas))
    args = [torch.from_numpy(v) for v in (x, semi, a_mix, b_mix)] + [WALL_PARAMS]
    f_a, r_a, e_a = twall.wall_forces_analytic(*args)
    wide = [t.double() for t in args[:4]] + [WALL_PARAMS]
    f_g, r_g, e_g = twall.wall_forces_reference(*wide)
    f_n, r_n, _ = twall.wall_forces_reference(*args)      # autograd in the inputs' dtype
    assert f_a.dtype == f_n.dtype == torch.from_numpy(x).dtype
    assert np.abs(f_g.numpy()).max() > 1.0 and (r_g.numpy() > 0).all()
    _close(f_a, f_g)
    _close(r_a, r_g)
    assert float(e_a) == pytest.approx(float(e_g), rel=1e-5)
    if dtype == np.float32:
        def err(got, want):
            return float((got.double() - want).abs().max())
        assert err(f_a, f_g) <= err(f_n, f_g) and err(r_a, r_g) <= err(r_n, r_g)
    # The bead at the origin feels nothing, the one on the wall next to
    # nothing (in float64 eps leaves it 1e-12 from the wall).
    assert not f_a[..., 0, :].any() and float(f_a[..., 1, :].abs().max()) < 1e-6
    # The JAX package's autodiff wall, a replica at a time.
    with jax.enable_x64(True):
        xs = (x[None] if replicas is None else x).astype(np.float64)
        ss = (semi[None] if replicas is None else semi).astype(np.float64)
        a_wide, b_wide = a_mix.astype(np.float64), b_mix.astype(np.float64)
        for k in range(xs.shape[0]):
            fj, rj, ej = jwall.wall_forces(jnp.asarray(xs[k]), jnp.asarray(ss[k]),
                                           jnp.asarray(a_wide), jnp.asarray(b_wide), WALL_PARAMS)
            assert np.asarray(fj).dtype == np.float64
            got = f_a if replicas is None else f_a[k]
            _close(got, fj)
            _close(r_a if replicas is None else r_a[k], rj)
        if replicas is None:
            assert float(e_a) == pytest.approx(float(ej), rel=1e-5)


def test_wall_forces_on_the_cpu_take_the_plain_version():
    x, semi, a_mix, b_mix = (np.asarray(v, np.float32) for v in _wall_beads(None, n=60))
    args = [torch.from_numpy(v) for v in (x, semi, a_mix, b_mix)] + [WALL_PARAMS]
    for got, want in zip(twall.wall_forces(*args), twall.wall_forces_reference(*args)):
        assert torch.equal(got, want)


def test_rest_on_the_cpu_takes_the_plain_composition():
    """``step_rest.rest`` on CPU tensors: the bonds by ``shift_bond_forces``,
    the autograd wall, then the update on the handed-in noise and the wall
    ODE, to the bit; energies only when asked for."""
    from genome_cycle_tpu_torch.ops import potentials as pot
    from genome_cycle_tpu_torch.ops.bonded import shift_bond_forces

    x, semi, a_mix, b_mix = (torch.from_numpy(np.asarray(v, np.float32))
                             for v in _wall_beads(None, n=60))
    rng = np.random.default_rng(11)
    mask = torch.from_numpy(rng.uniform(size=60) < 0.9)
    loop = torch.from_numpy(rng.uniform(size=60) < 0.5)
    k, l, k2 = (torch.from_numpy(rng.uniform(lo, hi, 60).astype(np.float32))
                for lo, hi in ((50, 100), (0.05, 0.08), (1, 5)))
    bonds = step_rest.BondRows(mask, k, l, loop, k2, 0.8)
    wall = step_rest.WallRows(semi, a_mix, b_mix, WALL_PARAMS)
    forces = torch.from_numpy(rng.normal(size=(60, 3)).astype(np.float32))
    noise = torch.from_numpy(rng.normal(size=(60, 3)).astype(np.float32))
    mobility = torch.from_numpy(rng.uniform(0.5, 2.0, 60).astype(np.float32))
    update = step_rest.UpdateRows(mobility, noise, 1.0, 1e-4, 2e-8, (3e4, 2e4, 1e4))

    kb, lb, kl = k / 0.64, l * 0.8, k2 / 0.64
    f1, e1 = shift_bond_forces(x, 1, mask, lambda r2: pot.semispring_energy(r2, kb, lb),
                               lambda r2: pot.semispring_force_coeff(r2, kb, lb))
    f2, e2 = shift_bond_forces(x, 2, loop, lambda r2: pot.harmonic_energy(r2, kl),
                               lambda r2: pot.harmonic_force_coeff(r2, kl))
    wf, reaction, we = twall.wall_forces_reference(x, semi, a_mix, b_mix, WALL_PARAMS)
    want = (forces + (f1 + f2)) + wf
    got = step_rest.rest(x, forces, bonds, wall, with_energy=True)
    assert torch.equal(got.out, want) and torch.equal(got.reaction, reaction)
    assert torch.equal(got.bonded_energy, e1 + e2) and torch.equal(got.wall_energy, we)
    quiet = step_rest.rest(x, forces, bonds, wall)
    assert torch.equal(quiet.out, want) and quiet.bonded_energy == quiet.wall_energy == 0.0
    moved = step_rest.rest(x, forces, bonds, wall, update)
    assert torch.equal(moved.out, tint.bd_update_reference(
        x, want, mobility, None, tint.BDParams(1.0, 1e-4), noise=noise))
    spring = torch.tensor([3e4, 2e4, 1e4])
    assert torch.equal(moved.semiaxes, semi + 2e-8 * (reaction - spring * semi))


@pytest.mark.parametrize("bond_scale", [0.5, 1.0])
def test_rest_reference_with_nucleolar_rows_matches_jax(models, bond_scale):  # noqa: F811
    jmodel, tmodel, x0, *_ = models
    assert tmodel.nuc_bonds.shape[0] and tmodel.use_droplet
    semiaxes = np.asarray([1.2, 1.1, 1.0], np.float32)       # the wall presses
    wall = tmodel.wall_rows(torch.from_numpy(semiaxes), 0.8)
    got = step_rest.rest_reference(torch.from_numpy(x0), None, tmodel.bond_rows(bond_scale),
                                   wall, with_energy=True)
    fb, eb = jmodel.bonded_forces(jnp.asarray(x0), bond_scale, with_energy=True)
    fw, rw, ew = jmodel.wall_forces_rows(jnp.asarray(x0), jnp.arange(x0.shape[0]),
                                         jnp.asarray(semiaxes), 0.8)
    want = np.asarray(fb) + np.asarray(fw)
    _close(got.out, want, 1e-4)
    assert np.abs(np.asarray(rw)).max() > 0
    np.testing.assert_allclose(got.reaction.numpy(), np.asarray(rw), rtol=1e-4)
    assert float(got.bonded_energy) == pytest.approx(float(eb), rel=1e-4)
    assert float(got.wall_energy) == pytest.approx(float(ew), rel=1e-4)
    # The nucleolar terms are live: without them the forces differ.
    bare = step_rest.rest_reference(torch.from_numpy(x0), None,
                                    tmodel.bond_rows(bond_scale)._replace(nucleolar=None), wall)
    assert float((got.out - bare.out).abs().max()) > 1e-3


def test_rest_reference_with_nucleolar_rows_on_two_replicas(models):  # noqa: F811
    """(R, N, 3) positions: each replica its own bonds, droplet and wall,
    as a single run of it gives them; the energies summed over both."""
    _, tmodel, x0, *_ = models
    rng = np.random.default_rng(17)
    xs = np.stack([x0, x0 + rng.normal(0, 0.02, x0.shape)]).astype(np.float32)
    semi = torch.tensor([[1.2, 1.1, 1.0], [1.25, 1.05, 1.0]])
    bonds = tmodel.bond_rows(0.7)
    wall = tmodel.wall_rows(semi, 0.8)
    both = step_rest.rest_reference(torch.from_numpy(xs), None, bonds, wall, with_energy=True)
    energy = 0.0
    for r in range(2):
        one = step_rest.rest_reference(torch.from_numpy(xs[r]), None, bonds,
                                       wall._replace(semiaxes=semi[r]), with_energy=True)
        _close(both.out[r], one.out, 1e-6)
        _close(both.reaction[r], one.reaction, 1e-6)
        energy += float(one.bonded_energy + one.wall_energy)
    assert float(both.bonded_energy + both.wall_energy) == pytest.approx(energy, rel=1e-6)


def test_nucleolar_table_gives_each_row_its_terms(models):  # noqa: F811
    """The table the rest kernel reads (``nucleolar_table``), walked row by
    row as the kernel walks it — a row's partners, the droplet among the
    other targets, each bond's energy at the end that owns it — gives the
    plain nucleolar terms, in float64."""
    _, tmodel, x0, *_ = models
    nuc = tmodel.nucleolar_rows()
    x = x0.astype(np.float64)
    table = nuc.table.numpy().astype(np.int64)
    b, t = nuc.bonds.shape[0], nuc.targets.shape[0]
    m = (len(table) - 1 - 2 * b - t) // 3
    rows, start = table[:m], table[m:2 * m + 1]
    target, partner = table[2 * m + 1:3 * m + 1], table[3 * m + 1:3 * m + 1 + 2 * b]
    targets = rows[table[3 * m + 1 + 2 * b:]]
    assert (np.diff(rows) > 0).all() and (targets == nuc.targets.numpy()).all()
    scale = 0.7
    k_nuc, l_nuc = nuc.spring / scale ** 2, nuc.length * scale
    e, inv_d2, cut2 = nuc.droplet_energy, 1 / nuc.droplet_decay ** 2, nuc.droplet_cutoff ** 2
    u_cut = -e / (1 + (cut2 * inv_d2) ** 3)
    forces, energy = np.zeros_like(x), 0.0
    for k, row in enumerate(rows):
        for code in partner[start[k]:start[k + 1]]:
            d = x[row] - x[rows[code if code >= 0 else ~code]]
            r = np.sqrt(max(d @ d, 1e-30))
            forces[row] += (-k_nuc * (1 - l_nuc / r) if r > l_nuc else 0.0) * d
            energy += 0.5 * k_nuc * max(r - l_nuc, 0.0) ** 2 if code >= 0 else 0.0
        for q, j in enumerate(targets):
            if q == target[k] or target[k] < 0:
                continue
            d = x[row] - x[j]
            r2 = d @ d
            if r2 < cut2:
                s3 = (r2 * inv_d2) ** 3
                forces[row] += -e * 6 * s3 / (max(r2, 1e-30) * (1 + s3) ** 2) * d
                energy += 0.5 * (-e / (1 + s3) - u_cut)
    want, want_energy = step_rest.nucleolar_reference(torch.from_numpy(x), nuc, scale)
    _close(forces, want, 1e-12)
    assert np.abs(forces).max() > 1e-3 and abs(energy) > 0
    assert energy == pytest.approx(float(want_energy), rel=1e-12)


def test_step_kernels_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors or raise: the choice of the
    plain version belongs to the callers, by the tensor's device."""
    x = torch.zeros((10, 3))
    with pytest.raises(ValueError, match="CUDA"):
        step_rest.launch_rest(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        step_rest.launch_update(x, x, torch.ones(10), x, 1.0, 1e-4)
    got = tint.bd_update(x, x + 1, torch.ones(10), None, tint.BDParams(0.0, 0.5),
                         noise=torch.zeros_like(x))
    assert torch.equal(got, torch.full_like(x, 0.5))


# -- the tick's capacity ---------------------------------------------------------

def _tick_layout(n=400, seed=3):
    x = np.random.default_rng(seed).uniform(-0.7, 0.7, (n, 3)).astype(np.float32)
    zeros = torch.zeros(n)
    return build_cell_layout(torch.from_numpy(x), zeros, zeros, 1.0, 0.3)


def _capped_plain(layout, cutoff, begin, end, calls):
    """The plain search as the kernel delivers it: the rows in an order of
    their own (a seeded permutation), only the first ``rows`` of them
    written into a buffer of ``rows`` rows, and the count of all."""
    events = tcontact.contact_events_reference(layout, cutoff, begin, end)
    order = torch.from_numpy(np.random.default_rng(len(calls)).permutation(len(events)))

    def search(rows):
        calls.append(rows)
        buffer = torch.full((rows, 3), -7, dtype=torch.int32)
        kept = min(rows, len(events))
        buffer[:kept] = events[order[:kept]]
        return buffer, len(events)

    return search, events


def _pairs(events):
    return sorted(map(tuple, events[:, :2].tolist()))


@pytest.mark.parametrize("start_rows", [1, 100, None], ids=["1 row", "100 rows", "16 N"])
@pytest.mark.parametrize("home", [(0, None), (150, 330)], ids=["all rows", "home range"])
def test_tick_grows_its_capacity_and_reruns(start_rows, home):
    layout = _tick_layout()
    calls = []
    search, want = _capped_plain(layout, 0.24, *home, calls)
    assert len(want) > 100
    capacity = tcontact.EventCapacity(start_rows if start_rows else 16 * layout.n)
    got = tcontact.events_with_capacity(search, capacity)
    assert _pairs(got) == _pairs(want) and (got[:, 2] == 1).all()
    if start_rows is None:
        assert calls == [16 * layout.n] and capacity.rows == 16 * layout.n
    else:
        grown = -(-int(len(want) * 1.25) // 4096) * 4096
        assert calls == [start_rows, grown] and capacity.rows == grown
        # The next tick starts from the grown capacity and runs once.
        calls.clear()
        again = tcontact.events_with_capacity(search, capacity)
        assert calls == [grown] and _pairs(again) == _pairs(want)


def test_event_capacity_grows_to_a_quarter_more_in_4096_rows():
    capacity = tcontact.EventCapacity()
    for count, rows in ((1, 4096), (4096, 8192), (713222, 892928), (3276, 4096), (3277, 8192)):
        capacity.grow(count)
        assert capacity.rows == rows and capacity.rows >= 1.25 * count


# -- the reassembled steps ---------------------------------------------------------

def _pre_kernel_composition(model, carry, step, noise, relaxation=False):
    """The step as the port assembled it before the rest kernel: pair +
    (chain + loop + nucleolar) + autograd wall, then the update, then the
    wall ODE (G1) or none (relaxation)."""
    x, generator, semiaxes = carry
    c = model.config
    dt = c.timestep
    if relaxation:
        core, bond = c.core_scale_init, c.bond_scale_init
        params = tint.BDParams(c.temperature, dt, c.relaxation_spacestep)
    else:
        core, bond = model.scales((step - 1) * dt)
        params = tint.BDParams(c.temperature, dt)
    pair, _ = model.pair_forces_full(x, core)
    f, _ = step_rest.chain_bonds_reference(x, model.bond_rows(bond))
    f_nuc, _ = step_rest.nucleolar_reference(x, model.nucleolar_rows(), bond)
    f = f + f_nuc
    wf, reaction, _ = twall.wall_forces_reference(x, semiaxes, model.wall_a, model.wall_b,
                                                  model._wall_params(core))
    x = tint.bd_update_reference(x, pair + f + wf, model.mobility, generator, params, noise)
    if not relaxation:
        semiaxes = semiaxes + dt * c.wall_mobility * (reaction - model.wall_spring * semiaxes)
    return (x, generator, semiaxes)


def _jax_run(jmodel, x0, semiaxes, step_fn, steps):
    zero = jnp.zeros((), jnp.int32)
    carry = (jnp.asarray(x0), jax.random.PRNGKey(0), jnp.asarray(semiaxes), (zero, zero))
    run = jax.jit(lambda c: jax.lax.scan(
        lambda cr, s: (step_fn(cr, s), None), c, steps)[0])
    xj, _, aj, _ = run(carry)
    return np.asarray(xj), np.asarray(aj)


@pytest.mark.parametrize("stage", ["g1", "relaxation"])
def test_reassembled_steps_match_jax_at_zero_temperature(models, stage):  # noqa: F811
    jmodel, tmodel, x0, config, _ = models
    semiaxes = np.asarray(config.interphase.wall_semiaxes_init, np.float32)
    reach = np.sqrt(np.sum((x0 / semiaxes) ** 2, axis=1)).max()
    assert reach < 1.0                                       # inside the wall
    if stage == "g1":
        xj, aj = _jax_run(jmodel, x0, semiaxes, jmodel._bd_step4, 1 + jnp.arange(50))
    else:
        xj, aj = _jax_run(jmodel, x0, semiaxes, jmodel.relaxation_step, jnp.arange(50))
    state = convert.state_from_numpy(x0, semiaxes, device="cpu")
    for step in range(50):
        state = (tmodel._bd_step4(state, step + 1) if stage == "g1"
                 else tmodel.relaxation_step(state, step))
    xt, _, at = state
    assert np.abs(xj - x0).max() > 1e-3                      # it moved
    assert np.abs(xt.numpy() - xj).max() <= 1e-5 * np.abs(xj).max()
    np.testing.assert_allclose(at.numpy(), aj, rtol=1e-6)


@pytest.mark.parametrize("stage", ["g1", "relaxation"])
def test_reassembled_steps_match_the_earlier_composition_on_the_same_noise(
        models, stage):  # noqa: F811
    _, _, x0, config, design = models
    warm = dataclasses.replace(config, interphase=dataclasses.replace(
        config.interphase, temperature=1.0))
    model = tinter.InterphaseModel.from_design(design, warm, tinter.EngineSettings(
        brute_force_threshold=0), "cpu")
    semiaxes = np.asarray([1.6, 1.5, 1.45], np.float32)      # the wall presses
    new = convert.state_from_numpy(x0, semiaxes, device="cpu")
    old = convert.state_from_numpy(x0, semiaxes, device="cpu")
    rng = np.random.default_rng(9)
    for step in range(1, 21):
        noise = torch.from_numpy(rng.normal(size=x0.shape).astype(np.float32))
        if stage == "g1":
            new = model._bd_step4(new, step, noise=noise)
        else:
            new = model.relaxation_step(new, step, noise=noise)
        old = _pre_kernel_composition(model, old, step, noise, relaxation=stage != "g1")
    moved = np.abs(old[0].numpy() - x0).max()
    assert moved > 1e-3
    assert np.abs(new[0].numpy() - old[0].numpy()).max() <= 1e-5 * np.abs(old[0].numpy()).max()
    np.testing.assert_allclose(new[2].numpy(), old[2].numpy(), rtol=1e-6)
