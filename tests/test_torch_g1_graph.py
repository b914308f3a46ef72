"""The G1 step's CUDA graph (``genome_cycle_tpu_torch/models/g1_graph.py``),
what of it holds on the CPU:

- the per-step rows of scalars the graph's kernels read on the card equal,
  to the bit, the float32 values the eager step hands the pair kernel and
  the rest kernel by value, at every step of a run across frames, for one
  system and for four replicas;
- ``_bd_step4`` on a CPU carry is the eager body, to the bit, and counts no
  capture, replay or eager card step;
- the graph's key changes exactly when the grid, the shape or the dtype
  does.

The graph itself runs only on the card (``tests/test_torch_gpu.py``).
"""

import ctypes

import numpy as np
import pytest
import torch

from genome_cycle_tpu_torch.config import InterphaseConfig
from genome_cycle_tpu_torch.models import g1_graph
from genome_cycle_tpu_torch.models import interphase as tinter
from genome_cycle_tpu_torch.ops import step_rest
from genome_cycle_tpu_torch.utils import tracing

torch.set_num_threads(1)

FRAME = 20     # sampling_interval: the table's rows
STEPS = 45     # two frames and a part


def _tiny_model(n=160, replicas=1, seed=7, dtype="float32"):
    """A chain of ``n`` beads, A and B in turn, on the CPU at T = 1, the pair
    force through the cell layout; ``replicas`` starts inside the wall."""
    af = (np.arange(n) % 2).astype(np.float64)
    rows = np.arange(n - 1)
    chained = np.arange(n) < n - 1
    arrays = dict(
        af=af, bf=1.0 - af, mobility=np.ones(n),
        bond_pairs=np.stack([rows, rows + 1], 1), bond_spring=np.full(n - 1, 40.0),
        bond_length=np.full(n - 1, 0.05), loop_pairs=np.zeros((0, 2), np.int64),
        loop_spring=np.zeros(0), bond_mask=chained,
        bond_k_row=np.where(chained, 40.0, 0.0), bond_l_row=np.where(chained, 0.05, 0.0),
        loop_mask=np.zeros(n, bool), loop_k_row=np.zeros(n),
        nuc_bonds=np.zeros((0, 2), np.int64), nuc_targets=np.zeros(0, np.int64))
    config = InterphaseConfig(sampling_interval=FRAME, contactmap_update_interval=10)
    model = tinter.InterphaseModel(
        config, arrays, tinter.EngineSettings(brute_force_threshold=0, dtype=dtype), "cpu")
    rng = np.random.default_rng(seed)
    walks = []
    for _ in range(replicas):
        walk = np.cumsum(rng.normal(scale=0.03, size=(n, 3)), axis=0)
        walks.append(0.8 * walk / np.abs(walk).max())
    x = torch.as_tensor(np.stack(walks) if replicas > 1 else walks[0], dtype=model.dtype)
    generators = [torch.Generator().manual_seed(seed + r) for r in range(replicas)]
    semiaxes = torch.as_tensor(config.wall_semiaxes_init, dtype=model.dtype)
    if replicas > 1:
        semiaxes = semiaxes.expand(replicas, 3).contiguous()
    return model, (x, generators if replicas > 1 else generators[0], semiaxes)


def _bits(values):
    return np.asarray(values, np.float32).view(np.uint32)


@pytest.mark.parametrize("replicas", [1, 4])
def test_step_rows_equal_the_eager_launch_arguments_to_the_bit(monkeypatch, replicas):
    """Each step's row, from the table the graph sends at the frame's first
    step, against what the eager step hands the kernels: the pair kernel's
    four floats as ctypes passes them, the rest kernel's as its argument
    struct holds them."""
    model, state = _tiny_model(replicas=replicas)
    seen = {}
    pair_fn, rest_fn = tinter.ab_pair_forces, step_rest.rest

    def pair_spy(layout, params, *args, **kwargs):
        seen.setdefault("pair", []).append([ctypes.c_float(v).value for v in params])
        return pair_fn(layout, params, *args, **kwargs)

    def rest_spy(positions, forces=None, bonds=None, wall=None, update=None, **kwargs):
        if update is not None:
            args = step_rest._RestArgs()
            args.bond_s2, args.bond_s = step_rest.bond_scalars(bonds.scale)
            args.e_a, args.inv_da2, args.e_b, args.inv_db2 = step_rest.wall_scalars(wall.params)
            seen.setdefault("rest", []).append([args.bond_s2, args.bond_s, args.e_a,
                                                args.inv_da2, args.e_b, args.inv_db2])
        return rest_fn(positions, forces, bonds, wall, update, **kwargs)

    monkeypatch.setattr(tinter, "ab_pair_forces", pair_spy)
    monkeypatch.setattr(step_rest, "rest", rest_spy)
    for step in range(1, STEPS + 1):
        state = model._bd_step4(state, step)
    assert len(seen["pair"]) == len(seen["rest"]) == STEPS
    tables = {}
    for step in range(1, STEPS + 1):
        first = (step - 1) // FRAME * FRAME + 1
        if first not in tables:
            tables[first] = g1_graph.step_scalars(model, first, FRAME)
        row = tables[first][step - first]
        np.testing.assert_array_equal(row, g1_graph.step_scalars(model, step, 1)[0])
        assert (_bits(row[0:4]) == _bits(seen["pair"][step - 1])).all(), step
        assert (_bits(row[4:10]) == _bits(seen["rest"][step - 1])).all(), step
        assert not row[10:].any()
    # The scales move within a frame: the rows are not one row repeated.
    assert len({tuple(_bits(r)) for r in tables[1]}) == FRAME


@pytest.mark.parametrize("replicas", [1, 4])
def test_bd_step4_on_a_cpu_carry_is_the_eager_body_and_counts_no_graph(replicas):
    model, state = _tiny_model(replicas=replicas)
    _, twin = _tiny_model(replicas=replicas)
    before = tracing.counters()
    for step in range(1, 31):
        state = model._bd_step4(state, step)
        twin = model._eager_step(twin, step)
        assert torch.equal(state[0], twin[0]) and torch.equal(state[2], twin[2]), step
    since = tracing.counters_since(before)
    assert not any(since.get(name, 0) for name in
                   ("graph.step_replays", "graph.step_captures", "graph.step_eager"))
    assert since.get("launch.cell_layout", 0) == since.get("launch.ab_pair_forces", 0) == 0
    assert model._step_graph is None and not g1_graph.replays(model, state[0])


KEY_CHANGES = {
    "positions moved": (False, lambda model, x: (model, x + 0.01)),
    "bound kept by update_bound": (False, lambda model, x: (
        model, x) if not model.update_bound(model.bound - 0.7) else None),
    "bound grown": (True, lambda model, x: (model, x) if model.update_bound(
        model.bound + 1.5) else None),
    "cell": (True, lambda model, x: (setattr(model, "cell", model.cell * 1.1), (model, x))[1]),
    "replicas": (True, lambda model, x: (model, torch.stack([x, x]))),
    "beads": (True, lambda model, x: (_tiny_model(n=model.n + 8)[0], torch.cat([x, x[:8]]))),
    "dtype": (True, lambda model, x: (model, x.double())),
}


@pytest.mark.parametrize("change", list(KEY_CHANGES))
def test_graph_key_changes_exactly_with_the_grid_shape_or_dtype(change):
    model, (x, _, _) = _tiny_model()
    key = g1_graph.graph_key(model, x)
    changes, apply = KEY_CHANGES[change]
    changed = apply(model, x)
    assert changed is not None, "the bound did not move as the case needs"
    assert (g1_graph.graph_key(*changed) != key) == changes
