#!/usr/bin/env python3
"""Where one step of the PyTorch/CUDA port spends its time, on one GPU.

    python3 profile_torch_step.py [--relax-steps 500] [--steps 200] [--out DIR]

Builds the production nucleus (59,610 particles) as ``chip_smoke.py`` does
(the port's own anaphase and telophase at that script's depth), relaxes it
briefly, and then times the layers of a G1 step one by one — each layer run
``--steps`` times between two ``torch.cuda.synchronize()`` calls on the host
clock, so a layer's number holds its launches and its device time — and the
whole step, a contact tick and a window merge the same way.  A
``torch.profiler`` window over whole steps gives the device's busy share and
the device time by kernel name.  The steps of the three mitotic phases (576
coarse beads, 1,152 with sisters) are timed and profiled the same way, for
their launches a step.  Prints one JSON object and writes it to
``DIR/profile_torch_step.json`` (default ``build/profile``).  Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def host_ms(fn, repeats):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / repeats * 1e3


def profile_window(step_fn, steps, step_ms):
    """A ``torch.profiler`` window over ``steps`` calls of ``step_fn``: device
    time and launches by kernel, the device's busy share of the window and of
    ``steps`` unprofiled steps of ``step_ms`` each."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # The clock runs inside the context: starting and stopping the
        # profiler takes seconds and is no part of the window.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for event in prof.key_averages():
        # Kernel rows carry the device type CUDA; operator rows repeat their
        # kernels' time and are left out.
        if "CUDA" not in str(getattr(event, "device_type", "")):
            continue
        device_us = getattr(event, "self_device_time_total", 0) or getattr(
            event, "self_cuda_time_total", 0)
        if device_us:
            by_kernel[event.key] = (device_us / 1e3, event.count)
    device_ms = sum(v[0] for v in by_kernel.values())
    return {
        "steps": steps,
        "window_ms_with_profiler_on": window_ms,
        "device_busy_ms": device_ms,
        "device_busy_share": device_ms / window_ms if window_ms else None,
        "device_busy_share_of_unprofiled_steps": device_ms / (steps * step_ms),
        "device_kernel_launches_per_step": sum(v[1] for v in by_kernel.values()) / steps,
        "by_kernel": by_kernel,
    }


def mitotic_steps(store, config, x_interphase, device, repeats):
    """Host-clock milliseconds, launches and busy share of one step of the
    anaphase, the telophase and the prometaphase, each on the structure its
    stage starts from in the stored cycle (the prometaphase on the G1
    structure just profiled, coarse-grained and duplicated)."""
    from genome_cycle_tpu_torch import convert
    from genome_cycle_tpu_torch.models.anatelophase import AnatelophaseModel
    from genome_cycle_tpu_torch.models.prometaphase import PrometaphaseModel
    from genome_cycle_tpu_torch.models.transitions import transition_prometaphase

    store.set_stage("interphase")
    store.save_positions(0, x_interphase.cpu().numpy())
    store.append_frame(0)
    transition_prometaphase(store, log=lambda m: None)
    ana = AnatelophaseModel.from_design(store.load_anatelophase_design(), config, device)
    pro = PrometaphaseModel.from_design(store.load_prometaphase_design(), config, device)
    result = {}
    for stage, step in (
        ("anaphase", lambda c, s: ana.step(c, s, False)),
        ("telophase", lambda c, s: ana.step(c, s, True)),
        ("prometaphase", pro.step),
    ):
        store.set_stage(stage)
        carry = convert.mitotic_state_from_numpy(store.load_positions(0), 1, device)

        def one_step():
            nonlocal carry
            carry = step(carry, 0)

        step_ms = host_ms(one_step, repeats)
        window = profile_window(one_step, 50, step_ms)
        # Same start, same seed, twice: `index_add_` sums bonds and triples
        # that share a bead in an order of its own choosing.
        twice = []
        for _ in range(2):
            carry = convert.mitotic_state_from_numpy(store.load_positions(0), 1, device)
            for _ in range(repeats):
                one_step()
            twice.append(carry[0])
        top = sorted(window.pop("by_kernel").items(), key=lambda kv: -kv[1][0])[:5]
        result[stage] = {
            "beads": int(carry[0].shape[0]), "step_ms": step_ms,
            "steps_per_second": 1e3 / step_ms, **window,
            "two_runs_bitwise_equal": bool(torch.equal(*twice)),
            "two_runs_max_abs_difference": float((twice[0] - twice[1]).abs().max()),
            "two_runs_steps": repeats,
            "top_device_kernels_ms_total_and_count": [
                [name[:90], round(ms, 3), count] for name, (ms, count) in top],
        }
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--relax-steps", type=int, default=500)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda")

    import chip_smoke
    from genome_cycle_tpu_torch import convert
    from genome_cycle_tpu_torch.models.interphase import EngineSettings, InterphaseModel
    from genome_cycle_tpu_torch.ops import pair_kernels as pk
    from genome_cycle_tpu_torch.ops.contact import empty_window_acc, merge_events_acc
    from genome_cycle_tpu_torch.ops.integrator import BDParams, bd_update

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    os.makedirs(args.out, exist_ok=True)
    store, config = chip_smoke.prepare_nucleus(args.out, device)
    c = config.interphase
    store.set_stage("relaxation")
    model = InterphaseModel.from_design(
        store.load_interphase_design(), config, EngineSettings(), device
    )
    state = convert.state_from_numpy(
        store.load_positions(0), c.wall_semiaxes_init, seed=1, device=device
    )
    model.update_bound(float(state[0].abs().max()))
    for s in range(args.relax_steps):
        state = model.relaxation_step(state, s)
    model.update_bound(float(state[0].abs().max()))
    # A few hundred G1 steps, so that the timed structure is a G1 structure.
    step0 = 0
    for step0 in range(1, args.steps + 1):
        state = model._bd_step4(state, step0)
    model.update_bound(float(state[0].abs().max()))
    x, generator, semiaxes = state
    core, bond = model.scales(step0 * c.timestep)
    kparams = chip_smoke.kernel_params(core, c)
    layout = model.cell_layout(x)
    forces = torch.zeros_like(x)

    n = args.steps
    layers = {
        "layout_sort": host_ms(lambda: model.cell_layout(x), n),
        "pair_kernel": host_ms(lambda: pk.ab_pair_forces(layout, kparams), n),
        # The kernel's first version, for comparison; no part of a step.
        "pair_kernel_first_version": host_ms(
            lambda: pk._ab_pair_forces_thread_per_bead(layout, kparams), n),
        "bonded": host_ms(lambda: model.bonded_forces(x, bond), n),
        "wall": host_ms(lambda: model.wall_forces_rows(x, semiaxes, core), n),
        "update": host_ms(lambda: bd_update(
            x, forces, model.mobility, generator, BDParams(c.temperature, c.timestep)), n),
    }

    def whole_step():
        nonlocal state, step0
        step0 += 1
        state = model._bd_step4(state, step0)

    step_ms = host_ms(whole_step, n)
    events = model.contact_events_tick(state[0], step0)
    tick_ms = host_ms(lambda: model.contact_events_tick(state[0], step0), 10)
    acc, acc_n = empty_window_acc(16 * model.n, device)
    acc, acc_n, _ = merge_events_acc(acc, acc_n, events)
    merge_ms = host_ms(lambda: merge_events_acc(acc, acc_n, events), 10)
    energy_ms = host_ms(
        lambda: model.total_energy(state[0], core, bond, state[2]), 10)

    g1_window = profile_window(whole_step, 50, step_ms)
    by_kernel = g1_window.pop("by_kernel")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    mitotic = mitotic_steps(store, config, state[0], device, n)

    tick_every = c.contactmap_update_interval
    result = {
        "card": card,
        "device": torch.cuda.get_device_name(0),
        "particles": model.n,
        "g1_step_of_structure": step0,
        "candidates": pk.candidate_pairs(layout),
        "pairs_in_reach": pk.pairs_in_reach(layout, kparams),
        "events_per_tick": int(events.shape[0]),
        "layers_ms_per_step": layers,
        "layers_sum_ms": sum(
            ms for name, ms in layers.items() if name != "pair_kernel_first_version"),
        "whole_step_ms": step_ms,
        "tick_ms": tick_ms,
        "merge_ms": merge_ms,
        "energy_pass_ms": energy_ms,
        "amortised_ms_per_step": step_ms + (tick_ms + merge_ms) / tick_every,
        "profiler": {
            **g1_window,
            "pair_kernel_device_ms": sum(
                v[0] for name, v in by_kernel.items() if "ab_pair_forces" in name),
            "top_device_kernels_ms_total_and_count": [
                [name[:90], round(ms, 3), count] for name, (ms, count) in top
            ],
        },
        "mitotic_steps": mitotic,
    }
    text = json.dumps(result, indent=1)
    print(text)
    with open(os.path.join(args.out, "profile_torch_step.json"), "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
