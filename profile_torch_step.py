#!/usr/bin/env python3
"""Where one step of the PyTorch/CUDA port spends its time, on one GPU.

    python3 profile_torch_step.py [--relax-steps 500] [--steps 200] [--out DIR]

Builds the production nucleus (59,610 particles) as ``chip_smoke.py`` does
(the port's own anaphase and telophase at that script's depth), relaxes it
briefly, and then times the layers of a G1 step one by one — each layer run
``--steps`` times between two ``torch.cuda.synchronize()`` calls on the host
clock, so a layer's number holds its launches and its device time — and the
whole step, a relaxation step, a contact tick (layout and the tick kernel;
the kernel's search alone) and a window merge the same way.  The layers of a
G1 step are the layout (the kernels of ``csrc/cell_layout.cu``, also alone by
CUDA events), the pair kernel, the nucleolar terms, the noise and the one
launch of the rest kernel (bonds, wall, update, wall ODE); the layout's plain
version, the rest kernel's bonds alone and wall alone and the update kernel
are timed apart.  ``torch.profiler`` windows over whole G1
steps, relaxation steps and ticks give the device's busy share, the device
kernels started a step and the device time by kernel name.  The eager steps of the three mitotic phases
(576 coarse beads, 1,152 with sisters) are timed and profiled the same way,
for their launches a step, with the update kernel and its plain version on
the card at their sizes (as the eager step launches it, and with the
relaxation's displacement limit), and beside them the phases' steps as the
stages run them, a chunk of ``sampling_interval`` steps in one launch of the
chunk kernel (ms a step, launches and busy share a chunk, the kernel alone,
two runs compared to the bit); and so is the
G1 step of an ensemble of R = 1, 2, 4 and 8 replicas of the nucleus in
lock-step (one launch of the pair kernel a step for all of them).  A G1 step
as one replay of its CUDA graph is timed against the eager step, in turns,
at 59,610 and 4 x 59,610 beads (``chip_smoke.time_graph_step``: host clock
and CUDA events).  Prints one JSON object and writes it to
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


# Launches a kernel is timed over by CUDA events: few enough that the host,
# at some tens of microseconds a launch, stays queued ahead of the card.
DEVICE_REPEATS = 20
# Chunks of a mitotic phase's sampling_interval steps timed and run twice.
CHUNKS = 5


def update_kernel_times(x, mobility, m, spacestep):
    """Milliseconds on the card (CUDA events, the host queued ahead) of the
    update kernel at positions ``x`` as a mitotic step launched it before the
    chunk kernel, and with the relaxation's displacement limit, and of its
    plain version (``bd_update_reference``) likewise, beside its bound
    (position, force and noise read, position written, the mobility: 52
    bytes a bead at 3.35 TB/s)."""
    import chip_smoke
    from genome_cycle_tpu_torch.ops import step_rest
    from genome_cycle_tpu_torch.ops.integrator import BDParams, bd_update_reference

    forces = torch.randn_like(x) * 100.0
    noise = torch.randn_like(x)
    times = {}
    for label, limit in (("no_limit", None), ("with_limit", spacestep)):
        times[f"{label}_ms"] = chip_smoke.time_ms(lambda: step_rest.launch_update(
            x, forces, mobility, noise, m.temperature, m.timestep, limit), DEVICE_REPEATS)
        times[f"{label}_plain_ms"] = chip_smoke.time_ms(lambda: bd_update_reference(
            x, forces, mobility, None, BDParams(m.temperature, m.timestep, limit), noise=noise),
            DEVICE_REPEATS)
    n = x.shape[-2]
    times["bound_ms"] = ((chip_smoke.STEP_BYTES_PER_REPLICA_BEAD
                          + chip_smoke.UPDATE_SHARED_BYTES_PER_BEAD) * n
                         / chip_smoke.PEAK_BYTES_PER_S * 1e3)
    times["beads"] = n
    return times


def chunk_steps(start, chunk, terms, model, m, repeats):
    """A phase's steps a chunk of ``sampling_interval`` at a time, as the
    stage runs them on the card (the chunk's ``randn`` and one launch of the
    chunk kernel): host-clock milliseconds a step over ``repeats`` chunks,
    the kernel alone by CUDA events, device launches and busy share a chunk
    (``torch.profiler``), and two runs from one start and seed compared to
    the bit."""
    import chip_smoke
    from genome_cycle_tpu_torch import convert
    from genome_cycle_tpu_torch.ops import mitotic

    steps = m.sampling_interval
    carry = convert.mitotic_state_from_numpy(start, 1, model.device)

    def one_chunk():
        nonlocal carry
        carry = chunk(carry, steps)

    chunk_ms = host_ms(one_chunk, repeats)
    window = profile_window(one_chunk, 3, chunk_ms)
    window.pop("by_kernel")
    x = carry[0]
    noise = torch.randn((steps, model.n, 3), device=x.device)
    kernel_ms = chip_smoke.time_ms(lambda: mitotic.run_chunk(
        x, terms, model.mobility, noise, m.temperature, m.timestep), 3)
    twice = []
    for _ in range(2):
        carry = convert.mitotic_state_from_numpy(start, 1, model.device)
        for _ in range(repeats):
            one_chunk()
        twice.append(carry[0])
    return {
        "steps_per_chunk": steps,
        "chunk_ms_per_step": chunk_ms / steps,
        "steps_per_second": steps * 1e3 / chunk_ms,
        "kernel_alone_ms_per_chunk": kernel_ms,
        "device_busy_share": window["device_busy_share_of_unprofiled_steps"],
        "device_kernel_launches_per_chunk": window["device_kernel_launches_per_step"],
        "two_runs_bitwise_equal": bool(torch.equal(*twice)),
        "two_runs_chunks": repeats,
    }


def mitotic_steps(store, config, x_interphase, device, repeats):
    """Host-clock milliseconds, launches and busy share of one eager step of
    the anaphase, the telophase and the prometaphase, each on the structure
    its stage starts from in the stored cycle (the prometaphase on the G1
    structure just profiled, coarse-grained and duplicated), and the same of
    the chunk kernel's steps (:func:`chunk_steps`)."""
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
    for stage, step, chunk, model in (
        ("anaphase", lambda c, s: ana.step(c, s, False),
         lambda c, k: ana.run_chunk(c, k, False), ana),
        ("telophase", lambda c, s: ana.step(c, s, True),
         lambda c, k: ana.run_chunk(c, k, True), ana),
        ("prometaphase", pro.step, pro.run_chunk, pro),
    ):
        store.set_stage(stage)
        carry = convert.mitotic_state_from_numpy(store.load_positions(0), 1, device)

        def one_step():
            nonlocal carry
            carry = step(carry, 0)

        step_ms = host_ms(one_step, repeats)
        window = profile_window(one_step, 50, step_ms)
        update = update_kernel_times(
            carry[0], model.mobility, config.mitotic_phase,
            config.interphase.relaxation_spacestep)
        terms = pro.mitotic_terms() if model is pro else ana.mitotic_terms(stage == "telophase")
        chunked = chunk_steps(store.load_positions(0), chunk, terms, model,
                              config.mitotic_phase, CHUNKS)
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
            "update_kernel": update,
            "two_runs_bitwise_equal": bool(torch.equal(*twice)),
            "two_runs_max_abs_difference": float((twice[0] - twice[1]).abs().max()),
            "two_runs_steps": repeats,
            "top_device_kernels_ms_total_and_count": [
                [name[:90], round(ms, 3), count] for name, (ms, count) in top],
            "chunk_kernel": chunked,
        }
    return result


def ensemble_steps(model, x, semiaxes, step0, repeats, replica_counts=(1, 2, 4, 8)):
    """Host-clock milliseconds, launches, busy share and the pair kernel's
    share of the device time of one G1 step of R replicas in lock-step, for
    each R.  Every replica starts from the profiled G1 structure with a
    generator of its own; 20 steps separate them before the timing."""
    from genome_cycle_tpu_torch import convert

    result = {}
    for replicas in replica_counts:
        state = convert.ensemble_state_from_numpy(
            [x.cpu().numpy()] * replicas, [semiaxes.cpu().numpy()] * replicas,
            seeds=range(1, replicas + 1), device=x.device)
        step = step0

        def one_step():
            nonlocal state, step
            step += 1
            state = model._bd_step4(state, step)

        for _ in range(20):
            one_step()
        step_ms = host_ms(one_step, repeats)
        window = profile_window(one_step, 50, step_ms)
        by_kernel = window.pop("by_kernel")
        pair_ms = sum(v[0] for name, v in by_kernel.items() if "ab_pair_forces" in name)
        result[str(replicas)] = {
            "beads": replicas * model.n, "step_ms": step_ms,
            "steps_per_second": 1e3 / step_ms,
            "bead_steps_per_second": replicas * model.n * 1e3 / step_ms, **window,
            "pair_kernel_device_ms": pair_ms,
            "pair_kernel_share_of_device_time": pair_ms / window["device_busy_ms"],
            "pair_kernel_launches_per_step": sum(
                v[1] for name, v in by_kernel.items() if "ab_pair_forces" in name) / 50,
        }
        del state
        torch.cuda.empty_cache()
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
    from genome_cycle_tpu_torch.ops.contact import (
        contact_events, empty_window_acc, merge_events_acc,
    )
    from genome_cycle_tpu_torch.ops.integrator import BDParams, bd_update, standard_normal
    from genome_cycle_tpu_torch.ops import step_rest

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
    forces = pk.ab_pair_forces(layout, kparams)[0]

    n = args.steps
    noise = standard_normal(x, generator)
    fused = model.update_rows(noise)
    # The layers of a G1 step as it runs: layout, pair kernel, the noise,
    # and one launch of the rest kernel for bonds (nucleolar rows included)
    # + wall + update + wall ODE.  Beside them, not part of a G1 step: the
    # rest kernel's bonds alone and wall alone (as bonded_forces and
    # wall_forces launch it for the sharded drivers and the energy pass),
    # and the update kernel (the relaxation's, with its displacement limit).
    bonds, wall = model.bond_rows(bond), model.wall_rows(semiaxes, core)
    layers = {
        "layout": host_ms(lambda: model.cell_layout(x), n),
        "pair_kernel": host_ms(lambda: pk.ab_pair_forces(layout, kparams), n),
        "noise": host_ms(lambda: standard_normal(x, generator), n),
        "rest_kernel_g1_launch": host_ms(
            lambda: step_rest.rest(x, forces, bonds, wall, fused), n),
    }
    # The rest kernel's G1 launch on the card alone (CUDA events, the host
    # queued ahead).
    rest_device_ms = chip_smoke.time_ms(
        lambda: step_rest.launch_rest(x, forces, bonds, wall, fused), DEVICE_REPEATS)
    # The layout kernels (csrc/cell_layout.cu) on the card alone, the same way.
    layout_device_ms = chip_smoke.time_ms(lambda: model.cell_layout(x), DEVICE_REPEATS)
    apart = {
        "layout_plain_version": host_ms(lambda: pk.build_cell_layout_reference(
            x, model.af, model.bf, model.bound, model.cell), n),
        "bonded": host_ms(lambda: model.bonded_forces(x, bond), n),
        "wall": host_ms(lambda: model.wall_forces_rows(x, semiaxes, core), n),
        "update_with_limit": host_ms(lambda: bd_update(
            x, forces, model.mobility, generator,
            BDParams(c.temperature, c.timestep, c.relaxation_spacestep)), n),
        "update": host_ms(lambda: bd_update(
            x, forces, model.mobility, generator, BDParams(c.temperature, c.timestep)), n),
    }

    def whole_step():
        nonlocal state, step0
        step0 += 1
        state = model._bd_step4(state, step0)

    step_ms = host_ms(whole_step, n)
    relax_state = [state]

    def relaxation_step():
        relax_state[0] = model.relaxation_step(relax_state[0], 0)

    relax_ms = host_ms(relaxation_step, n)
    events = model.contact_events_tick(state[0], step0)
    tick_ms = host_ms(lambda: model.contact_events_tick(state[0], step0), 10)
    tick_layout = model.cell_layout(state[0])
    cutoff = c.contactmap_distance * model.scales(step0 * c.timestep)[0]
    tick_search_ms = host_ms(lambda: contact_events(tick_layout, cutoff,
                                                    capacity=model.tick_capacity), 10)
    acc, acc_n = empty_window_acc(16 * model.n, device)
    acc, acc_n, _ = merge_events_acc(acc, acc_n, events)
    merge_ms = host_ms(lambda: merge_events_acc(acc, acc_n, events), 10)
    energy_ms = host_ms(
        lambda: model.total_energy(state[0], core, bond, state[2]), 10)

    g1_window = profile_window(whole_step, 50, step_ms)
    by_kernel = g1_window.pop("by_kernel")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    relax_window = profile_window(relaxation_step, 50, relax_ms)
    relax_window.pop("by_kernel")
    tick_window = profile_window(lambda: model.contact_events_tick(state[0], step0), 10, tick_ms)
    tick_window.pop("by_kernel")
    ensemble = ensemble_steps(model, state[0], state[2], step0, n)
    x_g1, semi_g1 = state[0].clone(), state[2].clone()
    stacked = convert.ensemble_state_from_numpy(
        [x_g1.cpu().numpy()] * 4, [semi_g1.cpu().numpy()] * 4, seeds=range(1, 5), device=device)
    model.update_bound(float(x_g1.abs().max()))
    graph_vs_eager = {
        "59,610": chip_smoke.time_graph_step("59,610 beads", model, x_g1, semi_g1, step0),
        "4 x 59,610": chip_smoke.time_graph_step("4 x 59,610 beads", model, stacked[0],
                                                 stacked[2], step0),
    }
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
        "layers_sum_ms": sum(layers.values()),
        "rest_kernel_g1_launch_device_ms": rest_device_ms,
        "layout_device_ms": layout_device_ms,
        "not_in_a_g1_step_ms": apart,
        "whole_step_ms": step_ms,
        "relaxation_step_ms": relax_ms,
        "relaxation_profiler": relax_window,
        "tick_ms": tick_ms,
        "tick_search_ms": tick_search_ms,
        "tick_profiler": tick_window,
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
        "ensemble_g1_steps": ensemble,
        "g1_step_graph_replay_vs_eager": graph_vs_eager,
        "mitotic_steps": mitotic,
    }
    text = json.dumps(result, indent=1)
    print(text)
    with open(os.path.join(args.out, "profile_torch_step.json"), "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
