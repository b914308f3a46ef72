"""Share of its roofline that the pair-force kernel
(``csrc/ab_pair_forces.cu``, ``ab_pair_forces_cell_kernel``) reached in the
profiled G1 sub-window: the least time of its launches there (each at the
mean of the work at the sub-window's two bounding frames: the pairs within
the A/B softcore's reach at that frame's core scale, ``work.pair_force``)
over its device time in the trace, in %."""

from portbench import trace, work

KERNEL = "ab_pair_forces_cell_kernel"


def read(run):
    if run.kind != "g1" or run.profile is None or run.card is None:
        return None
    found = trace.kernel(run.profile, KERNEL)
    if found is None:
        return None
    c = run.config.interphase
    af, bf = run.ref.af.cpu().numpy(), run.ref.bf.cpu().numpy()
    least = []
    for x, time in run.profile_frames:
        core, _ = run.ref.scales(time)
        w = work.pair_force(x, af, bf, c.a_core_diameter * core, c.b_core_diameter * core)
        least.append(work.least_seconds(w, run.card))
    if None in least:
        return None
    launches, seconds = found
    return 100.0 * launches * sum(least) / len(least) / seconds
