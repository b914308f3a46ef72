"""Share of its roofline that the contact tick (``csrc/contact_tick.cu``,
``contact_tick_kernel``) reached in the profiled G1 sub-window: the least
time of its launches there (each at the mean of the work at the two
bounding frames: the pairs within the contact distance at that frame's core
scale and the events written, ``work.contact_tick``) over its device time
in the trace, in %."""

from portbench import trace, work

KERNEL = "contact_tick_kernel"


def read(run):
    if run.kind != "g1" or run.profile is None or run.card is None:
        return None
    found = trace.kernel(run.profile, KERNEL)
    if found is None:
        return None
    c = run.config.interphase
    least = []
    for x, time in run.profile_frames:
        core, _ = run.ref.scales(time)
        least.append(work.least_seconds(work.contact_tick(x, c.contactmap_distance * core),
                                        run.card))
    if None in least:
        return None
    launches, seconds = found
    return 100.0 * launches * sum(least) / len(least) / seconds
