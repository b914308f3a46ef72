"""Device milliseconds a G1 step: the union of the device's busy intervals
in the profiled sub-window (one frame that holds a window dump) over its
steps.  Unlike the end-to-end rate it does not follow the host's load, so a
change to the kernels shows in it even where the host's noise hides it end
to end."""


def read(run):
    if run.kind != "g1" or run.profile is None or not run.profile.busy_s:
        return None
    return 1e3 * run.profile.busy_s / run.config.interphase.sampling_interval
