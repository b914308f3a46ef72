"""Kernels launched on the device a G1 step, from the profiled sub-window
(one frame of 1,000 steps that holds a window dump)."""


def read(run):
    if run.kind != "g1" or run.profile is None:
        return None
    launches = sum(count for count, _ in run.profile.kernels.values())
    return launches / run.config.interphase.sampling_interval if launches else None
