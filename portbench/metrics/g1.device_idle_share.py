"""The share of the profiled G1 sub-window in which nothing ran on the
device: 1 - busy / window."""


def read(run):
    if run.kind != "g1" or run.profile is None or not run.profile.busy_s:
        return None
    return 1.0 - run.profile.busy_s / run.profile.window_s
