"""The share of the profiled mitotic sub-window (the window's first pass)
in which nothing ran on the device: 1 - busy / window."""


def read(run):
    if run.kind != "mitotic" or run.profile is None or not run.profile.busy_s:
        return None
    return 1.0 - run.profile.busy_s / run.profile.window_s
