"""Replicas x particles x G1 steps in the window, over the window's wall
seconds (host clock; the window ends on a synchronize)."""


def read(run):
    if run.kind != "g1" or not run.window_s:
        return None
    return run.bead_steps / run.window_s
