"""Beads x mitotic steps of every chunk in the window (576 a step in
anaphase and telophase, 1,152 in prometaphase), over the window's wall
seconds (host clock; the window ends on a synchronize)."""


def read(run):
    if run.kind != "mitotic" or not run.window_s:
        return None
    return run.bead_steps / run.window_s
