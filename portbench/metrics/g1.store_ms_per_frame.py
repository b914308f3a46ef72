"""Host milliseconds in the store's writes (positions, context, contacts,
frame index, checkpoint) a G1 frame of the window, from the benchmark's
spans around the store's methods."""


def read(run):
    if run.kind != "g1" or run.spans is None or not run.frames:
        return None
    return 1e3 * run.spans.total.get("store", 0.0) / run.frames
