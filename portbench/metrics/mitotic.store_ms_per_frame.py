"""Host milliseconds in the store's writes (positions, frame index) a
mitotic frame of the window, from the benchmark's spans around the store's
methods."""


def read(run):
    if run.kind != "mitotic" or run.spans is None or not run.frames:
        return None
    return 1e3 * run.spans.total.get("store", 0.0) / run.frames
