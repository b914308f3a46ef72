"""``torch.cuda.max_memory_allocated`` over the window (its peak reset when
the window opens), in MiB."""


def read(run):
    if not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2 ** 20
