"""Seconds from the start of the process to the opening of the window:
imports, any build of the program's kernels, the stages before the window
and its warm-up."""


def read(run):
    return run.setup_s
