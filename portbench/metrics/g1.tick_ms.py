"""Milliseconds a contact tick: the tick (its cell layout, the search, the
event count read back) and the window merge, from a synchronize before the
tick to the merge's own read-back, in the traced run."""


def read(run):
    if run.kind != "g1" or run.spans is None or not run.spans.calls.get("tick"):
        return None
    return 1e3 * run.spans.total["tick"] / run.spans.calls["tick"]
