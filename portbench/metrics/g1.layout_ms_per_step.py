"""Host milliseconds a G1 step spent enqueueing the cell layout
(``InterphaseModel.cell_layout``, the steps' and the ticks' calls), from
the benchmark's spans in the traced run."""


def read(run):
    if run.kind != "g1" or run.spans is None or not run.steps:
        return None
    if not run.spans.calls.get("layout"):
        return None
    return 1e3 * run.spans.total["layout"] / run.steps
