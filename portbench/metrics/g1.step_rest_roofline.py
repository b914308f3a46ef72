"""Share of its roofline that the rest of a G1 step (``csrc/step_rest.cu``,
``step_rest_kernel``: bonds, loops, nucleolar bonds and droplet, wall and
reaction, update, wall ODE) reached in the profiled G1 sub-window: the
least time of its launches there (``work.step_rest``: each bead's inputs
read once and its new position written once) over its device time in the
trace, in %."""

from portbench import trace, work

KERNEL = "step_rest_kernel"


def read(run):
    if run.kind != "g1" or run.profile is None or run.card is None:
        return None
    found = trace.kernel(run.profile, KERNEL)
    if found is None:
        return None
    ref = run.ref
    bonds = ref.bonds.shape[0] + (ref.loops.shape[0] if ref.use_loops else 0)
    w = work.step_rest(run.replicas * ref.n, run.replicas * bonds,
                       run.replicas * ref.nuc_bonds.shape[0])
    least = work.least_seconds(w, run.card)
    if least is None:
        return None
    launches, seconds = found
    return 100.0 * launches * least / seconds
