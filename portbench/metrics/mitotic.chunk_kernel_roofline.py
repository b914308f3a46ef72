"""Share of its roofline that the mitotic chunk kernel
(``csrc/mitotic_chunk.cu``, ``mitotic_chunk_kernel``) reached over the
window's first pass, which the traced run profiles: for each chunk of
1,000 steps the least time of its work (``work.mitotic_chunk``, at the mean
of the work at the chunk's first and last frame: the repulsion's pairs
within the core diameter, the bonds, bending triples, fibers and sources of
its phase, the normals read once), summed over the chunks and divided by
the kernel's device time in the trace, in %."""

from portbench import trace, work

KERNEL = "mitotic_chunk_kernel"


def _counts(system):
    bonds = system.bonds.shape[0]
    if system.phase == "telophase":
        return bonds, system.n
    sources = system.kinetochores.shape[0]
    if system.phase == "prometaphase":
        bonds += system.sisters.shape[0]
        if system.m.polar_ejection_force != 0:
            sources += 2 * system.n
    return bonds, sources


def read(run):
    if run.kind != "mitotic" or run.profile is None or run.card is None:
        return None
    found = trace.kernel(run.profile, KERNEL)
    if found is None:
        return None
    m = run.config.mitotic_phase
    least, previous = 0.0, {}
    chunks = 0
    for stage, step, x in run.profile_frames:
        if step > 0 and stage in previous:
            system = run.ref[stage]
            bonds, sources = _counts(system)
            ends = [work.least_seconds(work.mitotic_chunk(
                y, m.sampling_interval, m.core_diameter, bonds, system.triples.shape[0], sources),
                run.card) for y in (previous[stage], x)]
            if None in ends:
                return None
            least += 0.5 * sum(ends)
            chunks += 1
        previous[stage] = x
    launches, seconds = found
    if launches != chunks:
        return None
    return 100.0 * least / seconds
