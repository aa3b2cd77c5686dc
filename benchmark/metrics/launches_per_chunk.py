"""launches_per_chunk.*: device operations (kernels, copies, sets) per
traced unit, from the profiler's records."""


def read(name, trace, ctx):
    if not trace.units or trace.n_records == 0:
        return None
    return trace.n_records / len(trace.units)
