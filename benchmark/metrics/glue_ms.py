"""glue_ms.*: device ms per unit in records outside the port's `tcn::`
kernels: library matmuls, loss, optimizer, copies, reductions."""


def read(name, trace, ctx):
    if not trace.units:
        return None
    return 1e3 * trace.glue_s / len(trace.units)
