"""idle_share.stream: 1 - the device's busy time per unit (the union of the
device records' intervals over the traced units) / the time per unit of as
many units run without the profiler, in percent. Tracing slows this cell's
units on the host (each of its launches costs more under the profiler), so
its traced window would read mostly the profiler's own idle."""


def read(name, trace, ctx):
    return trace.idle_share(untraced=True)
