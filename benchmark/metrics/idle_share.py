"""idle_share.*: 1 - (union of the device records' intervals) / the traced
window, in percent. For cells whose device is busy most of the time, where
tracing adds little; a cell of many small launches or much host work per
unit has a reader of its own that times its units untraced."""


def read(name, trace, ctx):
    return trace.idle_share(untraced=False)
