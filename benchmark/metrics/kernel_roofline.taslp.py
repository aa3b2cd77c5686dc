"""kernel_roofline.taslp: kernel_roofline.py's share for a configuration of
the paper's final version: the bound of every counted launch, the skip
modes' work files read at the skip channels Sc, over the device time of
the window's `tcn::` records."""

from benchmark.metrics.skip_roofline import bound


def read(name, trace, ctx):
    if ctx.device.type != "cuda" or trace.port_s <= 0:
        return None
    b = bound(name, trace, ctx)
    return None if b is None else 100.0 * b / trace.port_s
