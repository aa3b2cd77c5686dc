"""kernel_roofline.*: the hand-written kernels' share of their roofline.

Per traced unit, each of the port's launch counters that moved names a work
file kernels/<counter>.py; its launches' bound is the larger of their bytes
at the HBM rate and their operations at the peak of their type. The sum of
the bounds over the window is divided by the device time of the window's
records in the port's `tcn::` namespace. A counter with no work file is
printed and the metric is left out.
"""

from benchmark import flops, harness, spec


def read(name, trace, ctx):
    if ctx.device.type != "cuda" or trace.port_s <= 0:
        return None
    import torch

    peak = spec.peaks(torch.cuda.get_device_name(ctx.device), ctx.cell.root)
    if peak is None:
        return None
    files, bound = {}, 0.0
    for u in trace.units:
        s = flops.shape(ctx.model, u)
        for k, n in u["launches"].items():
            if k not in files:
                files[k] = spec.load_module("kernels", k, ctx.cell.root)
            if files[k] is None:
                harness.log(f"{name}: no work file kernels/{k}.py")
                return None
            b, f, dt = files[k].work(s, n)
            bound += max(b / peak["hbm_bytes_per_s"], f / peak["flops_per_s"][dt])
    return 100.0 * bound / trace.port_s
