"""skip_roofline.*: the skip modes' share of their roofline (a configuration
of the paper's final version, Sc skip channels).

The bound of the launches counted by the port's `*_skip` counters (work
files kernels/<counter>.py, at the unit's shapes and Sc; the larger of
their bytes at the HBM rate and their operations at the peak of their
type) over the device time of the records that carry the skip kernels'
names (`tcn::` records with `skip` in the name: hgemm_skip_kernel,
wgrad_skip_kernel, bwd_finish_skip_kernel, fold_weights_skip_kernel).
Nothing to read where no skip kernel ran. `bound` also serves
kernel_roofline.taslp, over every counter.
"""

from benchmark import flops, harness, spec
from benchmark.tracing import PORT_KERNEL

SKIP = "skip"


def bound(name, trace, ctx, keep=lambda counter: True):
    """Seconds the counted launches of the counters `keep` takes need at
    the card's peaks over the traced units, or None (no peak for the card,
    or a counter with no work file, which is logged)."""
    import torch

    peak = spec.peaks(torch.cuda.get_device_name(ctx.device), ctx.cell.root)
    if peak is None:
        return None
    files, total = {}, 0.0
    for u in trace.units:
        s = {**flops.shape(ctx.model, u), "Sc": int(ctx.model.get("Sc", 0))}
        for k, n in u["launches"].items():
            if not keep(k):
                continue
            if k not in files:
                files[k] = spec.load_module("kernels", k, ctx.cell.root)
            if files[k] is None:
                harness.log(f"{name}: no work file kernels/{k}.py")
                return None
            b, f, dt = files[k].work(s, n)
            total += max(b / peak["hbm_bytes_per_s"], f / peak["flops_per_s"][dt])
    return total


def read(name, trace, ctx):
    if ctx.device.type != "cuda":
        return None
    skip_s = sum(s for k, (_, s) in trace.records.items() if PORT_KERNEL in k and SKIP in k)
    if skip_s <= 0:
        return None
    b = bound(name, trace, ctx, lambda k: k.endswith("_" + SKIP))
    return None if b is None else 100.0 * b / skip_s
