"""mfu.*: the whole step's share of the bf16 tensor-core peak: each untraced
unit's forward matmul work (2 * MACs) times its passes (3 for a train step:
forward, and the backward's two products; recompute not counted), over the
time those units took without the profiler (CUDA events around them, just
before the traced sessions; tracing.py)."""

from benchmark import flops, spec


def read(name, trace, ctx):
    if ctx.device.type != "cuda" or trace.untraced_s <= 0:
        return None
    import torch

    peak = spec.peaks(torch.cuda.get_device_name(ctx.device), ctx.cell.root)
    if peak is None:
        return None
    work = sum(u["passes"] * flops.forward_flops(ctx.model, u["M"], u["T"])
               for u in trace.untraced_units)
    return 100.0 * work / trace.untraced_s / peak["flops_per_s"]["bfloat16"]
