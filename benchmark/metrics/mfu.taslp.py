"""mfu.taslp: mfu.py's share of the bf16 tensor-core peak for a configuration
of the paper's final version: each untraced unit's forward matmul work
(2 * MACs) plus, a frame, NB * 2 * H * Sc for the skip path's products and
the mask head from Sc channels (2 * Sc * C * N instead of 2 * B * C * N),
times its passes, over the time those units took without the profiler."""

from benchmark import flops, spec


def _skip_flops(m, M, T) -> float:
    K = flops.num_frames(m, T)
    NB = m["R"] * m["X"]
    return float(M) * K * (NB * 2 * m["H"] * m["Sc"] + 2 * (m["Sc"] - m["B"]) * m["C"] * m["N"])


def read(name, trace, ctx):
    if ctx.device.type != "cuda" or trace.untraced_s <= 0:
        return None
    import torch

    peak = spec.peaks(torch.cuda.get_device_name(ctx.device), ctx.cell.root)
    if peak is None:
        return None
    m = ctx.model
    work = sum(u["passes"] * (flops.forward_flops(m, u["M"], u["T"])
                              + _skip_flops(m, u["M"], u["T"]))
               for u in trace.untraced_units)
    return 100.0 * work / trace.untraced_s / peak["flops_per_s"]["bfloat16"]
