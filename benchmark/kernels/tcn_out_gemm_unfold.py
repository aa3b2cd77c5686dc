"""K3 tcn_out_gemm (unfold): x' = x + norm2(e) @ out_w, in place."""
from benchmark.kernels._shape import dtype, stats_bytes


def work(s, n):
    rows = s["M"] * s["K"]
    b = (rows * s["H"] + 2 * rows * s["B"] + s["H"] * s["B"]) * s["it"] + stats_bytes(s)
    return n * b, n * 2.0 * rows * s["B"] * s["H"], dtype(s)
