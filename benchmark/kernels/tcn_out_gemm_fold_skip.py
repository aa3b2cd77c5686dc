"""K3 tcn_out_gemm (fold, skip mode): x' = x + norm2(e) @ out_w and s' =
s + norm2(e) @ skip_w, norm2 folded into [out_w | skip_w], both in place,
e read once."""
from benchmark.kernels._shape import dtype, stats_bytes


def work(s, n):
    rows, bs = s["M"] * s["K"], s["B"] + s["Sc"]
    b = (rows * s["H"] + 2 * rows * bs + s["H"] * bs) * s["it"] + stats_bytes(s)
    return n * b, n * 2.0 * rows * bs * s["H"], dtype(s)
