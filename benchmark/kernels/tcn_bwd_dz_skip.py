"""KB1 tcn_bwd_dz (skip mode): dz = [g | g_s] @ [out_w | skip_w]^T through
norm2 and PReLU2, a depth of B + Sc read from g and g_s, with the
statistics of the norm's gradient and the column sums for gamma2 / beta2."""
from benchmark.kernels._shape import dtype, stats_bytes


def work(s, n):
    rows, h, bs = s["M"] * s["K"], s["H"], s["B"] + s["Sc"]
    b = ((rows * bs + bs * h + 2 * rows * h) * s["it"] + 2 * stats_bytes(s)
         + 2 * h * 4 + 2 * h * 4)
    return n * b, n * 2.0 * rows * bs * h, dtype(s)
