"""KB1 tcn_bwd_dz: dz = g @ out_w^T through norm2 and PReLU2, with the
statistics of the norm's gradient and the column sums for gamma2 / beta2."""
from benchmark.kernels._shape import dtype, stats_bytes


def work(s, n):
    rows, h = s["M"] * s["K"], s["H"]
    b = ((rows * s["B"] + s["B"] * h + 2 * rows * h) * s["it"] + 2 * stats_bytes(s)
         + 2 * h * 4 + 2 * h * 4)
    return n * b, n * 2.0 * rows * s["B"] * h, dtype(s)
