"""K1 tcn_in_gemm: y1 = x @ in_w, with the statistics of PReLU(y1)."""
from benchmark.kernels._shape import dtype, stats_bytes


def work(s, n):
    rows = s["M"] * s["K"]
    b = (rows * s["B"] + s["B"] * s["H"] + rows * s["H"]) * s["it"] + stats_bytes(s)
    return n * b, n * 2.0 * rows * s["B"] * s["H"], dtype(s)
