"""KB3 tcn_bwd_dx: dx = g + dy1 @ in_w^T through norm1 and PReLU1."""
from benchmark.kernels._shape import dtype, stats_bytes


def work(s, n):
    rows = s["M"] * s["K"]
    b = (3 * rows * s["H"] + 2 * rows * s["B"] + s["H"] * s["B"]) * s["it"] + 2 * stats_bytes(s)
    return n * b, n * 2.0 * rows * s["B"] * s["H"], dtype(s)
