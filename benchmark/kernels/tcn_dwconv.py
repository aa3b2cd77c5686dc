"""K2 tcn_dwconv: norm1, the dilated depthwise conv, PReLU2, with the
statistics of its output."""
from benchmark.kernels._shape import dtype, stats_bytes


def work(s, n):
    rows = s["M"] * s["K"]
    b = 2 * rows * s["H"] * s["it"] + 2 * stats_bytes(s) + (s["P"] + 2) * s["H"] * 4
    return n * b, n * rows * s["H"] * (2.0 * s["P"] + 12), dtype(s)
