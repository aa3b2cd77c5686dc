"""K2 in training (save=True): as tcn_dwconv, and the conv output c is
written too."""
from benchmark.kernels._shape import dtype, stats_bytes


def work(s, n):
    rows = s["M"] * s["K"]
    b = 3 * rows * s["H"] * s["it"] + 2 * stats_bytes(s) + (s["P"] + 2) * s["H"] * 4
    return n * b, n * rows * s["H"] * (2.0 * s["P"] + 12), dtype(s)
