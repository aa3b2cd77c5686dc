"""KB2 tcn_bwd_dwconv: the depthwise conv's and norm1's backward: y1, c and
dz read, db written; statistics of both norms and the gradient's read."""
from benchmark.kernels._shape import dtype, stats_bytes


def work(s, n):
    rows, h = s["M"] * s["K"], s["H"]
    b = 4 * rows * h * s["it"] + 3 * stats_bytes(s) + (2 * s["P"] + 4) * h * 4
    return n * b, n * rows * h * (4.0 * s["P"] + 30), dtype(s)
