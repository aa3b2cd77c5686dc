"""KW tcn_wgrad (out, skip mode): d[out_w | skip_w] = z^T [g | g_s], z
formed from c, written in float32 [H, B + Sc]."""
from benchmark.kernels._shape import dtype


def work(s, n):
    rows, bs = s["M"] * s["K"], s["B"] + s["Sc"]
    b = rows * (bs + s["H"]) * s["it"] + bs * s["H"] * 4
    return n * b, n * 2.0 * rows * bs * s["H"], dtype(s)
