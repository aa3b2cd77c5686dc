"""KW tcn_wgrad (in): the [rows, ch]^T @ [rows, ch'] weight gradient,
written in float32."""
from benchmark.kernels._shape import dtype


def work(s, n):
    rows = s["M"] * s["K"]
    b = rows * (s["B"] + s["H"]) * s["it"] + s["B"] * s["H"] * 4
    return n * b, n * 2.0 * rows * s["B"] * s["H"], dtype(s)
