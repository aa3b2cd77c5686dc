"""The matmul work of a forward, and the shapes the work files read."""

from __future__ import annotations


def num_frames(m, T: int) -> int:
    """K = (T - L) // (L / 2) + 1."""
    return (T - m["L"]) // (m["L"] // 2) + 1


def forward_flops(m, M: int, T: int) -> float:
    """Every contraction of the inference forward at 2 * MACs: encoder,
    bottleneck, per block in_w / depthwise taps / out_w, mask, decoder
    (convtasnet_torch/tools/_bench.forward_matmul_flops)."""
    K = num_frames(m, T)
    NB = m["R"] * m["X"]
    per_frame = (2 * m["L"] * m["N"] + 2 * m["N"] * m["B"]
                 + NB * (4 * m["B"] * m["H"] + 2 * m["P"] * m["H"])
                 + 2 * m["B"] * m["C"] * m["N"] + 2 * m["C"] * m["N"] * m["L"])
    return float(M) * K * per_frame


def shape(m, unit) -> dict:
    """The work files' `s` for one traced unit of model keys `m`."""
    return {**{k: m[k] for k in ("N", "L", "B", "H", "P", "X", "R", "C")},
            "M": unit["M"], "K": num_frames(m, unit["T"]), "NB": m["R"] * m["X"],
            "it": 2 if m["compute_dtype"] == "bfloat16" else 4, "norm": m["norm_type"]}
