"""Shared pieces of the port's measuring tools (bench_*.py): timing on the
tool's device, the device's name, the H100's matmul peak and the analytic
matmul work of a forward."""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..config import ConvTasNetConfig
from ..data.synthetic import synthetic_batch

# The small f32 config of the tools' --tiny runs (CPU tests).
TINY = dict(N=16, L=8, B=32, H=64, P=3, X=3, R=2, C=2, compute_dtype="float32")

# NVIDIA H100 SXM data sheet, dense bf16 tensor-core peak at 700 W: the
# floor of a bf16 matmul's time on the card. A card set below 700 W
# (nvidia-smi power.limit) runs below it.
H100_BF16_FLOPS = 989e12
H100_PEAK_NAME = "H100 SXM dense bf16, 989 TFLOP/s at 700 W"


def device_name(dev: torch.device) -> str:
    """The name a result row carries: the card's, or "cpu"."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def timed_ms(fn: Callable[[], object], iters: int, warm: int, dev: torch.device) -> float:
    """Mean ms per call of `iters` back-to-back calls after `warm`: CUDA
    events on a card, the host clock on the CPU."""
    for _ in range(warm):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_batch(seed: int, batch: int, C: int, T: int, sample_rate: int, dev):
    """(mixture, lengths, sources) of data/synthetic on `dev`."""
    mix, lens, src = synthetic_batch(np.random.default_rng(seed), batch, C, T, sample_rate)
    return tuple(torch.from_numpy(a).to(dev) for a in (mix, lens, src))


def forward_matmul_flops(cfg: ConvTasNetConfig, M: int, T: int) -> float:
    """Every contraction of the inference forward at 2 * MACs (encoder,
    bottleneck, per block in_w / depthwise taps / out_w, mask, decoder);
    the formula of bench.py's _matmul_flops_forward."""
    K = cfg.num_frames(T)
    NB = cfg.R * cfg.X
    per_frame = (2 * cfg.L * cfg.N + 2 * cfg.N * cfg.B
                 + NB * (4 * cfg.B * cfg.H + 2 * cfg.P * cfg.H)
                 + 2 * cfg.B * cfg.C * cfg.N + 2 * cfg.C * cfg.N * cfg.L)
    return float(M) * K * per_frame
