"""The one traffic generator: seeded harmonic sources and length grids.

The sources are those of convtasnet_torch/data/synthetic.py (per speaker a
stack of three harmonics of a random fundamental, 80-220 Hz times 1.6 per
speaker index, under a slow AM envelope), drawn for many utterances at once
by a generator on the device. Lengths come from a fixed grid that every
seed shares; the seed only orders it, so every seed does the same work.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch


def sources(seed: int, n: int, C: int, T: int, sample_rate: int, device) -> torch.Tensor:
    """[n, C, T] float32 sources on `device`."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    t = torch.arange(T, device=dev, dtype=torch.float32) / sample_rate
    spk = torch.arange(C, device=dev, dtype=torch.float32)
    f0 = u(80, 220, n, C, 1) * 1.6 ** spk[None, :, None]
    h = torch.arange(1, 4, device=dev, dtype=torch.float32)
    amp = u(0.2, 1.0, n, C, 3) / h
    phase = u(0, 2 * math.pi, n, C, 3)
    out = torch.zeros((n, C, T), device=dev)
    for k in range(3):  # one harmonic at a time keeps the peak at [n, C, T]
        out += amp[..., k:k + 1] * torch.sin(2 * math.pi * f0 * h[k] * t + phase[..., k:k + 1])
    env = 0.55 + 0.45 * torch.sin(2 * math.pi * u(0.7, 2.5, n, C, 1) * t
                                  + u(0, 2 * math.pi, n, C, 1))
    return out * env * 0.25


def mixtures(seed: int, n: int, C: int, T: int, sample_rate: int, device) -> torch.Tensor:
    """[n, T] mixtures: the sum of `sources`' speakers."""
    return sources(seed, n, C, T, sample_rate, device).sum(1)


def length_grid(lo: int, hi: int, step: int) -> List[int]:
    """lo, lo + step, ... up to hi: the lengths every seed uses."""
    return list(range(lo, hi + 1, step))


def utterance_lengths(t: dict) -> List[int]:
    """The lengths of a traffic file's distinct utterances: its grid from
    `min_samples` to `max_samples` every `grid_step`, cycled to at least
    `utterances` entries (a grid of one length gives that many utterances
    of it)."""
    grid = length_grid(int(t["min_samples"]), int(t["max_samples"]), int(t["grid_step"]))
    n = max(len(grid), int(t.get("utterances", 0)))
    return [grid[i % len(grid)] for i in range(n)]


def order(seed: int, n: int) -> List[int]:
    """A permutation of range(n) drawn from the seed."""
    return [int(i) for i in np.random.default_rng([seed, 1]).permutation(n)]


def padded(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple
