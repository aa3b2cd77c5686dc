"""Weights made on the device from the seed, in the port's parameter layout.

The reference recipe's distribution (conv_tasnet.py:41-43): xavier-normal
on every weight with more than one dimension, the fans taken from the torch
weight's shape ([out, in, kernel]; the gLN / cLN affines are [1, ch, 1]),
PReLU slopes 0.25. All normal draws come from one call of a generator on
the device, then each leaf is a scaled slice: a few large calls, in float32,
the type the port keeps its parameters in. Both the program and the
reference are handed these tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def _std(torch_shape: Tuple[int, ...]) -> float:
    receptive = math.prod(torch_shape[2:])
    fan_in, fan_out = torch_shape[1] * receptive, torch_shape[0] * receptive
    return math.sqrt(2.0 / (fan_in + fan_out))


def layout(m: Dict) -> List[Tuple[str, Tuple[int, ...], Tuple[int, ...]]]:
    """(path, shape, torch weight shape of one slice) of every drawn leaf;
    the stacked block leaves are [R, X, ...] of such slices."""
    N, L, B, H, P, X, R, C = (m[k] for k in ("N", "L", "B", "H", "P", "X", "R", "C"))
    rx = (R, X)
    return [
        ("encoder/U", (L, N), (N, 1, L)),
        ("decoder/V", (N, L), (L, N)),
        ("separator/ln/gamma", (N,), (1, N, 1)),
        ("separator/ln/beta", (N,), (1, N, 1)),
        ("separator/bottleneck/w", (N, B), (B, N, 1)),
        ("separator/mask/w", (B, C * N), (C * N, B, 1)),
        ("separator/blocks/in_w", rx + (B, H), (H, B, 1)),
        ("separator/blocks/dw_w", rx + (P, H), (H, 1, P)),
        ("separator/blocks/out_w", rx + (H, B), (B, H, 1)),
        ("separator/blocks/in_gamma", rx + (H,), (1, H, 1)),
        ("separator/blocks/in_beta", rx + (H,), (1, H, 1)),
        ("separator/blocks/dw_gamma", rx + (H,), (1, H, 1)),
        ("separator/blocks/dw_beta", rx + (H,), (1, H, 1)),
    ]


def make(m: Dict, seed: int, device) -> Dict:
    """The parameter tree of model keys `m` (a configuration file) for `seed`."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = layout(m)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    draws = torch.randn(sum(sizes), generator=gen, device=dev, dtype=torch.float32)
    tree: Dict = {}
    for (path, shape, tshape), part in zip(spec, torch.split(draws, sizes)):
        _put(tree, path, (part * _std(tshape)).reshape(shape))
    for site in ("in_prelu", "dw_prelu"):
        _put(tree, f"separator/blocks/{site}",
             torch.full((m["R"], m["X"]), 0.25, device=dev, dtype=torch.float32))
    return tree


def _put(tree: Dict, path: str, t: torch.Tensor) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = t
