"""Parameter initializers reproducing the reference's init distribution.

The reference applies nn.init.xavier_normal_ to every parameter with
ndim > 1 (conv_tasnet.py:41-43). The fans come from the *torch* weight
shape ([out_ch, in_ch, kernel] for Conv1d, [1, ch, 1] for the norm
affines); the tensor returned has this package's channels-last layout.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def _torch_fan(torch_shape: Sequence[int]) -> Tuple[int, int]:
    """fan_in/fan_out per torch.nn.init._calculate_fan_in_and_fan_out."""
    receptive = 1
    for s in torch_shape[2:]:
        receptive *= s
    return torch_shape[1] * receptive, torch_shape[0] * receptive


def xavier_normal(generator: torch.Generator, torch_shape: Sequence[int],
                  out_shape: Sequence[int], device=None,
                  dtype=torch.float32) -> torch.Tensor:
    """Xavier/Glorot normal, std = sqrt(2 / (fan_in + fan_out)), drawn from
    `generator` (which must live on `device`)."""
    fan_in, fan_out = _torch_fan(torch_shape)
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(tuple(out_shape), generator=generator,
                             device=device, dtype=dtype)
