"""Small tensor utilities (the reference's src/utils.py surface)."""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def remove_pad(inputs, lengths) -> List[np.ndarray]:
    """Trim per-item padding: [B, C, T] or [B, T] -> list of numpy [C, len]
    or [len] arrays (reference utils.py:49-66). Takes numpy arrays or
    tensors (on any device)."""
    if isinstance(inputs, torch.Tensor):
        inputs = inputs.detach().cpu().numpy()
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.detach().cpu().numpy()
    inputs = np.asarray(inputs)
    lengths = np.asarray(lengths)
    return [np.asarray(x[..., :int(n)]) for x, n in zip(inputs, lengths)]
