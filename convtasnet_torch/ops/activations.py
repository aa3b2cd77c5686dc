"""Activation functions."""

from __future__ import annotations

import torch


def prelu(x: torch.Tensor, alpha) -> torch.Tensor:
    """PReLU with one shared slope (torch nn.PReLU() default,
    conv_tasnet.py:218,:253), computed in x's dtype like the JAX op."""
    a = torch.as_tensor(alpha, device=x.device).to(x.dtype)
    return torch.where(x >= 0, x, a * x)
