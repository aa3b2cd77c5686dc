"""Normalization layers (cLN / gLN / BN), time-major channels-last [M, K, ch].

Statistics are float32 whatever the activation dtype; outputs are cast
back. Semantics (the reference's, conv_tasnet.py:292-355):
  * cLN: per-(m, k) mean / biased var over channels, two-pass;
  * gLN: per-m mean / biased var over channels and time, two-pass;
  * BN:  torch BatchNorm1d: per-channel stats over (M, K), eps 1e-5,
         running stats with momentum 0.1 and the *unbiased* variance,
         batch (biased) stats for the normalization in train mode;
  * EPS = 1e-8 added to the variance inside the power for cLN / gLN.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import EPS

BN_EPS = 1e-5  # torch BatchNorm1d default
BN_MOMENTUM = 0.1


def channelwise_layer_norm(x: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor) -> torch.Tensor:
    """cLN over the channel (last) axis, per time step."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = gamma * (xf - mean) * torch.pow(var + EPS, -0.5) + beta
    return y.to(x.dtype)


def global_layer_norm(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor) -> torch.Tensor:
    """gLN over channels and time, per batch element."""
    xf = x.float()
    mean = xf.mean(dim=(-1, -2), keepdim=True)
    var = (xf - mean).square().mean(dim=(-1, -2), keepdim=True)
    y = gamma * (xf - mean) * torch.pow(var + EPS, -0.5) + beta
    return y.to(x.dtype)


def batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor,
               train: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BatchNorm over (M, K) per channel -> (y, new_mean, new_var); eval
    mode returns the running stats unchanged."""
    xf = x.float()
    if train:
        mean = xf.mean(dim=(0, 1))
        var = (xf - mean).square().mean(dim=(0, 1))  # biased, for the norm
        n = x.shape[0] * x.shape[1]
        unbiased = var * (n / max(n - 1, 1))
        new_mean = (1 - BN_MOMENTUM) * running_mean + BN_MOMENTUM * mean
        new_var = (1 - BN_MOMENTUM) * running_var + BN_MOMENTUM * unbiased
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    y = gamma * (xf - mean) * torch.pow(var + BN_EPS, -0.5) + beta
    return y.to(x.dtype), new_mean, new_var


def apply_norm(norm_type: str, x: torch.Tensor, params: dict,
               state: Optional[dict], train: bool
               ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Dispatch like the reference's chose_norm (conv_tasnet.py:292-303)."""
    if norm_type == "cLN":
        return channelwise_layer_norm(x, params["gamma"], params["beta"]), state
    if norm_type == "gLN":
        return global_layer_norm(x, params["gamma"], params["beta"]), state
    if norm_type == "BN":
        y, rm, rv = batch_norm(x, params["gamma"], params["beta"],
                               state["mean"], state["var"], train)
        return y, {"mean": rm, "var": rv}
    raise ValueError(f"unsupported norm_type: {norm_type}")
