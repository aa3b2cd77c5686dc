"""Normalization layers (cLN / gLN / BN), time-major channels-last [M, K, ch].

Statistics are float32 whatever the activation dtype; outputs are cast
back. Semantics (the reference's, conv_tasnet.py:292-355):
  * cLN: per-(m, k) mean / biased var over channels, two-pass;
  * gLN: per-m mean / biased var over channels and time, two-pass;
  * BN:  torch BatchNorm1d: per-channel stats over (M, K), eps 1e-5,
         running stats with momentum 0.1 and the *unbiased* variance,
         batch (biased) stats for the normalization in train mode;
  * EPS = 1e-8 added to the variance inside the power for cLN / gLN.

`groups` (parallel runs) are the process groups a norm's statistics sum
over: the model group for the channels TP cuts, the context group for the
frames CP cuts (gLN; convtasnet_tpu/ops/norms.py:54-63), the data group for
BN's batch rows under DP. The statistics are then two-pass sums, the mean
first and then the squared deviations, each all-reduced, over the product
of the local count and the group sizes.
"""

from __future__ import annotations

from math import prod
from typing import Optional, Sequence, Tuple

import torch

from ..config import EPS
from ..parallel.comm import all_reduce_groups, group_size

BN_EPS = 1e-5  # torch BatchNorm1d default
BN_MOMENTUM = 0.1


def _moments(xf: torch.Tensor, dims, groups: Sequence):
    """(mean, biased variance) over `dims`, summed over `groups` too."""
    if not groups:
        mean = xf.mean(dim=dims, keepdim=True)
        return mean, (xf - mean).square().mean(dim=dims, keepdim=True)
    n = prod(xf.shape[d] for d in dims) * prod(group_size(g) for g in groups)
    mean = all_reduce_groups(xf.sum(dim=dims, keepdim=True), groups) / n
    var = all_reduce_groups((xf - mean).square().sum(dim=dims, keepdim=True), groups) / n
    return mean, var


def channelwise_layer_norm(x: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, groups: Sequence = ()) -> torch.Tensor:
    """cLN over the channel (last) axis, per time step."""
    xf = x.float()
    mean, var = _moments(xf, (-1,), groups)
    y = gamma * (xf - mean) * torch.pow(var + EPS, -0.5) + beta
    return y.to(x.dtype)


def global_layer_norm(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, groups: Sequence = ()) -> torch.Tensor:
    """gLN over channels and time, per batch element."""
    xf = x.float()
    mean, var = _moments(xf, (-1, -2), groups)
    y = gamma * (xf - mean) * torch.pow(var + EPS, -0.5) + beta
    return y.to(x.dtype)


def batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor,
               train: bool, groups: Sequence = ()
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BatchNorm over (M, K) per channel -> (y, new_mean, new_var); eval
    mode returns the running stats unchanged."""
    xf = x.float()
    if train:
        mean, var = _moments(xf, (0, 1), groups)  # biased var, for the norm
        mean, var = mean[0, 0], var[0, 0]
        n = x.shape[0] * x.shape[1] * prod(group_size(g) for g in groups)
        unbiased = var * (n / max(n - 1, 1))
        new_mean = (1 - BN_MOMENTUM) * running_mean + BN_MOMENTUM * mean
        new_var = (1 - BN_MOMENTUM) * running_var + BN_MOMENTUM * unbiased
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    y = gamma * (xf - mean) * torch.pow(var + BN_EPS, -0.5) + beta
    return y.to(x.dtype), new_mean, new_var


def apply_norm(norm_type: str, x: torch.Tensor, params: dict,
               state: Optional[dict], train: bool, groups: Sequence = ()
               ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Dispatch like the reference's chose_norm (conv_tasnet.py:292-303)."""
    if norm_type == "cLN":
        return channelwise_layer_norm(x, params["gamma"], params["beta"], groups), state
    if norm_type == "gLN":
        return global_layer_norm(x, params["gamma"], params["beta"], groups), state
    if norm_type == "BN":
        y, rm, rv = batch_norm(x, params["gamma"], params["beta"],
                               state["mean"], state["var"], train, groups)
        return y, {"mean": rm, "var": rv}
    raise ValueError(f"unsupported norm_type: {norm_type}")
