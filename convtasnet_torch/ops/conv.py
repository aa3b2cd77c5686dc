"""Pointwise and dilated depthwise 1-D convolutions, channels-last [M, K, ch].

The reference's 1x1 convs (conv_tasnet.py:169,:185,:217,:256) are matmuls
in this layout; the dilated depthwise conv (groups = channels,
conv_tasnet.py:247-250) is a static sum of P shifted slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.comm import shift_left, shift_right


def pointwise(x: torch.Tensor, w: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """1x1 conv: [M, K, cin] @ [cin, cout] -> [M, K, cout] float32.

    JAX's preferred_element_type=f32 accumulates the compute-dtype operands
    in f32 and returns f32; a torch bf16 matmul would round its output to
    bf16. So the operands are rounded to the compute dtype first and then
    up-cast, and the product runs in f32 (exact products of the rounded
    operands, f32 accumulate)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    return torch.matmul(x.float(), w.float())


def depthwise_dilated(x: torch.Tensor, w: torch.Tensor, dilation: int,
                      causal: bool, context=None) -> torch.Tensor:
    """Depthwise dilated conv over time. x [M, K, ch], w [P, ch] -> [M, K, ch].

    Causal pads (P-1)*d on the left (the reference's pad-both-then-chomp,
    conv_tasnet.py:251-252); non-causal pads span//2 left and span - span//2
    right. The taps sum in x's dtype, as in the JAX op.

    context: the CP group when the frame axis is cut over ranks; the halos
    then come from the neighbours (convtasnet_tpu/ops/conv.py:56-80), with
    zeros only at the sequence's true ends, and a shard shorter than its
    halo sends itself zero-padded."""
    P = w.shape[0]
    span = (P - 1) * dilation
    left, right = (span, 0) if causal else (span // 2, span - span // 2)
    K = x.shape[1]
    if context is None:
        xp = F.pad(x, (0, 0, left, right))
    else:
        parts = []
        if left > 0:
            send = x[:, K - left:] if left <= K else F.pad(x, (0, 0, left - K, 0))
            parts.append(shift_right(send, context))
        parts.append(x)
        if right > 0:
            send = x[:, :right] if right <= K else F.pad(x, (0, 0, 0, right - K))
            parts.append(shift_left(send, context))
        xp = torch.cat(parts, dim=1)
    wd = w.to(x.dtype)
    out = None
    for p in range(P):
        tap = xp[:, p * dilation: p * dilation + K, :] * wd[p]
        out = tap if out is None else out + tap
    return out
