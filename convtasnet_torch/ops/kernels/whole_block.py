"""One temporal block, whole-block form (norm2 unfolded).

Counterpart of convtasnet_tpu/ops/pallas/fused_whole_block.py
(`whole_block_pallas`, inference form): z = round(norm2(e)) and then
z @ out_w, the reference op order. On the card it is K1, K2 and the
unfolded K3 of csrc/tcn_block.cu (see tcn_block.py).

Where this differs from the TPU kernel: for gLN that kernel keeps
a = PReLU(y1) rounded to the activation dtype between its two passes over
K, and for cLN it normalises e before rounding it; here norm1 is applied to
a recomputed in f32 from the stored y1 (as whole_tcn does) and norm2 to
the stored, rounded e. The two agree exactly in f32.
"""

from __future__ import annotations

import torch

from .whole_tcn import KERNEL_STAGES, PLAIN_STAGES, tcn_chain


def _run(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, dilation,
         causal, valid_k, stages, scratch):
    f32 = dict(dtype=torch.float32, device=x.device)
    a1 = torch.as_tensor(a1, **f32).reshape(1)
    a2 = torch.as_tensor(a2, **f32).reshape(1)
    one = [t[None] for t in (in_w, g1, b1, w, g2, b2, out_w)]
    in_w, g1, b1, w, g2, b2, out_w = one
    return tcn_chain(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type,
                     causal, [dilation], valid_k, False, stages, scratch)


def whole_block_reference(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w,
                          norm_type, dilation, causal, valid_k=None):
    """Plain PyTorch version: [M, K(,pad), B] -> same shape, one block."""
    return _run(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, dilation,
                causal, valid_k, PLAIN_STAGES, None)


def whole_block(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type,
                dilation, causal, valid_k=None, scratch=None):
    """One block. A CPU tensor takes the plain version; a CUDA tensor runs
    three kernel launches. `scratch` is an optional (y1, e) pair from
    whole_tcn.alloc_scratch, reused when a caller runs many blocks."""
    if x.device.type == "cpu":
        return whole_block_reference(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w,
                                     norm_type, dilation, causal, valid_k)
    return _run(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, dilation,
                causal, valid_k, KERNEL_STAGES, scratch)
