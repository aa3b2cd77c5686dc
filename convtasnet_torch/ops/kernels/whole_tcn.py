"""The whole TCN chain (all NB = R*X temporal blocks), whole-TCN form.

Counterpart of convtasnet_tpu/ops/pallas/whole_tcn.py (`whole_tcn_pallas`
with fold_norm2=True, the inference default there). On the TPU one kernel
keeps the residual stream in VMEM across all blocks; here every block is
the three kernels of csrc/tcn_block.cu (see tcn_block.py), with norm2
folded into the out_w product. The residual stream stays in device memory:
the first block's K3 writes a new tensor and the later blocks update it in
place. The y1 / e scratch is allocated once per call and reused by every
block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .tcn_block import (ROW_ALIGN, dwconv_plain, fold_weights, in_gemm_plain,
                        out_gemm_plain, tcn_dwconv, tcn_in_gemm, tcn_out_gemm)

PLAIN_STAGES = (in_gemm_plain, dwconv_plain, out_gemm_plain)
KERNEL_STAGES = (tcn_in_gemm, tcn_dwconv, tcn_out_gemm)


def alloc_scratch(M: int, Kp: int, H: int, dtype, device):
    """The y1 / e buffers [M, K_pad, H] a chain reuses across its blocks."""
    y1 = torch.empty((M, Kp, H), dtype=dtype, device=device)
    return y1, torch.empty_like(y1)


def tcn_chain(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, causal,
              dilations, valid_k, fold, stages, scratch=None):
    """Block loop shared by both forms. Weights are stacked [NB, ...] and
    block i uses dilations[i]. Without valid_k, K is padded to ROW_ALIGN
    here and the padding sliced off at the end; with it, x is already padded
    with zero rows. `scratch` is (y1, e) or None (the stages allocate)."""
    in_gemm, dwconv, out_gemm = stages
    M, K_in, B = x.shape
    if valid_k is None:
        K = K_in
        Kp = -(-K // ROW_ALIGN) * ROW_ALIGN
        x = F.pad(x, (0, 0, 0, Kp - K))
    else:
        K, Kp = valid_k, K_in
    x = x.contiguous()
    dt = x.dtype
    in_w = in_w.to(dt)
    if fold:
        wmat, vec_a, vec_b = fold_weights(out_w, g2, b2, dt)
    else:
        wmat, vec_a, vec_b = out_w.to(dt), g2, b2
    y1, e = scratch if scratch is not None else (None, None)
    out = None
    for nb, d in enumerate(dilations):
        y1, s1 = in_gemm(x, in_w[nb], a1[nb], norm_type, y1)
        e, s2 = dwconv(y1, s1, a1[nb], g1[nb], b1[nb], w[nb], a2[nb], norm_type,
                       d, causal, K, e)
        x = out = out_gemm(e, s2, x, wmat[nb], vec_a[nb], vec_b[nb], norm_type,
                           K, fold, out)
    if valid_k is None and Kp != K:
        x = x[:, :K]
    return x


def _dilations(NB: int, X: int):
    return [2 ** (nb % X) for nb in range(NB)]


def whole_tcn_reference(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w,
                        norm_type, causal, X, valid_k=None):
    """Plain PyTorch version: [M, K(,pad), B] -> same shape. Weights are
    stacked over blocks, [NB, ...], block i with dilation 2**(i % X)."""
    return tcn_chain(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type,
                     causal, _dilations(w.shape[0], X), valid_k, True,
                     PLAIN_STAGES)


def whole_tcn(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, causal, X,
              valid_k=None):
    """All NB blocks, whole-TCN form. A CPU tensor takes the plain version;
    a CUDA tensor runs 3 * NB kernel launches."""
    if x.device.type == "cpu":
        return whole_tcn_reference(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w,
                                   norm_type, causal, X, valid_k)
    Kp = -(-x.shape[1] // ROW_ALIGN) * ROW_ALIGN if valid_k is None else x.shape[1]
    scratch = alloc_scratch(x.shape[0], Kp, w.shape[2], x.dtype, x.device)
    return tcn_chain(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type,
                     causal, _dilations(w.shape[0], X), valid_k, True,
                     KERNEL_STAGES, scratch)
