"""One temporal block as a differentiable op that saves only its input.

Counterpart of convtasnet_tpu/ops/pallas/whole_block_vjp.py
(`whole_block_train`, `_whole_block_bwd_pallas`). The forward is the
inference whole-block form (K1, K2, K3 unfolded) and saves the block input
x alone. The backward recomputes y1 and the norm1 partials with K1 and c
and the norm2 partials with K2 in save mode, then runs the same five
backward kernels as the whole-TCN op (tcn_block_bwd.py). On the TPU one
kernel recomputes the mid-chain in VMEM; here the recomputed [M, K_pad, H]
slabs pass through device memory.
"""

from __future__ import annotations

import torch

from .tcn_block import dwconv_plain, in_gemm_plain, tcn_dwconv, tcn_in_gemm
from .tcn_block_bwd import KERNEL_BWD, PLAIN_BWD, block_bwd
from .whole_block import whole_block, whole_block_reference


def recompute_bwd(g, x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, dilation,
                  causal, valid_k, plain=False):
    """Backward of one block from its input x alone: (dx, din_w, da1, dg1,
    db1, dw, da2, dg2, db2, dout_w)."""
    in_gemm, dwconv = (in_gemm_plain, dwconv_plain) if plain else (tcn_in_gemm, tcn_dwconv)
    dt = x.dtype
    in_w, out_w = in_w.to(dt), out_w.to(dt)
    y1, s1 = in_gemm(x, in_w, a1, norm_type)
    _, s2, c = dwconv(y1, s1, a1, g1, b1, w, a2, norm_type, dilation, causal, valid_k,
                      save=True)
    return block_bwd(g.to(dt).contiguous(), x, y1, s1, c, s2, in_w, a1, g1, b1, w, a2,
                     g2, b2, out_w, norm_type, dilation, causal, valid_k,
                     PLAIN_BWD if plain else KERNEL_BWD)


class _WholeBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, dilation,
                causal, valid_k, plain):
        fwd = whole_block_reference if plain else whole_block
        out = fwd(x, in_w.to(x.dtype), a1, g1, b1, w, a2, g2, b2, out_w.to(x.dtype),
                  norm_type, dilation, causal, valid_k)
        ctx.save_for_backward(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w)
        ctx.static = (norm_type, dilation, causal, valid_k, plain)
        return out

    @staticmethod
    def backward(ctx, gout):
        x, in_w, a1, g1, b1, w, a2, g2, b2, out_w = ctx.saved_tensors
        norm_type, dilation, causal, valid_k, plain = ctx.static
        grads = recompute_bwd(gout, x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type,
                              dilation, causal, valid_k, plain)
        dx, din_w, da1, dg1, db1, dw, da2, dg2, db2, dout_w = grads
        return (dx, din_w, da1.reshape(a1.shape), dg1, db1, dw, da2.reshape(a2.shape),
                dg2, db2, dout_w, None, None, None, None, None)


def whole_block_train(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, dilation,
                      causal, valid_k=None, plain=False):
    """Differentiable whole-block op (recompute backward). x [M, K_pad, B]
    with exact-zero pad rows (valid_k = the true frame count); block
    weights f32, a1 / a2 0-d. A CPU tensor, or plain=True, takes the plain
    versions; a CUDA tensor runs 3 kernels forward and 7 backward (K1, K2
    save, KB1, KB2, KB3, two KW)."""
    K = x.shape[1] if valid_k is None else valid_k
    return _WholeBlockTrain.apply(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type,
                                  dilation, causal, K, plain)
