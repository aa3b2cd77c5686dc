"""The whole-block form of training: blocks that save only their input.

Counterpart of convtasnet_tpu/ops/pallas/whole_block_vjp.py
(`whole_block_train`, `_whole_block_bwd_pallas`) and of the JAX model's
scan over it (convtasnet_tpu/models/conv_tasnet.py:317-392). The forward
is the inference whole-block form (K1, K2, K3 unfolded) and saves the
block input x alone. The backward recomputes y1 and the norm1 partials
with K1 and c and the norm2 partials with K2 in save mode, then runs the
same five backward kernels and KF (one launch per group of blocks) as
the whole-TCN op (tcn_block_bwd.py, whole_tcn_hybrid.chain_bwd). On the TPU one kernel recomputes the
mid-chain in VMEM; here the recomputed [M, K_pad, H] slabs pass through
device memory.

`whole_chain_train` is the op the model runs: one autograd Function over
the NB blocks, whose block nb writes its output into slot nb + 1 of one
[NB, M, K_pad, B] buffer of block inputs (the memory the per-block ops
save) and whose backward writes the stacked [NB, ...] weight gradients,
as JAX's scan returns them. `whole_block_train` is the same code for one
block.
"""

from __future__ import annotations

import torch

from .tcn_block import dwconv_plain, in_gemm_plain, tcn_dwconv, tcn_in_gemm
from .tcn_block_bwd import KERNEL_BWD, PLAIN_BWD
from .whole_block import whole_block, whole_block_reference
from .whole_tcn import KERNEL_STAGES, PLAIN_STAGES
from .whole_tcn_hybrid import _dilations, chain_bwd, chain_forward


def _bwd_stages(plain: bool):
    """(in_gemm, dwconv, backward stages) of the recompute backward."""
    if plain:
        return in_gemm_plain, dwconv_plain, PLAIN_BWD
    return tcn_in_gemm, tcn_dwconv, KERNEL_BWD


def recompute_bwd(g, x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, dilation,
                  causal, valid_k, plain=False):
    """Backward of one block from its input x alone: (dx, din_w, da1, dg1,
    db1, dw, da2, dg2, db2, dout_w)."""
    in_gemm, dwconv, bwd = _bwd_stages(plain)
    params = [t[None] for t in (in_w, a1, g1, b1, w, a2, g2, b2, out_w)]
    res = chain_bwd(g, x[None], None, None, params, norm_type, causal, [dilation], valid_k,
                    in_gemm, bwd, dwconv)
    return (res[0], *[r[0] for r in res[1:]])


class _WholeBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, dilation,
                causal, valid_k, plain):
        fwd = whole_block_reference if plain else whole_block
        out, _ = fwd(x, in_w.to(x.dtype), a1, g1, b1, w, a2, g2, b2, out_w.to(x.dtype),
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
    versions; a CUDA tensor runs 3 kernels forward and 8 backward (K1, K2
    save, KB1, KB2, KB3, two KW, KF: a group of one block)."""
    K = x.shape[1] if valid_k is None else valid_k
    return _WholeBlockTrain.apply(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type,
                                  dilation, causal, K, plain)


class _WholeChainTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, causal, X,
                valid_k, plain):
        out, x_res, _, _ = chain_forward(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w,
                                         norm_type, causal, X, valid_k,
                                         PLAIN_STAGES if plain else KERNEL_STAGES,
                                         save=False)
        ctx.save_for_backward(x_res, in_w, a1, g1, b1, w, a2, g2, b2, out_w)
        ctx.static = (norm_type, causal, X, valid_k, plain)
        return out

    @staticmethod
    def backward(ctx, gout):
        x_res, *params = ctx.saved_tensors
        norm_type, causal, X, valid_k, plain = ctx.static
        in_gemm, dwconv, bwd = _bwd_stages(plain)
        grads = chain_bwd(gout, x_res, None, None, params, norm_type, causal,
                          _dilations(x_res.shape[0], X), valid_k, in_gemm, bwd, dwconv)
        return (*grads, None, None, None, None, None)


def whole_chain_train(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, causal, X,
                      valid_k=None, plain=False):
    """The NB blocks of the whole-block form as one differentiable op.
    x [M, K_pad, B] with exact-zero pad rows (valid_k = the true frame
    count); weights f32 stacked [NB, ...], block nb at dilation
    2 ** (nb % X). A CPU tensor, or plain=True, takes the plain versions; a
    CUDA tensor runs 3 kernels per block forward and 7 per block backward
    (K1, K2 save, KB1, KB2, KB3, two KW) and one KF per group of blocks."""
    K = x.shape[1] if valid_k is None else valid_k
    return _WholeChainTrain.apply(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type,
                                  causal, X, K, plain)
