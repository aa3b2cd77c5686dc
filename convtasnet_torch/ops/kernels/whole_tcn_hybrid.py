"""The whole TCN chain as one differentiable op: residual-saving forward,
per-block backward kernels chained in reverse.

Counterpart of convtasnet_tpu/ops/pallas/whole_tcn_hybrid.py
(`whole_tcn_train`, `whole_tcn_bwd`, `_bwd_block_kernel`). The forward is
the whole-TCN chain with K2 in save mode and K3 unfolded (the norm2 fold
is inference-only, whole_tcn.py:293-303): it keeps every block's input
x_nb and conv output c_nb, plus K2's small norm2 partials. It never
updates the residual stream in place: block nb writes its output into the
slot of block nb + 1. The backward runs, for nb = NB-1 ... 0, K1 on x_nb
(y1 and the norm1 partials) and the five backward kernels of
tcn_block_bwd.py; dx pad rows stay zero and the weight gradients are f32,
stacked [NB, ...].

Residuals are kept [NB, M, K_pad, ch], each block contiguous for the
kernels (the JAX package's layout is [M, NB, K_pad, ch]).
"""

from __future__ import annotations

import torch

from .tcn_block import in_gemm_plain, tcn_in_gemm
from .tcn_block_bwd import KERNEL_BWD, PLAIN_BWD, block_bwd
from .whole_tcn import KERNEL_STAGES, PLAIN_STAGES


def _dilations(NB: int, X: int):
    return [2 ** (nb % X) for nb in range(NB)]


def chain_save(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, causal, X,
               valid_k, stages=KERNEL_STAGES):
    """Forward keeping the residuals. x [M, K_pad, B] (activation dtype,
    rows >= valid_k zero), weights stacked [NB, ...]. Returns (out,
    x_res [NB, M, K_pad, B], c_res [NB, M, K_pad, H], s2 [NB, ...])."""
    in_gemm, dwconv, out_gemm = stages
    M, Kp, B = x.shape
    NB, P, H = w.shape
    dt = x.dtype
    in_w, out_w = in_w.to(dt), out_w.to(dt)
    x_res = torch.empty((NB, M, Kp, B), dtype=dt, device=x.device)
    c_res = torch.empty((NB, M, Kp, H), dtype=dt, device=x.device)
    x_res[0].copy_(x)
    out = torch.empty_like(x_res[0])
    y1 = e = None
    s2s = []
    for nb, d in enumerate(_dilations(NB, X)):
        y1, s1 = in_gemm(x_res[nb], in_w[nb], a1[nb], norm_type, y1)
        e, s2, _ = dwconv(y1, s1, a1[nb], g1[nb], b1[nb], w[nb], a2[nb], norm_type,
                          d, causal, valid_k, e, save=True, c=c_res[nb])
        s2s.append(s2)
        dst = x_res[nb + 1] if nb + 1 < NB else out
        out_gemm(e, s2, x_res[nb], out_w[nb], g2[nb], b2[nb], norm_type, valid_k,
                 False, dst)
    return out, x_res, c_res, torch.stack(s2s)


def whole_tcn_bwd(g, x_res, c_res, s2, in_w, a1, g1, b1, w, a2, g2, b2, out_w,
                  norm_type, causal, X, valid_k, in_gemm=tcn_in_gemm,
                  bwd_stages=KERNEL_BWD):
    """Backward of the whole chain from the saved residuals: upstream g
    [M, K_pad, B] -> (dx, din_w, da1, dg1, db1, dw, da2, dg2, db2, dout_w),
    the weight gradients f32 and stacked [NB, ...]."""
    NB = w.shape[0]
    dt = x_res.dtype
    in_w, out_w = in_w.to(dt), out_w.to(dt)
    dx = g.to(dt).contiguous()
    dil = _dilations(NB, X)
    y1 = None
    per_block = []
    for nb in range(NB - 1, -1, -1):
        y1, s1 = in_gemm(x_res[nb], in_w[nb], a1[nb], norm_type, y1)
        res = block_bwd(dx, x_res[nb], y1, s1, c_res[nb], s2[nb], in_w[nb], a1[nb],
                        g1[nb], b1[nb], w[nb], a2[nb], g2[nb], b2[nb], out_w[nb],
                        norm_type, dil[nb], causal, valid_k, bwd_stages)
        dx = res[0]
        per_block.append(res[1:])
    grads = [torch.stack([blk[i] for blk in reversed(per_block)]) for i in range(9)]
    return (dx, *grads)


class _WholeTcnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, causal, X,
                valid_k, plain):
        stages = PLAIN_STAGES if plain else KERNEL_STAGES
        out, x_res, c_res, s2 = chain_save(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w,
                                           norm_type, causal, X, valid_k, stages)
        ctx.save_for_backward(x_res, c_res, s2, in_w, a1, g1, b1, w, a2, g2, b2, out_w)
        ctx.static = (norm_type, causal, X, valid_k, plain)
        return out

    @staticmethod
    def backward(ctx, gout):
        norm_type, causal, X, valid_k, plain = ctx.static
        grads = whole_tcn_bwd(gout, *ctx.saved_tensors, norm_type, causal, X, valid_k,
                              in_gemm_plain if plain else tcn_in_gemm,
                              PLAIN_BWD if plain else KERNEL_BWD)
        return (*grads, None, None, None, None, None)


def whole_tcn_train(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, causal, X,
                    valid_k=None, plain=False):
    """Differentiable whole-TCN op. x [M, K_pad, B] padded to a multiple of
    128 with exact-zero pad rows (valid_k = the true frame count; None when
    there is no padding); weights f32 stacked [NB, ...]. A CPU tensor, or
    plain=True, takes the plain versions; a CUDA tensor runs 3 kernels per
    block forward and 6 per block backward (K1 rerun, KB1, KB2, KB3, two
    KW)."""
    K = x.shape[1] if valid_k is None else valid_k
    return _WholeTcnTrain.apply(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type,
                                causal, X, K, plain)

