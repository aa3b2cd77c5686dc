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
tcn_block_bwd.py, which write the block's f32 weight-gradient partials
into its slot of its group's buffers; when a group of blocks is done, one
KF launch writes their f32 weight gradients into their rows of the
stacked [NB, ...] gradients (the TPU kernel keeps them in accumulators
resident across its grid). Groups are filled from block NB-1 down, as
many blocks each as tcn_block_bwd.finish_group allows, the last one
partial; dx pad rows stay zero.
The weights are cast and transposed once per call, not per block, so the
per-block loop launches the hand-written kernels only.

Residuals are kept [NB, M, K_pad, ch], each block contiguous for the
kernels (the JAX package's layout is [M, NB, K_pad, ch]).

With a skip path (skip_w [NB, H, Sc], the paper's final version) the op
returns (out, s): every block's K3 adds e @ skip_w into one skip-sum
buffer s [M, K_pad, Sc] in place. s is not saved per block: its cotangent
g_s reaches every block unchanged, so the backward hands the one g_s to
each block's KB1 and KW z (their skip modes) and KF returns d[out_w |
skip_w], split into the two leaves' gradients.
"""

from __future__ import annotations

import functools
import math

import torch

from .tcn_block import (dwconv_plain, dwconv_stats_shape, in_gemm_plain, out_weights,
                        tcn_dwconv, tcn_in_gemm)
from .tcn_block_bwd import (KERNEL_BWD, PLAIN_BWD, FinishSlots, PartCounts, alloc_grads,
                            block_partials, finish_group, part_counts, slot_bytes)
from .whole_tcn import KERNEL_STAGES, PLAIN_STAGES


def _dilations(NB: int, X: int):
    return [2 ** (nb % X) for nb in range(NB)]


def _stats_rows(x, w, norm_type, dilations, plain):
    """One buffer of every block's K2 partials, as views of each block's
    own shape (dw_plan may tile each dilation differently)."""
    M, Kp, _ = x.shape
    _, P, H = w.shape
    shapes = [dwconv_stats_shape(M, Kp, H, P, d, x.element_size(), norm_type, plain)
              for d in dilations]
    flat = torch.empty(sum(math.prod(s) for s in shapes), dtype=torch.float32,
                       device=x.device)
    views, off = [], 0
    for s in shapes:
        n = math.prod(s)
        views.append(flat[off:off + n].view(s))
        off += n
    return views


def chain_forward(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, causal, X,
                  valid_k, stages=KERNEL_STAGES, save=True, y1_res=None, skip_w=None, s=None):
    """Forward keeping every block's input: x [M, K_pad, B] (activation
    dtype, rows >= valid_k zero), weights stacked [NB, ...]. Block nb
    writes its output into slot nb + 1 of x_res [NB, M, K_pad, B]. With
    save, K2 runs in save mode and c_res [NB, M, K_pad, H] and the norm2
    partials s2 (one view per block) are kept too. With y1_res [NB, M,
    K_pad, H] given, K1 writes block nb's y1 into slot nb of it (the
    per-block hybrid chain's residual). With skip_w, each block's K3 also
    adds into the skip sum `s` [M, K_pad, Sc] (zero on entry) in place.
    Returns (out, x_res, c_res, s2), the last two None without save."""
    in_gemm, dwconv, out_gemm = stages
    M, Kp, B = x.shape
    NB, P, H = w.shape
    dt = x.dtype
    dil = _dilations(NB, X)
    in_w, out_w = in_w.to(dt), out_weights(out_w, skip_w).to(dt)
    x_res = torch.empty((NB, M, Kp, B), dtype=dt, device=x.device)
    x_res[0].copy_(x)
    out = torch.empty_like(x_res[0])
    c_res = s2 = None
    if save:
        c_res = torch.empty((NB, M, Kp, H), dtype=dt, device=x.device)
        plain = dwconv is dwconv_plain or x.device.type == "cpu"
        s2 = _stats_rows(x, w, norm_type, dil, plain)
    y1 = e = None
    for nb, d in enumerate(dil):
        y1, s1 = in_gemm(x_res[nb], in_w[nb], a1[nb], norm_type,
                         y1 if y1_res is None else y1_res[nb])
        dargs = (y1, s1, a1[nb], g1[nb], b1[nb], w[nb], a2[nb], norm_type, d, causal,
                 valid_k, e)
        if save:
            e, s2nb, _ = dwconv(*dargs, save=True, c=c_res[nb], stats=s2[nb])
        else:
            e, s2nb = dwconv(*dargs)
        dst = x_res[nb + 1] if nb + 1 < NB else out
        out_gemm(e, s2nb, x_res[nb], out_w[nb], g2[nb], b2[nb], norm_type, valid_k,
                 False, dst, *(() if skip_w is None else (s,)))
    return out, x_res, c_res, s2


def chain_save(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, causal, X,
               valid_k, stages=KERNEL_STAGES):
    """Forward keeping the residuals. x [M, K_pad, B] (activation dtype,
    rows >= valid_k zero), weights stacked [NB, ...]. Returns (out,
    x_res [NB, M, K_pad, B], c_res [NB, M, K_pad, H], s2: the K2 partials
    of each block)."""
    return chain_forward(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, causal, X,
                         valid_k, stages, save=True)


def _transposed(wts, dt):
    """[NB, a, b] -> [NB, b, a] contiguous in dt: one copy per call."""
    NB, a, b = wts.shape
    return torch.empty((NB, b, a), dtype=dt, device=wts.device).copy_(wts.transpose(1, 2))


@functools.lru_cache(maxsize=64)
def finish_plan(M: int, Kp: int, B: int, H: int, P: int, dilations: tuple, dt, plain: bool,
                index=None, group=None, Sc: int = 0):
    """(blocks per KF launch, each block's PartCounts, the most partials of
    any block) of the backward of a chain of blocks at `dilations` (Sc:
    with a skip path); `group` forces the blocks per launch. Cached per
    shape: it is on the eager step's host path."""
    counts = [part_counts(M, Kp, B, H, P, d, dt, plain, index, Sc) for d in dilations]
    cap = PartCounts(*map(max, zip(*counts)))
    G = group or finish_group(len(dilations), slot_bytes(cap, B, H, P, Sc))
    return min(G, len(dilations)), counts, cap


def chain_bwd(g, x_res, c_res, s2, params, norm_type, causal, dilations, valid_k,
              in_gemm=tcn_in_gemm, bwd_stages=KERNEL_BWD, dwconv=tcn_dwconv, group=None,
              gs=None):
    """Backward of a chain of blocks from their saved inputs x_res [NB, M,
    K_pad, B]: upstream g [M, K_pad, B] -> (dx, din_w, da1, dg1, db1, dw,
    da2, dg2, db2, dout_w), the weight gradients f32 and stacked [NB, ...].
    params are the nine stacked block parameters, block nb at dilations[nb].
    With c_res / s2 None, each block recomputes c and the norm2 partials
    with K2 in save mode (the recompute form); else they are read. KF runs
    once per group of blocks (finish_plan; `group` forces its size). With
    gs [M, K_pad, Sc], the skip sum's cotangent, the last parameter is
    [out_w | skip_w] [NB, H, B + Sc] and so is its gradient."""
    in_w, a1, g1, b1, w, a2, g2, b2, out_w = params
    dt = x_res.dtype
    NB, M, Kp, B = x_res.shape
    P, H = w.shape[1:]
    Sc = 0 if gs is None else gs.shape[2]
    in_wc = in_w.to(dt)
    in_wt, out_wt = _transposed(in_w, dt), _transposed(out_w, dt)
    grads = alloc_grads(params)
    plain = bwd_stages is PLAIN_BWD or x_res.device.type == "cpu"
    G, counts, cap = finish_plan(M, Kp, B, H, P, tuple(dilations), dt, plain,
                                 x_res.device.index, group, Sc)
    slots = FinishSlots.alloc(G, cap, B, H, P, x_res.device, Sc)
    if gs is not None:
        gs = gs.to(dt).contiguous()
    finish = bwd_stages[-1]
    dx = g.to(dt).contiguous()
    y1 = e = c = None
    for nb in range(NB - 1, -1, -1):
        # block nb's group: rows [nb0, top), filled from the top down
        top = NB - (NB - 1 - nb) // G * G
        nb0 = max(0, top - G)
        d = dilations[nb]
        y1, s1 = in_gemm(x_res[nb], in_wc[nb], a1[nb], norm_type, y1)
        if c_res is None:
            e, s2nb, c = dwconv(y1, s1, a1[nb], g1[nb], b1[nb], w[nb], a2[nb], norm_type,
                                d, causal, valid_k, e, save=True, c=c)
        else:
            c, s2nb = c_res[nb], s2[nb]
        dx = block_partials(dx, x_res[nb], y1, s1, c, s2nb, in_wt[nb], a1[nb], g1[nb], b1[nb],
                            w[nb], a2[nb], g2[nb], b2[nb], out_wt[nb], norm_type, d, causal,
                            valid_k, slots.slot(nb - nb0, counts[nb]), bwd_stages, gs)
        if nb == nb0:
            finish(slots, counts[nb0:top], grads, nb0)
    return (dx, *grads)


def whole_tcn_bwd(g, x_res, c_res, s2, in_w, a1, g1, b1, w, a2, g2, b2, out_w,
                  norm_type, causal, X, valid_k, in_gemm=tcn_in_gemm,
                  bwd_stages=KERNEL_BWD, group=None):
    """Backward of the whole chain from the saved residuals: upstream g
    [M, K_pad, B] -> (dx, din_w, da1, dg1, db1, dw, da2, dg2, db2, dout_w),
    the weight gradients f32 and stacked [NB, ...]; `group` forces the
    blocks per KF launch."""
    params = (in_w, a1, g1, b1, w, a2, g2, b2, out_w)
    return chain_bwd(g, x_res, c_res, s2, params, norm_type, causal,
                     _dilations(w.shape[0], X), valid_k, in_gemm, bwd_stages, group=group)


class _WholeTcnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, causal, X,
                valid_k, plain, skip_w=None):
        stages = PLAIN_STAGES if plain else KERNEL_STAGES
        s = None
        if skip_w is not None:
            s = torch.zeros(x.shape[:2] + (skip_w.shape[2],), dtype=x.dtype, device=x.device)
        out, x_res, c_res, s2 = chain_forward(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w,
                                              norm_type, causal, X, valid_k, stages,
                                              skip_w=skip_w, s=s)
        ctx.save_for_backward(x_res, c_res, in_w, a1, g1, b1, w, a2, g2, b2,
                              out_weights(out_w, skip_w), *s2)
        ctx.static = (norm_type, causal, X, valid_k, plain, out_w.shape[2])
        return out, s

    @staticmethod
    def backward(ctx, gout, gs=None):
        norm_type, causal, X, valid_k, plain, B = ctx.static
        x_res, c_res, *rest = ctx.saved_tensors
        params, s2 = rest[:9], rest[9:]
        grads = chain_bwd(gout, x_res, c_res, s2, params, norm_type, causal,
                          _dilations(params[4].shape[0], X), valid_k,
                          in_gemm_plain if plain else tcn_in_gemm,
                          PLAIN_BWD if plain else KERNEL_BWD, gs=gs)
        dw_out = grads[-1]
        return (*grads[:-1], dw_out[..., :B], None, None, None, None, None,
                None if gs is None else dw_out[..., B:])


def whole_tcn_train(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, causal, X,
                    valid_k=None, plain=False, skip_w=None):
    """Differentiable whole-TCN op. x [M, K_pad, B] padded to a multiple of
    128 with exact-zero pad rows (valid_k = the true frame count; None when
    there is no padding); weights f32 stacked [NB, ...]. A CPU tensor, or
    plain=True, takes the plain versions; a CUDA tensor runs 3 kernels per
    block forward and 6 per block backward (K1 rerun, KB1, KB2, KB3, two
    KW) and one KF per group of blocks. Returns (out, s): with skip_w [NB,
    H, Sc] s is the skip sum [M, K_pad, Sc] (module docstring), else None."""
    K = x.shape[1] if valid_k is None else valid_k
    return _WholeTcnTrain.apply(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type,
                                causal, X, K, plain, skip_w)
