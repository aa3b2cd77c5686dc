"""Temporal blocks as differentiable ops: kernel forward that saves y1 and
c, plain PyTorch backward that consumes them.

Counterpart of convtasnet_tpu/ops/pallas/whole_block_hybrid.py
(`whole_block_hybrid`, `_hybrid_bwd_math`): the per-block form of the
hybrid training path, which the JAX model takes when the whole-TCN kernel
does not fit the TPU's VMEM. No model form of the port reaches it: past
its memory gate, a fact of HBM, the port takes the `whole` chain, which
saves less (models/conv_tasnet.py); tests and the chip smoke hold this
op on its own. The forward is K1, K2 in save mode
and the unfolded K3 (one fresh y1 and c per block: they are residuals, so
no scratch is shared across blocks); the backward is `hybrid_bwd_math`, a
line-for-line port of the JAX package's plain-array backward (its products
are torch.matmul, as the JAX package leaves them to XLA).

`whole_chain_hybrid` is the chain op: one autograd Function over
the NB blocks, as the JAX model runs this form inside its scan over the
stacked repeats (convtasnet_tpu/models/conv_tasnet.py:317-392). Its
forward writes block nb's input, y1 and c into slot nb of three [NB, ...]
buffers (the bytes the per-block ops save), and its backward runs
`hybrid_bwd_math` for nb = NB-1 ... 0 into row nb of the stacked [NB, ...]
gradients, with the weights cast once per call. `whole_block_hybrid` is
the per-block op (JAX's per-block API).

Backward math (biased-variance layer norm, EPS inside rsqrt): with
vhat = (v - mu) * r, r = rsqrt(var + EPS) over n reduced elements,
d_beta = sum(dy), d_gamma = sum(dy * vhat),
dv = r * (dy*gamma - mean(dy*gamma) - vhat * mean(dy*gamma * vhat));
PReLU: dv = dy * (v >= 0 ? 1 : alpha), d_alpha = sum(dy * min(v, 0));
depthwise: db[j] = sum_p w[p] * dc[j + left - p*d],
dw[p] = sum_k dc[k] * b[k - left + p*d].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...config import EPS
from .tcn_block_bwd import alloc_grads
from .whole_tcn import KERNEL_STAGES, PLAIN_STAGES
from .whole_tcn_hybrid import _dilations, chain_forward


def _prelu(v, alpha):
    return torch.where(v >= 0, v, alpha * v)


def _dprelu(v, alpha):
    return torch.where(v >= 0, torch.ones((), dtype=v.dtype, device=v.device), alpha)


def hybrid_bwd_math(x, y1, c, g, in_w, alpha1, gamma1, beta1, w, alpha2, gamma2,
                    beta2, out_w, norm_type, dilation, causal, K):
    """Backward of one block from the saved x, y1 and c (whole_block_hybrid.py
    :62-204): wide [M, K_pad, H] tensors in the activation dtype, norm
    statistics, reductions, product accumulators and parameter gradients
    in f32. in_w [B, H] and out_w [H, B] come already cast to the
    activation dtype (JAX's version casts them at its start; here the
    caller casts once per call); the other parameters f32. Returns
    (dx, din_w, da1, dg1, db1, dw, da2, dg2, db2, dout_w)."""
    M, K_pad, B = x.shape
    P, H = w.shape
    span = (P - 1) * dilation
    left = span if causal else span // 2
    n = K * H
    dt = x.dtype
    f32 = torch.float32
    gln = norm_type == "gLN"
    a1 = alpha1.to(dt)
    a2 = alpha2.to(dt)
    g1 = gamma1.reshape(1, 1, H).to(dt)
    b1 = beta1.reshape(1, 1, H).to(dt)
    g2 = gamma2.reshape(1, 1, H).to(dt)
    w_dt = w.to(dt)
    zero = torch.zeros((), dtype=dt, device=x.device)
    mask = (torch.arange(K_pad, device=x.device) < K)[None, :, None]

    def rmask(v):
        return torch.where(mask, v, zero.to(v.dtype))

    def gmean(v):
        return v.sum((1, 2), keepdim=True, dtype=f32) / n

    def rstats(v):
        mean = v.float().mean(-1, keepdim=True)
        d = v.float() - mean
        return mean, torch.rsqrt((d * d).mean(-1, keepdim=True) + EPS)

    def norm_stats(v):
        if gln:
            mu = gmean(v)
            return mu, torch.rsqrt(torch.clamp(gmean(v.float() * v.float()) - mu * mu,
                                               min=0.0) + EPS)
        return rstats(v)

    def norm_bwd(dy, vhat, inv, gamma):
        dyg = dy * gamma
        if gln:
            t = dyg - gmean(dyg).to(dt) - vhat * gmean(dyg * vhat).to(dt)
        else:
            t = (dyg - dyg.float().mean(-1, keepdim=True).to(dt)
                 - vhat * (dyg * vhat).float().mean(-1, keepdim=True).to(dt))
        return inv.to(dt) * t

    def mm(a, b):
        return torch.matmul(a.float(), b.float())

    # Recompute the normalised activations from the saved slabs.
    a = _prelu(y1, a1)
    mu1, inv1 = norm_stats(a)
    ahat = (a - mu1.to(dt)) * inv1.to(dt)
    b = rmask(g1 * ahat + b1)
    cf = rmask(c)  # the stored c pad rows are not masked
    e = _prelu(cf, a2)
    mu2, inv2 = norm_stats(e)
    ehat = (e - mu2.to(dt)) * inv2.to(dt)
    z = g2 * ehat + beta2.reshape(1, 1, H).to(dt)

    # out_w backward
    g_dt = rmask(g.to(dt))
    dz = mm(g_dt, out_w.t()).to(dt)
    dout_w = mm(z.reshape(-1, H).t(), g_dt.reshape(-1, B))

    # norm2 / PReLU2 backward
    dg2 = (dz.float() * ehat.float()).sum((0, 1))
    db2 = dz.sum((0, 1), dtype=f32)
    de = rmask(norm_bwd(dz, ehat, inv2, g2))
    da2 = (de.float() * torch.clamp(cf, max=0).float()).sum()
    dc = de * _dprelu(cf, a2)

    # depthwise transpose
    bp = F.pad(b, (0, 0, left, span - left))
    dw = torch.stack([(dc.float() * bp[:, p * dilation:p * dilation + K_pad].float())
                      .sum((0, 1)) for p in range(P)])
    dcp = F.pad(dc, (0, 0, span - left, left))
    db = None
    for p in range(P):
        tap = w_dt[p] * dcp[:, span - p * dilation:span - p * dilation + K_pad]
        db = tap if db is None else db + tap
    db = rmask(db)

    # norm1 / PReLU1 backward
    dg1 = (db.float() * ahat.float()).sum((0, 1))
    db1 = db.sum((0, 1), dtype=f32)
    da = rmask(norm_bwd(db, ahat, inv1, g1))
    da1 = (da.float() * torch.clamp(y1, max=0).float()).sum()
    dy1 = da * _dprelu(y1, a1)

    # in_w backward and the residual path
    dx = rmask(mm(dy1, in_w.t()).to(dt) + g_dt)
    din_w = mm(x.reshape(-1, B).t(), dy1.reshape(-1, H))
    return (dx, din_w, da1, dg1, db1, dw, da2, dg2, db2, dout_w)


class _WholeBlockHybrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, dilation,
                causal, valid_k, plain):
        in_gemm, dwconv, out_gemm = PLAIN_STAGES if plain else KERNEL_STAGES
        dt = x.dtype
        y1, s1 = in_gemm(x, in_w.to(dt), a1, norm_type)
        e, s2, c = dwconv(y1, s1, a1, g1, b1, w, a2, norm_type, dilation, causal, valid_k,
                          save=True)
        out = out_gemm(e, s2, x, out_w.to(dt), g2, b2, norm_type, valid_k, False)
        ctx.save_for_backward(x, y1, c, in_w, a1, g1, b1, w, a2, g2, b2, out_w)
        ctx.static = (norm_type, dilation, causal, valid_k)
        return out

    @staticmethod
    def backward(ctx, gout):
        x, y1, c, in_w, a1, g1, b1, w, a2, g2, b2, out_w = ctx.saved_tensors
        norm_type, dilation, causal, valid_k = ctx.static
        dt = x.dtype
        dx, din_w, da1, dg1, db1, dw, da2, dg2, db2, dout_w = hybrid_bwd_math(
            x, y1, c, gout, in_w.to(dt), a1, g1, b1, w, a2, g2, b2, out_w.to(dt), norm_type,
            dilation, causal, valid_k)
        return (dx, din_w, da1.reshape(a1.shape), dg1, db1, dw, da2.reshape(a2.shape),
                dg2, db2, dout_w, None, None, None, None, None)


def whole_block_hybrid(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, dilation,
                       causal, valid_k=None, plain=False):
    """Differentiable whole-block op (saved-residual backward). x
    [M, K_pad, B] with exact-zero pad rows (valid_k = the true frame
    count); block weights f32, a1 / a2 0-d. A CUDA tensor runs K1, K2
    (save) and K3 (unfolded) forward; the backward is plain PyTorch."""
    K = x.shape[1] if valid_k is None else valid_k
    return _WholeBlockHybrid.apply(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type,
                                   dilation, causal, K, plain)


def hybrid_chain_bwd(g, x_res, y1_res, c_res, params, norm_type, causal, dilations, valid_k):
    """Backward of the chain from its saved block inputs x_res [NB, M,
    K_pad, B], y1_res and c_res [NB, M, K_pad, H]: upstream g [M, K_pad, B]
    -> (dx, din_w, da1, dg1, db1, dw, da2, dg2, db2, dout_w), the weight
    gradients f32 and stacked [NB, ...], row nb from block nb's
    hybrid_bwd_math. params are the nine stacked f32 block parameters."""
    in_w, a1, g1, b1, w, a2, g2, b2, out_w = params
    dt = x_res.dtype
    in_wc, out_wc = in_w.to(dt), out_w.to(dt)
    grads = alloc_grads(params)
    dx = g
    for nb in range(len(dilations) - 1, -1, -1):
        dx, *rows = hybrid_bwd_math(x_res[nb], y1_res[nb], c_res[nb], dx, in_wc[nb], a1[nb],
                                    g1[nb], b1[nb], w[nb], a2[nb], g2[nb], b2[nb], out_wc[nb],
                                    norm_type, dilations[nb], causal, valid_k)
        for grad, row in zip(grads, rows):
            grad[nb] = row
    return (dx, *grads)


class _WholeChainHybrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, causal, X,
                valid_k, plain):
        NB, _, H = w.shape
        y1_res = torch.empty((NB, *x.shape[:2], H), dtype=x.dtype, device=x.device)
        out, x_res, c_res, _ = chain_forward(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w,
                                             norm_type, causal, X, valid_k,
                                             PLAIN_STAGES if plain else KERNEL_STAGES,
                                             save=True, y1_res=y1_res)
        ctx.save_for_backward(x_res, y1_res, c_res, in_w, a1, g1, b1, w, a2, g2, b2, out_w)
        ctx.static = (norm_type, causal, X, valid_k)
        return out

    @staticmethod
    def backward(ctx, gout):
        x_res, y1_res, c_res, *params = ctx.saved_tensors
        norm_type, causal, X, valid_k = ctx.static
        grads = hybrid_chain_bwd(gout, x_res, y1_res, c_res, params, norm_type, causal,
                                 _dilations(x_res.shape[0], X), valid_k)
        return (*grads, None, None, None, None, None)


def whole_chain_hybrid(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type, causal, X,
                       valid_k=None, plain=False):
    """The NB blocks of the per-block hybrid form as one differentiable op.
    x [M, K_pad, B] with exact-zero pad rows (valid_k = the true frame
    count); weights f32 stacked [NB, ...], block nb at dilation
    2 ** (nb % X). A CPU tensor, or plain=True, takes the plain versions; a
    CUDA tensor runs K1, K2 (save) and K3 (unfolded) per block forward; the
    backward is plain PyTorch, block by block."""
    K = x.shape[1] if valid_k is None else valid_k
    return _WholeChainHybrid.apply(x, in_w, a1, g1, b1, w, a2, g2, b2, out_w, norm_type,
                                   causal, X, K, plain)
