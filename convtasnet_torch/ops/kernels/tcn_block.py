"""Wrappers of the three TCN-block kernels (csrc/tcn_block.cu) and their
plain PyTorch versions.

One temporal block runs as
  K1 tcn_in_gemm:  y1 = round(x @ in_w), partial sums of a = PReLU(y1);
  K2 tcn_dwconv:   e = round(PReLU(dwconv(round(norm1(a))))), partial sums
                   of e over the rows < K;
  K3 tcn_out_gemm: x' = round(x + round(norm2(e) @ out_w)), in place when
                   the caller passes out=x, with
                   norm2 folded into the product (fold=True, the whole-TCN
                   form) or applied to the A operand (fold=False, the
                   whole-block form); rows >= K stay exactly zero.

Tensors are [M, K_pad, ch] with K_pad a multiple of 128 and rows >= K zero.
The norm statistics travel between the kernels as (sum, sum of squares)
partials: gLN [M, n, 2] per item, cLN [M, K_pad, n, 2] per row. The kernels
write one partial per CTA tile; the plain versions write n = 1. The reader
sums whatever n it is given.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Each wrapper counts its launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...config import EPS
from . import _build

# Tile sizes of csrc/tcn_block.cuh.
BM, BN, BK, DW_ROWS = 64, 128, 32, 32
ROW_ALIGN = 128  # K_pad multiple (the JAX package pads to 128 the same way)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tcn_in_gemm": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "tcn_dwconv": [_I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "tcn_out_gemm": [_I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                     _I, _I, _I, _P],
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("tcn_block")
    for fn, args in _SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes, f.restype = args, ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(*ts: torch.Tensor, dtype=None) -> None:
    dev = ts[0].device
    for t in ts:
        _require(t.is_cuda and t.device == dev, "all tensors must be on one CUDA device")
        _require(t.is_contiguous(), "tensors must be contiguous")
        if dtype is not None:
            _require(t.dtype == dtype, f"expected {dtype}, got {t.dtype}")


def _check_widths(Kp: int, B: int, H: int, dt: torch.dtype) -> None:
    _require(dt in _DTYPES, f"unsupported activation dtype {dt}")
    _require(Kp % ROW_ALIGN == 0, f"K_pad={Kp} is not a multiple of {ROW_ALIGN}")
    _require(B % BN == 0 and H % BN == 0,
             f"B={B} and H={H} must be multiples of {BN} for the kernels")


def _prelu_f32(v: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, v, alpha.float() * v)


def _moments(s: torch.Tensor, n: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, 1/sqrt(var + EPS)) from [..., 2] sums over n values (one-pass
    variance clamped at 0, as the kernels)."""
    mean = s[..., 0] / n
    var = torch.clamp(s[..., 1] / n - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + EPS)


def _sums(v: torch.Tensor, dims) -> torch.Tensor:
    return torch.stack([v.sum(dims), (v * v).sum(dims)], dim=-1)


# ---------------------------------------------------------------------------
# K1: y1 = round(x @ in_w) and partial sums of PReLU(y1)
# ---------------------------------------------------------------------------

def _into(out: Optional[torch.Tensor], value: torch.Tensor) -> torch.Tensor:
    return value if out is None else out.copy_(value)


def in_gemm_plain(x, in_w, alpha1, norm_type, y1: Optional[torch.Tensor] = None):
    """Plain version of K1. x [M, K_pad, B], in_w [B, H] (activation dtype)."""
    y1 = _into(y1, torch.matmul(x.float(), in_w.float()).to(x.dtype))
    a = _prelu_f32(y1.float(), alpha1)
    if norm_type == "gLN":
        return y1, _sums(a, (1, 2))[:, None, :]
    return y1, _sums(a, -1)[:, :, None, :]


def tcn_in_gemm(x, in_w, alpha1, norm_type, y1: Optional[torch.Tensor] = None):
    """K1. Returns (y1 [M, K_pad, H], partial sums); y1 may be given."""
    if x.device.type == "cpu":
        return in_gemm_plain(x, in_w, alpha1, norm_type, y1)
    M, Kp, B = x.shape
    H = in_w.shape[1]
    dt = x.dtype
    _check_widths(Kp, B, H, dt)
    _require(in_w.shape == (B, H), f"in_w shape {tuple(in_w.shape)} != {(B, H)}")
    alpha1 = alpha1.reshape(1)
    if y1 is None:
        y1 = torch.empty((M, Kp, H), dtype=dt, device=x.device)
    gln = norm_type == "gLN"
    nct = H // BN
    stats = torch.empty((M, Kp // BM * nct, 2) if gln else (M, Kp, nct, 2),
                        dtype=torch.float32, device=x.device)
    _check_cuda(x, in_w, y1, dtype=dt)
    _check_cuda(x, alpha1, stats, dtype=None)
    _require(y1.shape == (M, Kp, H), "y1 scratch has the wrong shape")
    rc = _lib().tcn_in_gemm(x.device.index, _DTYPES[dt], x.data_ptr(), in_w.data_ptr(),
                            alpha1.data_ptr(), y1.data_ptr(), stats.data_ptr(),
                            M * Kp, Kp, B, H, int(gln), _stream(x))
    _build.check(rc, "tcn_in_gemm")
    tcn_in_gemm.launches += 1
    return y1, stats


tcn_in_gemm.launches = 0


# ---------------------------------------------------------------------------
# K2: norm1 -> dilated depthwise conv -> PReLU, partial sums of e
# ---------------------------------------------------------------------------

def dwconv_plain(y1, stats1, alpha1, g1, b1, w, alpha2, norm_type, dilation,
                 causal, valid_k, e: Optional[torch.Tensor] = None):
    """Plain version of K2 (whole_tcn.py:139-188 with the conv halo of
    rows outside [0, K) zero)."""
    M, Kp, H = y1.shape
    dt = y1.dtype
    a = _prelu_f32(y1.float(), alpha1)
    if norm_type == "gLN":
        mean, inv = _moments(stats1.sum(1), float(valid_k) * H)
        mean, inv = mean[:, None, None], inv[:, None, None]
    else:
        mean, inv = _moments(stats1.sum(2), float(H))
        mean, inv = mean[..., None], inv[..., None]
    b = g1 * ((a - mean) * inv) + b1
    rows = (torch.arange(Kp, device=y1.device) < valid_k)[None, :, None]
    b = torch.where(rows, b, 0.0).to(dt)
    P = w.shape[0]
    span = (P - 1) * dilation
    left = span if causal else span // 2
    bp = F.pad(b, (0, 0, left, span - left))
    c = None
    for p in range(P):
        tap = bp[:, p * dilation: p * dilation + Kp].float() * w[p]
        c = tap if c is None else c + tap
    ev = _prelu_f32(c, alpha2)
    em = torch.where(rows, ev, 0.0)
    stats = _sums(em, (1, 2))[:, None, :] if norm_type == "gLN" else _sums(em, -1)[:, :, None, :]
    return _into(e, ev.to(dt)), stats


def tcn_dwconv(y1, stats1, alpha1, g1, b1, w, alpha2, norm_type, dilation,
               causal, valid_k, e: Optional[torch.Tensor] = None):
    """K2. Returns (e [M, K_pad, H], partial sums); e may be given."""
    if y1.device.type == "cpu":
        return dwconv_plain(y1, stats1, alpha1, g1, b1, w, alpha2, norm_type,
                            dilation, causal, valid_k, e)
    M, Kp, H = y1.shape
    P = w.shape[0]
    dt = y1.dtype
    _check_widths(Kp, BN, H, dt)
    _require(0 < valid_k <= Kp, f"valid_k={valid_k} outside (0, {Kp}]")
    _require(w.shape == (P, H) and g1.shape == (H,) and b1.shape == (H,),
             "depthwise / norm1 parameter shapes do not match H")
    span = (P - 1) * dilation
    _require(span <= 4096, f"conv span {span} exceeds the kernel's halo limit")
    gln = norm_type == "gLN"
    alpha1, alpha2 = alpha1.reshape(1), alpha2.reshape(1)
    if e is None:
        e = torch.empty_like(y1)
    stats = torch.empty((M, Kp // DW_ROWS, 2) if gln else (M, Kp, 1, 2),
                        dtype=torch.float32, device=y1.device)
    _check_cuda(y1, e, dtype=dt)
    _check_cuda(y1, stats1, alpha1, g1, b1, w, alpha2, stats, dtype=None)
    for t in (stats1, alpha1, g1, b1, w, alpha2):
        _require(t.dtype == torch.float32, "statistics and parameters must be float32")
    n1 = stats1.shape[1] if gln else stats1.shape[2]
    _require(stats1.shape[0] == M and (gln or stats1.shape[1] == Kp),
             "stats1 does not match y1")
    rc = _lib().tcn_dwconv(y1.device.index, _DTYPES[dt], y1.data_ptr(), stats1.data_ptr(),
                           n1, alpha1.data_ptr(), g1.data_ptr(), b1.data_ptr(),
                           w.data_ptr(), alpha2.data_ptr(), e.data_ptr(),
                           stats.data_ptr(), M, Kp, valid_k, H, P, dilation,
                           int(causal), int(gln), _stream(y1))
    _build.check(rc, "tcn_dwconv")
    tcn_dwconv.launches += 1
    return e, stats


tcn_dwconv.launches = 0


# ---------------------------------------------------------------------------
# K3: norm2 -> out_w -> residual add (in place)
# ---------------------------------------------------------------------------

def fold_weights(out_w, g2, b2, dtype):
    """Per-block terms of the norm2 -> out_w fold (whole_tcn.py:189-228)
    for stacked [NB, H, B] / [NB, H] weights: (round(g2 * W), g2 @ W,
    b2 @ W) with W = out_w rounded to the activation dtype."""
    ow32 = out_w.to(dtype).float()
    wp = (g2[..., :, None] * ow32).to(dtype)
    g2w = torch.matmul(g2[..., None, :], ow32)[..., 0, :]
    b2w = torch.matmul(b2[..., None, :], ow32)[..., 0, :]
    return wp.contiguous(), g2w.contiguous(), b2w.contiguous()


def out_gemm_plain(e, stats2, res, wmat, vec_a, vec_b, norm_type, valid_k,
                   fold, out=None):
    """Plain version of K3: returns round(res + o) with rows >= valid_k
    zero, written into `out` when given (which may be `res`).

    fold:   wmat = round(g2 * out_w), vec_a = g2 @ W, vec_b = b2 @ W;
    unfold: wmat = out_w (activation dtype), vec_a = g2, vec_b = b2."""
    M, Kp, H = e.shape
    dt = e.dtype
    if norm_type == "gLN":
        mean, inv = _moments(stats2.sum(1), float(valid_k) * H)
        mean, inv = mean[:, None, None], inv[:, None, None]
    else:
        mean, inv = _moments(stats2.sum(2), float(H))
        mean, inv = mean[..., None], inv[..., None]
    if fold:
        t = torch.matmul(e.float(), wmat.float())
        if norm_type == "gLN":
            o = inv * t + (vec_b - (inv * mean) * vec_a)
        else:
            o = inv * (t - mean * vec_a) + vec_b
    else:
        z = (vec_a * ((e.float() - mean) * inv) + vec_b).to(dt)
        o = torch.matmul(z.float(), wmat.float())
    rows = (torch.arange(Kp, device=e.device) < valid_k)[None, :, None]
    return _into(out, torch.where(rows, res + o.to(dt),
                                  torch.zeros((), dtype=dt, device=e.device)))


def tcn_out_gemm(e, stats2, res, wmat, vec_a, vec_b, norm_type, valid_k, fold,
                 out=None):
    """K3: round(res + round(norm2(e) @ out_w)), rows >= valid_k zeroed,
    into `out` (a new tensor when None; in place when out is res)."""
    if e.device.type == "cpu":
        return out_gemm_plain(e, stats2, res, wmat, vec_a, vec_b, norm_type,
                              valid_k, fold, out)
    M, Kp, H = e.shape
    B = res.shape[2]
    dt = e.dtype
    _check_widths(Kp, B, H, dt)
    _require(res.shape == (M, Kp, B) and wmat.shape == (H, B),
             "residual / weight shapes do not match e")
    if out is None:
        out = torch.empty_like(res)
    _require(0 < valid_k <= Kp, f"valid_k={valid_k} outside (0, {Kp}]")
    nv = B if fold else H
    _require(vec_a.shape == (nv,) and vec_b.shape == (nv,),
             "norm2 vectors have the wrong length")
    gln = norm_type == "gLN"
    _check_cuda(e, res, out, wmat, dtype=dt)
    _require(out.shape == res.shape, "out does not match the residual")
    _check_cuda(e, stats2, vec_a, vec_b)
    for t in (stats2, vec_a, vec_b):
        _require(t.dtype == torch.float32, "statistics and norm2 terms must be float32")
    n2 = stats2.shape[1] if gln else stats2.shape[2]
    _require(stats2.shape[0] == M and (gln or stats2.shape[1] == Kp),
             "stats2 does not match e")
    rc = _lib().tcn_out_gemm(e.device.index, _DTYPES[dt], int(fold), e.data_ptr(),
                             stats2.data_ptr(), n2, wmat.data_ptr(), vec_a.data_ptr(),
                             vec_b.data_ptr(), res.data_ptr(), out.data_ptr(),
                             M * Kp, Kp, valid_k,
                             H, B, int(gln), _stream(e))
    _build.check(rc, "tcn_out_gemm")
    if fold:
        tcn_out_gemm.launches_fold += 1
    else:
        tcn_out_gemm.launches_unfold += 1
    return out


tcn_out_gemm.launches_fold = 0
tcn_out_gemm.launches_unfold = 0


def reset_counts() -> None:
    tcn_in_gemm.launches = 0
    tcn_dwconv.launches = 0
    tcn_out_gemm.launches_fold = 0
    tcn_out_gemm.launches_unfold = 0


def counts() -> dict:
    return {"tcn_in_gemm": tcn_in_gemm.launches,
            "tcn_dwconv": tcn_dwconv.launches,
            "tcn_out_gemm_fold": tcn_out_gemm.launches_fold,
            "tcn_out_gemm_unfold": tcn_out_gemm.launches_unfold}
