"""Wrappers of the TCN-block backward kernels (csrc/tcn_block_bwd.cu) and
their plain PyTorch versions.

The backward of one block, given the upstream cotangent g [M, K_pad, B],
the block input x, y1 and the norm1 partials s1 (K1 rerun on x), the saved
conv output c and the norm2 partials s2 (K2 in save mode), runs as

  KB1 tcn_bwd_dz:      dz = round(g @ out_w^T), partials of dg2, db2 and of
                       the norm2 backward sums (sum dz*g2, sum dz*g2*ehat);
                       in bf16 on the TMA + wgmma pipeline, tiled by
                       tcn_block.gemm_plan;
  KW  tcn_wgrad (z):   dout_w = z^T g, z = round(norm2(PReLU2(c)));
  KB2 tcn_bwd_dwconv:  de, dc = round(de * PReLU2'(c)), the depthwise
                       transpose db, partials of dw, dg1, db1, d_alpha2 and
                       of the norm1 backward sums; a streaming stencil
                       down strips of rows (csrc/tcn_dwconv_sm90.cuh),
                       planned by tcn_block.kb2_plan;
  KB3 tcn_bwd_dx:      da, dy1 = round(da * PReLU1'(y1)), dx = round(round(
                       dy1 @ in_w^T) + g) with rows >= K zero, d_alpha1
                       partials; in bf16 on the TMA + wgmma pipeline
                       (csrc/tcn_gemm_sm90.cuh), tiled by
                       tcn_block.gemm_plan without a column split;
  KW  tcn_wgrad:       din_w = x^T dy1; in bf16 both KW forms run on a
                       TMA + wgmma kernel (csrc/tcn_wgrad_sm90.cuh) whose
                       row splits (`wgrad_plan`) are summed in a fixed
                       order inside clusters of CTAs;

  KF  tcn_bwd_finish:  sums the f32 weight-gradient partials the five wrote
                       into the slots of a group of blocks (FinishSlots),
                       each over its first axis in a fixed order, into
                       their rows of the stacked [NB, ...] f32 gradients:
                       one launch per group (csrc/tcn_bwd_finish.cuh).

A block with a skip path (Sc skip channels, the paper's final version:
s += e @ skip_w) gets a second cotangent, g_s [M, K_pad, Sc] of the skip
sum, the same for every block. KB1 and KW z then run in their skip modes
over [g | g_s] and [out_w | skip_w]: dz = round([g | g_s] @ [out_w |
skip_w]^T), a depth of B + Sc from two operands, and d[out_w | skip_w] =
z^T [g | g_s], [H, B + Sc]; KF sums those partials in its skip kernel into
the stacked [NB, H, B + Sc] gradient. KB2, KB3 and KW din are unchanged
(g_s never enters x's gradient). The skip modes run bf16 only, and have
kernels and launch counters of their own (`*_skip`).

`block_partials` runs the five into one slot and returns dx; `block_bwd`
is one block's backward, finished (a group of one). Rows >= K of g are
ignored. The
partial layouts follow tcn_block.py: gLN [M, n, 2] per item, cLN [M,
K_pad, n, 2] per row, and the reader sums whatever n it is given; the
plain versions write n = 1.

Counterpart of the TPU kernels whole_tcn_hybrid.py `_bwd_block_kernel`
and whole_block_vjp.py `_bwd_kernel`; the math is their norm / PReLU /
depthwise backward (whole_block_hybrid.py:22-34). A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ...utils import ledger
from . import _build
from .limits import BWD_MAX_SPAN, BWD_MAXP
from .limits import KERNEL_WIDTH
from .tcn_block import (_DTYPES, BM, BN, H_DX, H_DZ, H_SKIP, SMEM_LIMIT, StripPlan, _check_cuda,
                        _check_gemm_h, _check_widths, _moments, _prelu_f32, _require, _sm_count,
                        _stream, card_resident, gemm_plan, kb2_plan, KB2_WARPS)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tcn_bwd_dz": [_I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "tcn_wgrad": [_I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "tcn_wgrad_max_clusters": [_I, _I, _I],
    "tcn_bwd_dwconv": [_I, _I, _P, _P, _P, _P, _I, _P, _I, _P, _I,
                       _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "tcn_bwd_dx": [_I, _I, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P,
                   _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "tcn_gemm_resident": [_I, _I, _I, _I],
    "tcn_bwd_finish": [_I, _P, _I, _P],
    "tcn_bwd_finish_args_bytes": [],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("tcn_block_bwd")
    for fn, args in _SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes, f.restype = args, ctypes.c_int
    _require(lib.tcn_bwd_finish_args_bytes() == ctypes.sizeof(_FinGroup),
             "KF's launch arguments do not match csrc/tcn_bwd_finish.cuh")
    return lib


@functools.lru_cache(maxsize=None)
def _resident(index: int, mode: int) -> Tuple:
    return card_resident(_lib(), index, mode)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _rows(Kp: int, valid_k: int, device) -> torch.Tensor:
    return (torch.arange(Kp, device=device) < valid_k)[None, :, None]


def _norm_terms(stats, norm_type, valid_k, H):
    """(mean, inv) broadcastable to [M, K_pad, 1] from (sum, sumsq) partials."""
    if norm_type == "gLN":
        mean, inv = _moments(stats.sum(1), float(valid_k) * H)
        return mean[:, None, None], inv[:, None, None]
    mean, inv = _moments(stats.sum(2), float(H))
    return mean[..., None], inv[..., None]


def _grad_means(parts, norm_type, valid_k, H):
    """(mean(dy*gamma), mean(dy*gamma*hat)) from their partial sums."""
    if norm_type == "gLN":
        s = parts.sum(1) / (float(valid_k) * H)
        return s[:, None, None, 0], s[:, None, None, 1]
    s = parts.sum(2) / float(H)
    return s[..., 0, None], s[..., 1, None]


def _pair_sums(a, b, norm_type):
    """Partials of (sum a, sum b): gLN [M, 1, 2], cLN [M, K_pad, 1, 2]."""
    if norm_type == "gLN":
        return torch.stack([a.sum((1, 2)), b.sum((1, 2))], -1)[:, None, :]
    return torch.stack([a.sum(-1), b.sum(-1)], -1)[:, :, None, :]


def _n_parts(stats, gln: bool) -> int:
    return stats.shape[1] if gln else stats.shape[2]


def _check_stats(stats, M, Kp, gln, what):
    _require(stats.dtype == torch.float32 and stats.is_contiguous(),
             f"{what} must be contiguous float32")
    _require(stats.shape[0] == M and (gln or stats.shape[1] == Kp),
             f"{what} does not match the activations")


def _check_params(*ts):
    for t in ts:
        _require(t.dtype == torch.float32 and t.is_contiguous(),
                 "parameters must be contiguous float32")


def _part_out(out, shape, device, what):
    """The f32 partials buffer a kernel writes: `out` (a slot of
    FinishSlots) checked against `shape`, else a new one."""
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    _require(tuple(out.shape) == tuple(shape) and out.dtype == torch.float32
             and out.is_contiguous(), f"{what} slot must be contiguous float32 {tuple(shape)}")
    return out


def _into(out, val):
    """A plain version's partials, copied into `out` when one is given."""
    if out is None:
        return val
    _require(out.shape == val.shape, f"a slot of {tuple(out.shape)} for partials of "
             f"{tuple(val.shape)}")
    return out.copy_(val)


def _dz_tile(rows: int, B: int, H: int, dt, index, Sc: int = 0) -> Tuple[int, int]:
    """KB1's (rows, columns) per CTA (skip mode: a depth of B + Sc)."""
    if dt == torch.bfloat16:
        return gemm_plan(rows, H, B + Sc, _sm_count(index),
                         resident=_resident(index, H_DZ | (H_SKIP if Sc else 0)))
    return BM, BN


def _dx_tile(rows: int, B: int, H: int, dt, index) -> Tuple[int, int]:
    """KB3's (rows, columns) per CTA: bf16 covers every column."""
    if dt == torch.bfloat16:
        return gemm_plan(rows, B, H, _sm_count(index), split=False,
                         resident=_resident(index, H_DX))
    return BM, BN


# The counters of `counts()` in the launch ledger (utils/ledger.py): every
# backward kernel of csrc/ and its skip modes.
COUNTERS = ("tcn_bwd_dz", "tcn_wgrad_out", "tcn_bwd_dwconv", "tcn_bwd_dx", "tcn_wgrad_in",
            "tcn_bwd_finish", "tcn_bwd_dz_skip", "tcn_wgrad_out_skip", "tcn_bwd_finish_skip")


def counts() -> dict:
    return ledger.read(COUNTERS)


def reset_counts() -> None:
    ledger.reset(COUNTERS)


# ---------------------------------------------------------------------------
# KB1: dz and the norm2-backward partials
# ---------------------------------------------------------------------------

def _skip_cat(g, gs):
    """[g | gs] along the channels (the skip modes' operand), or g."""
    return g if gs is None else torch.cat([g, gs.to(g.dtype)], dim=-1)


def bwd_dz_plain(g, out_wt, c, stats2, alpha2, g2, norm_type, valid_k, colpart=None, gs=None):
    """Plain version of KB1. g [M, K_pad, B], out_wt = out_w^T [B, H]
    (activation dtype), c [M, K_pad, H]. Returns (dz, colpart [1, 2, H]
    = (sum dz*ehat, sum dz), norm2-backward partials); colpart is written
    into `colpart` when given. With gs [M, K_pad, Sc] (skip mode), out_wt
    is [out_w | skip_w]^T [B + Sc, H] and dz = [g | gs] @ out_wt."""
    M, Kp, _ = g.shape
    H = out_wt.shape[1]
    dt = g.dtype
    rows = _rows(Kp, valid_k, g.device)
    gm = torch.where(rows, _skip_cat(g, gs), torch.zeros((), dtype=dt, device=g.device))
    dz = torch.matmul(gm.float(), out_wt.float()).to(dt)
    mean, inv = _norm_terms(stats2, norm_type, valid_k, H)
    cf = torch.where(rows, c.float(), 0.0)
    ehat = (_prelu_f32(cf, alpha2) - mean) * inv
    d = dz.float()
    cp = torch.stack([(d * ehat).sum((0, 1)), d.sum((0, 1))])[None]
    dzg = d * g2
    return dz, _into(colpart, cp), _pair_sums(dzg, dzg * ehat, norm_type)


def tcn_bwd_dz(g, out_wt, c, stats2, alpha2, g2, norm_type, valid_k, colpart=None, gs=None):
    """KB1. Same signature and results as bwd_dz_plain, with one colpart
    row per row tile (bwd_dz_parts) and norm2-backward partials per row and
    column tile (cLN) or per CTA (gLN). bf16 runs on the TMA + wgmma
    pipeline (mode H_DZ), tiled by tcn_block.gemm_plan with c and dz as the
    epilogue's two tiles; with gs its skip mode (bf16 only) reads the depth
    B + Sc from g, then gs."""
    if g.device.type == "cpu":
        return bwd_dz_plain(g, out_wt, c, stats2, alpha2, g2, norm_type, valid_k, colpart, gs)
    M, Kp, B = g.shape
    H = out_wt.shape[1]
    Sc = 0 if gs is None else gs.shape[2]
    dt = g.dtype
    _check_widths(Kp, B, H, dt)
    _require(0 < valid_k <= Kp, f"valid_k={valid_k} outside (0, {Kp}]")
    _require(out_wt.shape == (B + Sc, H) and c.shape == (M, Kp, H) and g2.shape == (H,),
             "KB1 operand shapes do not match")
    gln = norm_type == "gLN"
    alpha2 = alpha2.reshape(1)
    _check_cuda(g, out_wt, c, dtype=dt)
    _check_cuda(g, stats2, alpha2, g2)
    _check_stats(stats2, M, Kp, gln, "stats2")
    _check_params(alpha2, g2)
    if Sc:
        _require(dt == torch.bfloat16, "KB1's skip mode runs bf16 only")
        _require(Sc % KERNEL_WIDTH == 0 and gs.shape == (M, Kp, Sc),
                 "the skip cotangent does not match g")
        _check_cuda(g, gs, dtype=dt)
    bm, bn = _dz_tile(M * Kp, B, H, dt, g.device.index, Sc)
    nct = H // bn
    dz = torch.empty((M, Kp, H), dtype=dt, device=g.device)
    colpart = _part_out(colpart, (M * Kp // bm, 2, H), g.device, "KB1 colpart")
    npart = torch.empty((M, Kp // bm * nct, 2) if gln else (M, Kp, nct, 2),
                        dtype=torch.float32, device=g.device)
    rc = _lib().tcn_bwd_dz(g.device.index, _DTYPES[dt], g.data_ptr(), out_wt.data_ptr(),
                           c.data_ptr(), stats2.data_ptr(), _n_parts(stats2, gln),
                           alpha2.data_ptr(), g2.data_ptr(), dz.data_ptr(),
                           colpart.data_ptr(), npart.data_ptr(), _ptr(gs), M * Kp, Kp,
                           valid_k, B, Sc, H, int(gln), bm, bn, _stream(g))
    _build.check(rc, "tcn_bwd_dz")
    ledger.count("tcn_bwd_dz_skip" if Sc else "tcn_bwd_dz")
    return dz, colpart, npart


# ---------------------------------------------------------------------------
# KW: weight gradients A^T @ Bm, split over row chunks
# ---------------------------------------------------------------------------

def wgrad_chunk(Kp: int) -> int:
    """Rows per split of the f32 kernel: 128 * q for the largest q <= 8
    dividing K_pad / 128, so a chunk lies in one batch item."""
    n = Kp // 128
    return 128 * max(q for q in range(1, 9) if n % q == 0)


WGRAD_SLICE = 64            # rows per pipeline stage of the bf16 kernel
WGRAD_MIN_SLICES = 4        # slices per split at least, so small inputs split less
WGRAD_CLUSTERS = (1, 2, 4, 8)
# A partial costs about a quarter of a slice: 0.5 MB of f32 written and
# summed back at the paper widths (H100 runs of tools/time_gemm.py).
WGRAD_PART_COST = 0.25


class WgradPlan(NamedTuple):
    """Launch plan of bf16 KW: `splits` contiguous ranges of 64-row slices
    per output tile, summed inside clusters of `cluster` CTAs, so the
    kernel returns `parts` = splits / cluster partials; `tiles` output tiles
    of 128 M-side by `bn` N-side columns."""
    splits: int
    cluster: int
    bn: int
    tiles: int
    parts: int


def wgrad_bn(n_cols: int, seam: int = 0) -> int:
    """N-side columns per CTA of bf16 KW: 256 where they tile n_cols and a
    tile starts at `seam` (the skip mode's B, where g's columns end and
    g_s's begin), else 128."""
    return 256 if n_cols % 256 == 0 and seam % 256 == 0 else 128


@functools.lru_cache(maxsize=256)
def wgrad_plan(rows: int, kpad: int, m_cols: int, n_cols: int, sms: int,
               max_clusters: Optional[Tuple[Tuple[int, int], ...]] = None,
               seam: int = 0) -> WgradPlan:
    """Plan of the bf16 KW kernel for a [rows, m_cols]^T @ [rows, n_cols]
    product (m_cols: wgmma's M side, c in the z form and dy1 in the din
    form) on a card with `sms` SMs, one CTA per SM.

    For each cluster size the splits are as many as one wave holds
    (sms // tiles, and no more clusters than are resident at once:
    `max_clusters`, ((size, clusters), ...) from the card, None: sms //
    size), but at least WGRAD_MIN_SLICES slices each, rounded down to a
    multiple of the size. The plan takes the size of least cost, the longest
    split in slices plus WGRAD_PART_COST per partial, then the larger
    cluster. At the paper widths (4 tiles) on an H100 (clusters of 2, 4, 8:
    66, 30, 15 resident): batch 8 and 5 take 28 splits in clusters of 4 (7
    partials), batch 1 12 splits in clusters of 4 (3 partials); a card of
    one SM one split. `seam`: see wgrad_bn."""
    _require(kpad > 0 and kpad % WGRAD_SLICE == 0,
             f"K_pad={kpad} is not a multiple of {WGRAD_SLICE}")
    _require(rows > 0 and rows % kpad == 0, f"{rows} rows are not whole items of {kpad}")
    _require(m_cols > 0 and n_cols > 0 and m_cols % 128 == 0 and n_cols % 128 == 0,
             f"KW widths {m_cols}, {n_cols} are not multiples of 128")
    _require(sms > 0, "no SMs")
    bn = wgrad_bn(n_cols, seam)
    tiles = (m_cols // 128) * (n_cols // bn)
    slices = rows // WGRAD_SLICE
    top = max(1, min(sms // tiles, slices // WGRAD_MIN_SLICES))
    limit = dict(max_clusters or ())
    best = None
    for cs in WGRAD_CLUSTERS:
        # all tiles x splits / cs clusters resident at once
        cap = top if cs == 1 else min(top, limit.get(cs, sms // cs) * cs // tiles)
        splits = cap // cs * cs
        if splits < cs:
            continue
        key = (-(-slices // splits) + WGRAD_PART_COST * (splits // cs), -cs)
        if best is None or key < best[0]:
            best = (key, splits, cs)
    _, splits, cs = best
    return WgradPlan(splits, cs, bn, tiles, splits // cs)


def wgrad_split_rows(rows: int, splits: int):
    """The [first, last) rows of each split, as the kernel cuts them: split
    s takes slices [s * T // splits, (s + 1) * T // splits) of the T =
    rows / 64 slices."""
    t = rows // WGRAD_SLICE
    return [(s * t // splits * WGRAD_SLICE, (s + 1) * t // splits * WGRAD_SLICE)
            for s in range(splits)]


def _check_wgrad_plan(splits: int, cluster: int, rows: int) -> None:
    _require(cluster in WGRAD_CLUSTERS and splits % cluster == 0
             and 0 < splits <= rows // WGRAD_SLICE,
             f"KW plan of {splits} splits in clusters of {cluster} does not tile {rows} rows")


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, bn: int) -> Tuple[Tuple[int, int], ...]:
    """((cluster size, clusters resident at once), ...) of bf16 KW with
    `bn` N-side columns per CTA on the card."""
    return tuple((cs, _lib().tcn_wgrad_max_clusters(index, bn, cs))
                 for cs in WGRAD_CLUSTERS[1:])


@functools.lru_cache(maxsize=256)
def _card_plan(index: int, rows: int, kpad: int, m_cols: int, n_cols: int,
               sms: int, seam: int = 0) -> WgradPlan:
    return wgrad_plan(rows, kpad, m_cols, n_cols, sms,
                      _max_clusters(index, wgrad_bn(n_cols, seam)), seam)


def wgrad_launch_plan(A, Bm, z=None, gs=None) -> WgradPlan:
    """The plan `tcn_wgrad` takes for these bf16 CUDA operands (cached per
    shape and card: the wrapper's host time is on the train step's path);
    gs: the skip mode's second N-side operand."""
    M, Kp, n1 = A.shape
    n2 = Bm.shape[2]
    mc, nc = (n1, n2) if z is not None else (n2, n1)
    Sc = 0 if gs is None else gs.shape[2]
    idx = A.device.index
    return _card_plan(idx, M * Kp, Kp, mc, nc + Sc, _sm_count(idx), n2 if Sc else 0)


def wgrad_plain(A, Bm, valid_k, z=None, part=None, gs=None):
    """Plain version of KW: [1, n1, n2] = A^T @ Bm over the rows < valid_k
    of each item (Bm's other rows are read as zero, whatever they hold),
    written into `part` when given. z = (stats2, alpha2, g2, b2,
    norm_type) makes the A operand round(g2 * ehat + b2) with ehat from
    A = c (dout_w). gs (skip mode, z form): Bm is [Bm | gs], n2 + Sc
    columns."""
    M, Kp, n1 = A.shape
    dt = A.dtype
    Bm = _skip_cat(Bm, gs)
    rows = _rows(Kp, valid_k, A.device)
    Bm = torch.where(rows, Bm, torch.zeros((), dtype=Bm.dtype, device=Bm.device))
    if z is not None:
        stats2, alpha2, g2, b2, norm_type = z
        mean, inv = _norm_terms(stats2, norm_type, valid_k, n1)
        cf = torch.where(rows, A.float(), 0.0)
        A = (g2 * ((_prelu_f32(cf, alpha2) - mean) * inv) + b2).to(dt)
    return _into(part, torch.matmul(A.float().reshape(-1, n1).t(),
                                    Bm.float().reshape(M * Kp, -1))[None])


def tcn_wgrad(A, Bm, valid_k, z=None, plan=None, part=None, gs=None):
    """KW. Returns f32 partials [n_part, n1, n2] (written into `part` when
    given); their sum over axis 0 is the weight gradient. bf16 takes
    `plan`, a WgradPlan or (splits, cluster) (default `wgrad_launch_plan`),
    and returns splits / cluster partials; f32 one per `wgrad_chunk` rows.
    gs [M, K_pad, Sc] (z form, bf16 only): the skip mode, N side [Bm | gs],
    partials [n_part, n1, n2 + Sc]."""
    if A.device.type == "cpu":
        return wgrad_plain(A, Bm, valid_k, z, part, gs)
    M, Kp, n1 = A.shape
    n2 = Bm.shape[2]
    Sc = 0 if gs is None else gs.shape[2]
    dt = A.dtype
    _check_widths(Kp, n1, n2, dt)
    _require(Bm.shape[:2] == (M, Kp), "KW operands must have the same rows")
    _require(0 < valid_k <= Kp, f"valid_k={valid_k} outside (0, {Kp}]")
    if plan is not None:
        _check_wgrad_plan(*plan[:2], M * Kp)
    _check_cuda(A, Bm, dtype=dt)
    if Sc:
        _require(z is not None and dt == torch.bfloat16, "KW's skip mode is the bf16 z form")
        _require(Sc % KERNEL_WIDTH == 0 and gs.shape == (M, Kp, Sc),
                 "the skip cotangent does not match Bm")
        _check_cuda(A, gs, dtype=dt)
    if dt == torch.bfloat16:
        splits, cluster = (plan or wgrad_launch_plan(A, Bm, z, gs))[:2]
        n_part = splits // cluster
    else:
        splits, cluster = wgrad_chunk(Kp), 1
        n_part = M * Kp // splits
    part = _part_out(part, (n_part, n1, n2 + Sc), A.device, "KW")
    stats2 = alpha2 = g2 = b2 = None
    gln, n2s = 0, 0
    if z is not None:
        stats2, alpha2, g2, b2, norm_type = z
        gln = int(norm_type == "gLN")
        alpha2 = alpha2.reshape(1)
        _check_cuda(A, stats2, alpha2, g2, b2)
        _check_stats(stats2, M, Kp, gln, "stats2")
        _check_params(alpha2, g2, b2)
        _require(g2.shape == (n1,) and b2.shape == (n1,), "norm2 vectors do not match")
        n2s = _n_parts(stats2, gln)
    rc = _lib().tcn_wgrad(A.device.index, _DTYPES[dt], int(z is not None), A.data_ptr(),
                          Bm.data_ptr(), _ptr(gs), part.data_ptr(), _ptr(stats2), n2s,
                          _ptr(alpha2), _ptr(g2), _ptr(b2), M * Kp, Kp, valid_k, n1, n2, Sc,
                          splits, cluster, gln, _stream(A))
    _build.check(rc, "tcn_wgrad")
    ledger.count("tcn_wgrad_out_skip" if Sc else
                 "tcn_wgrad_out" if z is not None else "tcn_wgrad_in")
    return part


# ---------------------------------------------------------------------------
# KB2: norm2 / PReLU2 backward and the depthwise transpose
# ---------------------------------------------------------------------------

def bwd_dwconv_plain(y1, c, dz, stats1, stats2, gs2, alpha1, g1, b1, w, alpha2,
                     g2, norm_type, dilation, causal, valid_k, chpart=None, da2part=None):
    """Plain version of KB2. Returns (db [M, K_pad, H], channel partials
    [1, P + 2, H] = (dw[0..P), dg1, db1), norm1-backward partials,
    d_alpha2 partials [1]); the channel and d_alpha2 partials are written
    into `chpart` and `da2part` when given."""
    M, Kp, H = y1.shape
    P = w.shape[0]
    dt = y1.dtype
    span = (P - 1) * dilation
    left = span if causal else span // 2
    rows = _rows(Kp, valid_k, y1.device)
    m1, i1 = _norm_terms(stats1, norm_type, valid_k, H)
    m2, i2 = _norm_terms(stats2, norm_type, valid_k, H)
    sa, sb = _grad_means(gs2, norm_type, valid_k, H)
    cf = torch.where(rows, c.float(), 0.0)
    ehat = (_prelu_f32(cf, alpha2) - m2) * i2
    de = torch.where(rows, (i2 * (dz.float() * g2 - sa - ehat * sb)).to(dt).float(), 0.0)
    dc = (de * torch.where(cf >= 0, 1.0, alpha2.float())).to(dt).float()
    da2 = (de * torch.clamp(cf, max=0.0)).sum()
    # db[j] = sum_p w[p] * dc[j + left - p*d]
    dcp = F.pad(dc, (0, 0, span - left, left))
    db = None
    for p in range(P):
        tap = w[p] * dcp[:, span - p * dilation: span - p * dilation + Kp]
        db = tap if db is None else db + tap
    db = torch.where(rows, db.to(dt).float(), 0.0)
    # dw[p] = sum_k dc[k] * b[k - left + p*d], b recomputed from y1
    ahat = (_prelu_f32(y1.float(), alpha1) - m1) * i1
    b = torch.where(rows, (g1 * ahat + b1).to(dt).float(), 0.0)
    bp = F.pad(b, (0, 0, left, span - left))
    dw = torch.stack([(dc * bp[:, p * dilation: p * dilation + Kp]).sum((0, 1))
                      for p in range(P)])
    chp = torch.cat([dw, (db * ahat).sum((0, 1))[None], db.sum((0, 1))[None]])[None]
    dbg = db * g1
    return (db.to(dt), _into(chpart, chp), _pair_sums(dbg, dbg * ahat, norm_type),
            _into(da2part, da2.reshape(1)))


def _kb2_plan(P: int, dilation: int, H: int, dt, M: int, Kp: int, index) -> StripPlan:
    return kb2_plan(P, dilation, H, torch.empty((), dtype=dt).element_size(), M, Kp,
                    _sm_count(index))


def tcn_bwd_dwconv(y1, c, dz, stats1, stats2, gs2, alpha1, g1, b1, w, alpha2,
                   g2, norm_type, dilation, causal, valid_k, plan=None, chpart=None,
                   da2part=None):
    """KB2. Same signature and results as bwd_dwconv_plain, with channel
    partials per strip of `kb2_plan` ([M * bands, P + 2, H]), norm1-backward
    partials per strip and channel tile (gLN, [M, bands * H / cols, 2]) or
    per row and consumer warp's quarter of a channel tile (cLN, [M, K_pad,
    KB2_WARPS * H / cols, 2]), and d_alpha2 partials per strip and channel
    tile; a streaming stencil (csrc/tcn_dwconv_sm90.cuh). `plan` forces a
    strip plan (tcn_block.kb2_strip)."""
    if y1.device.type == "cpu":
        return bwd_dwconv_plain(y1, c, dz, stats1, stats2, gs2, alpha1, g1, b1, w,
                                alpha2, g2, norm_type, dilation, causal, valid_k, chpart,
                                da2part)
    M, Kp, H = y1.shape
    P = w.shape[0]
    dt = y1.dtype
    _check_widths(Kp, BN, H, dt)
    _require(0 < valid_k <= Kp, f"valid_k={valid_k} outside (0, {Kp}]")
    _require(P <= BWD_MAXP, f"P={P} exceeds the kernel's {BWD_MAXP} taps")
    _require((P - 1) * dilation <= BWD_MAX_SPAN,
             f"conv span {(P - 1) * dilation} exceeds the kernel's halo limit")
    _require(c.shape == y1.shape and dz.shape == y1.shape and w.shape == (P, H)
             and g1.shape == (H,) and b1.shape == (H,) and g2.shape == (H,),
             "KB2 operand shapes do not match")
    gln = norm_type == "gLN"
    alpha1, alpha2 = alpha1.reshape(1), alpha2.reshape(1)
    _check_cuda(y1, c, dz, dtype=dt)
    _check_cuda(y1, stats1, stats2, gs2, alpha1, g1, b1, w, alpha2, g2)
    for s, what in ((stats1, "stats1"), (stats2, "stats2"), (gs2, "KB1 partials")):
        _check_stats(s, M, Kp, gln, what)
    _check_params(alpha1, g1, b1, w, alpha2, g2)
    plan = plan or _kb2_plan(P, dilation, H, dt, M, Kp, y1.device.index)
    _require(H % plan.cols == 0 and plan.smem <= SMEM_LIMIT and plan.bands * plan.strip >= Kp
             and plan.grid == M * plan.bands * (H // plan.cols),
             f"KB2 strip plan {tuple(plan)} does not fit H={H}, M={M}, K_pad={Kp}")
    nct = H // plan.cols
    db = torch.empty_like(y1)
    chpart = _part_out(chpart, (M * plan.bands, P + 2, H), y1.device, "KB2 chpart")
    gs1 = torch.empty((M, plan.bands * nct, 2) if gln else (M, Kp, nct * KB2_WARPS, 2),
                      dtype=torch.float32, device=y1.device)
    da2part = _part_out(da2part, (plan.grid,), y1.device, "KB2 da2part")
    rc = _lib().tcn_bwd_dwconv(
        y1.device.index, _DTYPES[dt], y1.data_ptr(), c.data_ptr(), dz.data_ptr(),
        stats1.data_ptr(), _n_parts(stats1, gln), stats2.data_ptr(), _n_parts(stats2, gln),
        gs2.data_ptr(), _n_parts(gs2, gln), alpha1.data_ptr(), g1.data_ptr(),
        b1.data_ptr(), w.data_ptr(), alpha2.data_ptr(), g2.data_ptr(), db.data_ptr(),
        chpart.data_ptr(), gs1.data_ptr(), da2part.data_ptr(), M, Kp, valid_k, H, P,
        dilation, int(causal), int(gln), plan.chunk, plan.stages, plan.ring, plan.strip,
        plan.bands, plan.smem, _stream(y1))
    _build.check(rc, "tcn_bwd_dwconv")
    ledger.count("tcn_bwd_dwconv")
    return db, chpart, gs1, da2part


# ---------------------------------------------------------------------------
# KB3: norm1 / PReLU1 backward and dx
# ---------------------------------------------------------------------------

def bwd_dx_plain(db, y1, in_wt, g, stats1, gs1, alpha1, g1, norm_type, valid_k,
                 da1part=None):
    """Plain version of KB3. in_wt = in_w^T [H, B] (activation dtype).
    Returns (dx [M, K_pad, B], dy1 [M, K_pad, H], d_alpha1 partials [1],
    written into `da1part` when given)."""
    M, Kp, H = db.shape
    dt = db.dtype
    rows = _rows(Kp, valid_k, db.device)
    m1, i1 = _norm_terms(stats1, norm_type, valid_k, H)
    sa, sb = _grad_means(gs1, norm_type, valid_k, H)
    y = y1.float()
    ahat = (_prelu_f32(y, alpha1) - m1) * i1
    da = torch.where(rows, (i1 * (db.float() * g1 - sa - ahat * sb)).to(dt).float(), 0.0)
    da1 = (da * torch.clamp(y, max=0.0)).sum()
    dy1 = (da * torch.where(y >= 0, 1.0, alpha1.float())).to(dt)
    dx = (torch.matmul(dy1.float(), in_wt.float()).to(dt).float() + g.float()).to(dt)
    dx = torch.where(rows, dx, torch.zeros((), dtype=dt, device=db.device))
    return dx, dy1, _into(da1part, da1.reshape(1))


def tcn_bwd_dx(db, y1, in_wt, g, stats1, gs1, alpha1, g1, norm_type, valid_k, da1part=None):
    """KB3. Same signature and results as bwd_dx_plain, with one d_alpha1
    partial per row tile (bwd_dx_parts)."""
    if db.device.type == "cpu":
        return bwd_dx_plain(db, y1, in_wt, g, stats1, gs1, alpha1, g1, norm_type, valid_k,
                            da1part)
    M, Kp, H = db.shape
    B = in_wt.shape[1]
    dt = db.dtype
    _check_widths(Kp, B, H, dt)
    _require(0 < valid_k <= Kp, f"valid_k={valid_k} outside (0, {Kp}]")
    _require(y1.shape == db.shape and in_wt.shape == (H, B) and g.shape == (M, Kp, B)
             and g1.shape == (H,), "KB3 operand shapes do not match")
    _check_gemm_h(H, dt)
    gln = norm_type == "gLN"
    alpha1 = alpha1.reshape(1)
    _check_cuda(db, y1, in_wt, g, dtype=dt)
    _check_cuda(db, stats1, gs1, alpha1, g1)
    _check_stats(stats1, M, Kp, gln, "stats1")
    _check_stats(gs1, M, Kp, gln, "KB2 partials")
    _check_params(alpha1, g1)
    # bf16: one CTA per row tile covers every column (dy1 formed once).
    bm, bn = _dx_tile(M * Kp, B, H, dt, db.device.index)
    dx = torch.empty((M, Kp, B), dtype=dt, device=db.device)
    dy1 = torch.empty_like(db)
    da1part = _part_out(da1part, (M * Kp // bm,), db.device, "KB3 da1part")
    rc = _lib().tcn_bwd_dx(db.device.index, _DTYPES[dt], db.data_ptr(), y1.data_ptr(),
                           in_wt.data_ptr(), g.data_ptr(), stats1.data_ptr(),
                           _n_parts(stats1, gln), gs1.data_ptr(), _n_parts(gs1, gln),
                           alpha1.data_ptr(), g1.data_ptr(), dx.data_ptr(), dy1.data_ptr(),
                           da1part.data_ptr(), M * Kp, Kp, valid_k, B, H, int(gln), bm, bn,
                           _stream(db))
    _build.check(rc, "tcn_bwd_dx")
    ledger.count("tcn_bwd_dx")
    return dx, dy1, da1part


# ---------------------------------------------------------------------------
# KF: the weight gradients of a group of blocks from their partials
# ---------------------------------------------------------------------------

# The stacked gradients in the JAX VJP's order (after dx).
GRAD_ORDER = ("din_w", "da1", "dg1", "db1", "dw", "da2", "dg2", "db2", "dout_w")

FIN_KINDS = 9       # csrc/tcn_bwd_finish.cuh: the gradients of a block
FIN_MAX_GROUP = 64  # csrc/tcn_bwd_finish.cuh: slots one launch takes
# The bytes a group's slots may hold. KF reads them in one launch bound by
# those bytes, so a group is as large as the cap allows: 512 MB is ten
# times the H100's 50 MB L2, so the launch's ramp and tail are a few per
# cent of its ~150 us at 3.35 TB/s, and the slots, which live through the
# backward of the group, stay under 1 % of the card's 80 GB. At the paper
# config (batch 5 x 4 s, bf16, ~9 MB a block) one group holds all 32
# blocks: one launch per step.
FINISH_SLOTS_CAP = 512 << 20


class PartCounts(NamedTuple):
    """The f32 partials one block's backward writes: KW z (nz) and din
    (nin) [n, H, B] / [n, B, H], KB2's channel rows (nch, [n, P + 2, H],
    one per strip) and d_alpha2 (nda2, one per strip and channel tile), KB1's colpart (ncol, [n, 2, H]) and KB3's
    d_alpha1 (nda1). The plain versions write one of each."""
    nz: int
    nin: int
    nch: int
    ncol: int
    nda1: int
    nda2: int


def part_counts(M: int, Kp: int, B: int, H: int, P: int, dilation: int, dt,
                plain: bool, index=None, Sc: int = 0) -> PartCounts:
    """The partials the kernels (plain: the plain versions) write for one
    block of M items of K_pad rows at `dilation`, by the wrappers' plans
    (Sc: the skip modes of KB1 and KW z)."""
    if plain:
        return PartCounts(1, 1, 1, 1, 1, 1)
    rows = M * Kp
    if dt == torch.bfloat16:
        nz = _card_plan(index, rows, Kp, H, B + Sc, _sm_count(index), B if Sc else 0).parts
        nin = _card_plan(index, rows, Kp, H, B, _sm_count(index)).parts
    else:
        nz = nin = rows // wgrad_chunk(Kp)
    plan = _kb2_plan(P, dilation, H, dt, M, Kp, index)
    return PartCounts(nz, nin, M * plan.bands, rows // _dz_tile(rows, B, H, dt, index, Sc)[0],
                      rows // _dx_tile(rows, B, H, dt, index)[0], plan.grid)


def slot_bytes(n: PartCounts, B: int, H: int, P: int, Sc: int = 0) -> int:
    """Bytes of one slot of FinishSlots holding `n` partials."""
    return 4 * (n.nz * H * (B + Sc) + n.nin * H * B + n.nch * (P + 2) * H + n.ncol * 2 * H
                + n.nda1 + n.nda2)


def finish_group(NB: int, nbytes: int) -> int:
    """Blocks per KF launch: the most whose slots of `nbytes` fit under
    FINISH_SLOTS_CAP, at most NB and FIN_MAX_GROUP."""
    return max(1, min(NB, FIN_MAX_GROUP, FINISH_SLOTS_CAP // max(1, nbytes)))


class FinishSlots(NamedTuple):
    """The f32 partials of a group of G blocks' backwards, slot j one
    block's, each buffer [G, most partials of any block of the chain, ...]:
    wz [G, nz, H, B (+ Sc with a skip path)], win [G, nin, B, H], chpart
    [G, nch, P + 2, H], colpart [G, ncol, 2, H], da1part [G, nda1], da2part
    [G, nda2]."""
    wz: torch.Tensor
    win: torch.Tensor
    chpart: torch.Tensor
    colpart: torch.Tensor
    da1part: torch.Tensor
    da2part: torch.Tensor

    @staticmethod
    def alloc(G: int, cap: PartCounts, B: int, H: int, P: int, device,
              Sc: int = 0) -> "FinishSlots":
        def buf(*shape):
            return torch.empty((G,) + shape, dtype=torch.float32, device=device)
        return FinishSlots(buf(cap.nz, H, B + Sc), buf(cap.nin, B, H), buf(cap.nch, P + 2, H),
                           buf(cap.ncol, 2, H), buf(cap.nda1), buf(cap.nda2))

    def slot(self, j: int, n: PartCounts) -> tuple:
        """The buffers block j of the group writes, for `n` partials:
        (wz, win, chpart, colpart, da1part, da2part)."""
        return (self.wz[j, :n.nz], self.win[j, :n.nin], self.chpart[j, :n.nch],
                self.colpart[j, :n.ncol], self.da1part[j, :n.nda1], self.da2part[j, :n.nda2])


def bwd_finish_plain(slots: FinishSlots, counts, grads, nb0: int) -> None:
    """Plain version of KF: rows nb0 ... nb0 + len(counts) - 1 of the nine
    stacked f32 gradients `grads` (GRAD_ORDER), row nb0 + j from slot j of
    `slots` holding counts[j] partials (PartCounts), each summed over its
    first axis."""
    din_w, da1, dg1, db1, dw, da2, dg2, db2, dout_w = grads
    P = dw.shape[1]
    for j, n in enumerate(counts):
        wz, win, chpart, colpart, da1part, da2part = slots.slot(j, n)
        chs = chpart.sum(0)
        cols = colpart.sum(0)
        nb = nb0 + j
        for dst, val in ((din_w, win.sum(0)), (da1, da1part.sum()), (dg1, chs[P]),
                         (db1, chs[P + 1]), (dw, chs[:P]), (da2, da2part.sum()),
                         (dg2, cols[0]), (db2, cols[1]), (dout_w, wz.sum(0))):
            dst[nb] = val


class _FinKind(ctypes.Structure):
    """csrc/tcn_bwd_finish.cuh FinKind."""
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("slot", ctypes.c_longlong), ("row", ctypes.c_longlong),
                ("stride", ctypes.c_int), ("cols", ctypes.c_int), ("cap", ctypes.c_int),
                ("vec", ctypes.c_int), ("lanes_log2", ctypes.c_int), ("cw_log2", ctypes.c_int),
                ("units", ctypes.c_int), ("first", ctypes.c_int),
                ("parts", ctypes.c_int * FIN_MAX_GROUP)]


class _FinGroup(ctypes.Structure):
    """csrc/tcn_bwd_finish.cuh FinGroup."""
    _fields_ = [("kind", _FinKind * FIN_KINDS), ("n", ctypes.c_int), ("units", ctypes.c_int)]


# KF's launch arguments by (pointers, shapes, counts): built once per step
# shape and buffers, so that a step's host time is one lookup per group.
_FIN_ARGS: dict = {}
_FIN_ARGS_MAX = 256


def _fin_args(slots: FinishSlots, counts, grads, nb0: int) -> _FinGroup:
    key = (tuple((t.data_ptr(), t.shape) for t in slots),
           tuple((t.data_ptr(), t.shape) for t in grads), nb0, tuple(counts))
    args = _FIN_ARGS.get(key)
    if args is not None:
        return args
    din_w, da1, dg1, db1, dw, da2, dg2, db2, dout_w = grads
    B, H = din_w.shape[1:]
    Bz = dout_w.shape[2]  # B, or B + Sc with a skip path
    P = dw.shape[1]
    G, ncap = slots.chpart.shape[:2]
    ch, kinds = (P + 2) * H, []

    def kind(src, off, slot, stride, cols, cap, dst, row, field):
        kinds.append((src.data_ptr() + 4 * off, dst.data_ptr() + 4 * nb0 * row, slot, row,
                      stride, cols, cap, [getattr(n, field) for n in counts]))

    # Tall kinds first: their units take longest.
    kind(slots.chpart, 0, ncap * ch, ch, P * H, ncap, dw, P * H, "nch")
    kind(slots.chpart, P * H, ncap * ch, ch, H, ncap, dg1, H, "nch")
    kind(slots.chpart, (P + 1) * H, ncap * ch, ch, H, ncap, db1, H, "nch")
    ncol = slots.colpart.shape[1]
    kind(slots.colpart, 0, ncol * 2 * H, 2 * H, H, ncol, dg2, H, "ncol")
    kind(slots.colpart, H, ncol * 2 * H, 2 * H, H, ncol, db2, H, "ncol")
    kind(slots.da1part, 0, slots.da1part.shape[1], 1, 1, slots.da1part.shape[1], da1, 1, "nda1")
    kind(slots.da2part, 0, slots.da2part.shape[1], 1, 1, slots.da2part.shape[1], da2, 1, "nda2")
    nin, nz = slots.win.shape[1], slots.wz.shape[1]
    kind(slots.win, 0, nin * B * H, B * H, B * H, nin, din_w, B * H, "nin")
    kind(slots.wz, 0, nz * H * Bz, H * Bz, H * Bz, nz, dout_w, H * Bz, "nz")
    args = _FinGroup()
    args.n = len(counts)
    for k, (src, dst, slot, row, stride, cols, cap, parts) in zip(args.kind, kinds):
        k.src, k.dst, k.slot, k.row, k.stride, k.cols, k.cap = (src, dst, slot, row, stride,
                                                                cols, cap)
        k.parts[:len(parts)] = parts
    if len(_FIN_ARGS) >= _FIN_ARGS_MAX:
        _FIN_ARGS.clear()
    _FIN_ARGS[key] = args
    return args


def tcn_bwd_finish(slots: FinishSlots, counts, grads, nb0: int) -> None:
    """KF. Same arguments and result as bwd_finish_plain, one launch for
    the whole group (at most FIN_MAX_GROUP slots). A skip path's dout_w is
    d[out_w | skip_w], [NB, H, B + Sc]: KF's skip kernel."""
    if slots.wz.device.type == "cpu":
        return bwd_finish_plain(slots, counts, grads, nb0)
    din_w, da1, dg1, db1, dw, da2, dg2, db2, dout_w = grads
    NB, B, H = din_w.shape
    Bz = dout_w.shape[2]
    P = dw.shape[1]
    n = len(counts)
    G = slots.wz.shape[0]
    _require(0 < n <= min(G, FIN_MAX_GROUP) and 0 <= nb0 and nb0 + n <= NB,
             f"rows {nb0}..{nb0 + n - 1} of {NB} from {G} slots")
    _require(slots.wz.shape[2:] == (H, Bz) and slots.win.shape[2:] == (B, H)
             and slots.chpart.shape[2:] == (P + 2, H) and slots.colpart.shape[2:] == (2, H)
             and all(t.shape[0] == G for t in slots),
             "KF slot shapes do not match the gradients")
    _require(dout_w.shape == (NB, H, Bz) and Bz >= B and dw.shape == (NB, P, H)
             and all(t.shape == (NB, H) for t in (dg1, db1, dg2, db2))
             and da1.numel() == NB and da2.numel() == NB,
             "the stacked gradients' shapes do not match")
    cap = (slots.wz.shape[1], slots.win.shape[1], slots.chpart.shape[1], slots.colpart.shape[1],
           slots.da1part.shape[1], slots.da2part.shape[1])
    _require(all(0 < c <= m for cn in counts for c, m in zip(cn, cap)),
             "a slot's partial counts exceed the slots")
    _check_cuda(*slots, *grads, dtype=torch.float32)
    skip = Bz != B
    rc = _lib().tcn_bwd_finish(din_w.device.index,
                               ctypes.byref(_fin_args(slots, counts, grads, nb0)), int(skip),
                               _stream(din_w))
    _build.check(rc, "tcn_bwd_finish")
    ledger.count("tcn_bwd_finish_skip" if skip else "tcn_bwd_finish")


# ---------------------------------------------------------------------------
# One block's backward
# ---------------------------------------------------------------------------

PLAIN_BWD = (bwd_dz_plain, wgrad_plain, bwd_dwconv_plain, bwd_dx_plain, bwd_finish_plain)
KERNEL_BWD = (tcn_bwd_dz, tcn_wgrad, tcn_bwd_dwconv, tcn_bwd_dx, tcn_bwd_finish)


def alloc_grads(params) -> list:
    """The nine stacked f32 gradients [NB, ...] of the stacked block
    parameters (in_w, a1, g1, b1, w, a2, g2, b2, out_w; with a skip path
    [out_w | skip_w] last), each row written by the KF launch of its
    block's group."""
    return [torch.empty(p.shape, dtype=torch.float32, device=p.device) for p in params]


def block_partials(g, x, y1, s1, c, s2, in_wt, a1, g1, b1, w, a2, g2, b2, out_wt,
                   norm_type, dilation, causal, valid_k, slot, stages=KERNEL_BWD,
                   gs=None) -> torch.Tensor:
    """The five producing kernels of a block's backward. g, x [M, K_pad, B]
    and y1, c [M, K_pad, H] in the activation dtype; in_wt = in_w^T [H, B]
    and out_wt = out_w^T [B, H] in the activation dtype; the rest f32.
    With a skip path, gs [M, K_pad, Sc] is the skip sum's cotangent and
    out_wt = [out_w | skip_w]^T [B + Sc, H]. Writes the block's
    weight-gradient partials into `slot` (FinishSlots.slot) and returns dx,
    rows >= valid_k zero."""
    dz_fn, wgrad_fn, dw_fn, dx_fn, _ = stages
    wz, win, chpart, colpart, da1p, da2p = slot
    skip = {} if gs is None else {"gs": gs}
    dz, _, gs2 = dz_fn(g, out_wt, c, s2, a2, g2, norm_type, valid_k, colpart=colpart, **skip)
    wgrad_fn(c, g, valid_k, (s2, a2, g2, b2, norm_type), part=wz, **skip)
    db, _, gs1, _ = dw_fn(y1, c, dz, s1, s2, gs2, a1, g1, b1, w, a2, g2, norm_type, dilation,
                          causal, valid_k, chpart=chpart, da2part=da2p)
    dx, dy1, _ = dx_fn(db, y1, in_wt, g, s1, gs1, a1, g1, norm_type, valid_k, da1part=da1p)
    wgrad_fn(x, dy1, valid_k, part=win)
    return dx


def block_bwd(g, x, y1, s1, c, s2, in_wt, a1, g1, b1, w, a2, g2, b2, out_wt,
              norm_type, dilation, causal, valid_k, grads, nb, stages=KERNEL_BWD
              ) -> torch.Tensor:
    """Backward of block nb, finished: block_partials into a group of one
    slot, then KF writes the weight gradients (GRAD_ORDER, f32) into row nb
    of the stacked `grads`. Returns dx, rows >= valid_k zero."""
    M, Kp, B = g.shape
    H, P = y1.shape[2], w.shape[0]
    n = part_counts(M, Kp, B, H, P, dilation, g.dtype,
                    stages is PLAIN_BWD or g.device.type == "cpu", g.device.index)
    slots = FinishSlots.alloc(1, n, B, H, P, g.device)
    dx = block_partials(g, x, y1, s1, c, s2, in_wt, a1, g1, b1, w, a2, g2, b2, out_wt,
                        norm_type, dilation, causal, valid_k, slots.slot(0, n), stages)
    stages[-1](slots, [n], grads, nb)
    return dx
