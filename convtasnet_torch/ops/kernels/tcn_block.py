"""Wrappers of the three TCN-block kernels (csrc/tcn_block.cu) and their
plain PyTorch versions.

One temporal block runs as
  K1 tcn_in_gemm:  y1 = round(x @ in_w), partial sums of a = PReLU(y1); in
                   bf16 on the TMA + wgmma pipeline, tiled by `gemm_plan`;
  K2 tcn_dwconv:   e = round(PReLU(dwconv(round(norm1(a))))), partial sums
                   of e over the rows < K; with save=True (training) also
                   c = round(dwconv(...)), the conv output before PReLU2,
                   pad rows not masked; a staged stencil
                   (csrc/tcn_dwconv_sm90.cuh), tiled by `dw_plan`;
  K3 tcn_out_gemm: x' = round(x + round(norm2(e) @ out_w)), in place when
                   the caller passes out=x, with
                   norm2 folded into the product (fold=True, the whole-TCN
                   form) or applied to the A operand (fold=False, the
                   whole-block form); rows >= K stay exactly zero. In bf16
                   it runs on the TMA + wgmma pipeline
                   (csrc/tcn_gemm_sm90.cuh), tiled by `gemm_plan`.
The fold's weight terms come from KFW tcn_fold_weights
(csrc/tcn_fold_weights.cuh), once per forward for all blocks.

A block with a skip path (the paper's final version, Sc skip channels)
runs K3 and KFW in their skip modes: K3's product is e @ [out_w | skip_w]
over B + Sc columns, the column tiles < B added into x as above and those
>= B into the skip sum s [M, K_pad, Sc] in place, s' = round(s +
round(norm2(e) @ skip_w)), so e is read once for both; KFW folds norm2
into all B + Sc columns. The skip modes run bf16 only, and have kernels
and launch counters of their own (`*_skip`).

Tensors are [M, K_pad, ch] with K_pad a multiple of 128 and rows >= K zero.
The norm statistics travel between the kernels as (sum, sum of squares)
partials: gLN [M, n, 2] per item, cLN [M, K_pad, n, 2] per row. The kernels
write one partial per CTA tile; the plain versions write n = 1. The reader
sums whatever n it is given.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Each wrapper counts its launches in the port's launch ledger
(utils/ledger.py) under the names of `COUNTERS`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ...config import EPS
from ...utils import ledger
from . import _build
from .limits import DWCONV_MAX_SPAN, GEMM_MAX_H, KERNEL_WIDTH

# Tile sizes of csrc/tcn_block.cuh (the f32 SIMT GEMM tiles).
BM, BN, BK = 64, 128, 32
ROW_ALIGN = 128  # K_pad multiple (the JAX package pads to 128 the same way)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tcn_in_gemm": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "tcn_dwconv": [_I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "tcn_out_gemm": [_I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                     _I, _I, _I, _I, _I, _I, _P],
    "tcn_gemm_resident": [_I, _I, _I, _I],
    "tcn_fold_weights": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "tcn_fold_weights_skip": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "tcn_fold_resident": [_I, _I],
}


@functools.lru_cache(maxsize=None)
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
    _require(B % KERNEL_WIDTH == 0 and H % KERNEL_WIDTH == 0,
             f"B={B} and H={H} must be multiples of {KERNEL_WIDTH} for the kernels")


# Modes of the bf16 wgmma template (csrc/tcn_gemm_sm90.cuh HMode) and the
# tiles it takes, smallest first.
H_FOLD, H_UNFOLD, H_DX, H_IN, H_DZ = range(5)
H_SKIP = 8  # or-ed into a mode: its skip kernel (K3 fold / unfold, KB1)
GEMM_TILES = ((64, 128), (64, 256), (128, 128), (128, 256))


@functools.lru_cache(maxsize=256)
def gemm_plan(rows: int, ncols: int, kdim: int, sms: int, split: bool = True,
              io_tiles: int = 2, resident: Tuple = (), seam: int = 0) -> Tuple[int, int]:
    """(rows, columns) per CTA of the bf16 wgmma kernels (K1, K3, KB1,
    KB3) for a [rows, kdim] @ [kdim, ncols] product on a card with `sms`
    SMs, where `resident` gives ((tile, CTAs resident per SM), ...) from the
    card's occupancy at the kernel's shared memory (1 where not given).

    A CTA takes 128 or 64 rows and all columns when ncols is 128 or 256 (a
    multiple of 256: 256 of them), so the A stream is read once per column
    tile; with `split`, also 64 x 128. Each tile costs its waves (CTAs over
    the CTAs resident on the card at once, rounded up) times a CTA's bytes
    (the A tile and the epilogue's `io_tiles` [rows, columns] tiles: 2 for
    K3 and KB3, residual and output, and KB1, c and dz; 1 for K1, y1) over
    the consumer warpgroups resident per SM, at most 2: an SM with one
    warpgroup and nothing to overlap its loads and epilogue with ran 1.2-1.4x
    slower than this cost without that term says (H100 runs of
    tools/time_gemm.py). The least cost wins, the smaller tile of equals.
    At the paper widths on an H100: K3 and KB3 take 128 x 256 at batch 8
    and 5; at batch 1 (3,200 rows) K3 takes 64 x 128 and KB3 64 x 256. K1
    takes 64 x 128 at every batch (two CTAs resident per SM); KB1 128 x 256
    at batch 8 and 5, 64 x 256 at batch 1. rows is a multiple of 128 (K_pad
    is). `seam`: a column at which a tile must start (K3's skip mode: B,
    where x's columns end and s's begin), so 256 columns only where it is a
    multiple of 256."""
    _require(ncols % 128 == 0, f"{ncols} output columns are not a multiple of 128")
    _require(rows > 0 and rows % ROW_ALIGN == 0, f"{rows} rows are not a multiple of {ROW_ALIGN}")
    _require(seam % 128 == 0, f"a column seam at {seam} is not a multiple of 128")
    bn = 256 if ncols % 256 == 0 and seam % 256 == 0 else 128
    res = dict(resident)

    def cost(tile):
        bm, bn_ = tile
        r = max(1, res.get(tile, 1))
        waves = -(-(rows // bm * (ncols // bn_)) // (sms * r))
        return waves * bm * (kdim + io_tiles * bn_) / min(2, r * bm // 64)

    return min((t for t in GEMM_TILES if t[1] == bn or (split and t == (64, 128))), key=cost)


def card_resident(lib, index: int, mode: int) -> Tuple:
    """((tile, CTAs resident per SM), ...) of the bf16 wgmma kernel in
    `mode` on card `index`, from `lib` (the library that builds the mode)."""
    return tuple((t, lib.tcn_gemm_resident(index, mode, *t)) for t in GEMM_TILES)


# Tile plan of the depthwise kernel K2 (csrc/tcn_dwconv_sm90.cuh).
DW_THREADS = 256
DW_ROW_TILES = (128, 64, 32, 16)   # rows per CTA; each divides any K_pad
DW_LANES = (32, 16, 8, 4, 2, 1)    # threads per row, one 16-byte vector each
DW_HEAD = 128                      # bytes of mbarriers ahead of the window buffer
DW_MAX_STAGES = 8
DW_BOX = 16                        # rows per TMA box (divides every tile's rows)
SMEM_LIMIT = 232448 - 1024         # a CTA's 227 KB (hop::SMEM_LIMIT) less its static shared memory


class DwPlan(NamedTuple):
    """Tile of K2: `rows` x `cols` channels of one item per CTA, `lanes`
    threads per row; `staged` window slots (`contiguous`: br + span rows in
    order; else P disjoint windows of br rows), loaded as TMA boxes of
    DW_BOX rows in `stages` stages of `chunk` boxes; `smem` bytes of
    dynamic shared memory (the barriers and the window buffer)."""
    rows: int
    cols: int
    lanes: int
    staged: int
    contiguous: bool
    chunk: int
    stages: int
    smem: int


@functools.lru_cache(maxsize=1024)
def dw_plan(P: int, dilation: int, H: int, itemsize: int) -> DwPlan:
    """Tile plan of K2 (y1 staged) for P taps at `dilation`, width H (a
    multiple of 128) and activations of `itemsize` bytes.

    A tile's taps reach S = min(br + span, P * br) rows, each read from
    shared memory instead of device memory, so S / br is the reads of the
    staged stream per output row: a tile's cost per output element. Among
    the tiles that fit a CTA's shared memory the plan takes the least cost,
    then the most rows, then the widest row up to 256 bytes (rows of 512
    bytes, and tiles small enough for a second CTA per SM, measured no
    faster on the H100: tools/time_dwconv.py). At the paper widths in bf16:
    128 x 128 at every dilation 1..128."""
    _require(P >= 1 and dilation >= 1 and H % KERNEL_WIDTH == 0 and itemsize in (2, 4),
             f"no depthwise tile for P={P}, dilation={dilation}, H={H}")
    fit = [dw_tile(P, dilation, H, itemsize, br, lanes)
           for lanes in DW_LANES if H % (lanes * 16 // itemsize) == 0 for br in DW_ROW_TILES]
    fit = [c for c in fit if c[1].smem <= SMEM_LIMIT]
    _require(bool(fit), f"no depthwise tile fits shared memory at P={P}, dilation={dilation}")
    return min(fit)[1]


def dw_tile(P: int, dilation: int, H: int, itemsize: int, br: int,
            lanes: int) -> Tuple[Tuple, DwPlan]:
    """(cost key, plan) of K2's tile of `br` rows and `lanes` threads per
    row (see dw_plan); card tests force each tile through it."""
    vec = 16 // itemsize
    bc = lanes * vec
    _require(H % bc == 0 and br in DW_ROW_TILES and lanes in DW_LANES,
             f"no tile of {br} rows x {bc} channels at H={H}")
    span = (P - 1) * dilation
    contiguous = dilation <= br
    staged = br + span if contiguous else P * br
    boxes = -(-staged // DW_BOX)             # TMA boxes of DW_BOX rows
    data = boxes * DW_BOX * lanes * 16
    cost = staged / br * itemsize
    chunk = -(-boxes // min(DW_MAX_STAGES, boxes))
    plan = DwPlan(br, bc, lanes, staged, contiguous, chunk, -(-boxes // chunk), DW_HEAD + data)
    return (cost, -br, -min(bc * itemsize, 256)), plan


def dw_window(plan: DwPlan, base: int, dilation: int) -> List[int]:
    """The row each window slot of K2 stages (csrc/tcn_dwconv_sm90.cuh
    Window): slot s holds base + s (contiguous) or base + (s // br) * d +
    s % br. Tap p of tile row r reads slot r + p * dw_stride (base k0 -
    left)."""
    br = plan.rows
    if plan.contiguous:
        return [base + s for s in range(plan.staged)]
    return [base + (s // br) * dilation + s % br for s in range(plan.staged)]


def dw_stride(plan: DwPlan, dilation: int) -> int:
    return dilation if plan.contiguous else plan.rows


# Strip plan of KB2 (csrc/tcn_dwconv_sm90.cuh): KB2_CONSUMERS threads convert
# and compute, one more warp issues the TMA loads; a row of a CTA's channels
# is KB2_VECS 16-byte vectors (128 bytes), a quarter of them each consumer
# warp's.
KB2_CONSUMERS = 128
KB2_WARPS = KB2_CONSUMERS // 32
KB2_VECS = 8
KB2_CHUNK = 32      # rows per stage (one TMA box per stream), one a consumer lane
KB2_STAGES = 2      # stages of the load ring: a third measured 2-10 % slower
SM_SMEM = 233472    # an SM's shared memory; a CTA reserves 1 KB of it
# An SM's rate with k of KB2's CTAs resident (k = 1, 2, 3), relative to
# three: the kernel is bound by the latency of its arithmetic, which the
# CTAs of an SM hide from each other. H100, tools/time_dwconv.py --strips.
KB2_SM_RATE = (0.6, 0.85, 1.0)
# A CTA's fixed cost, as bytes moved: its launch, the fill of its load ring
# and its partials.
KB2_CTA_BYTES = 16384


class StripPlan(NamedTuple):
    """KB2's strip plan: a CTA owns one item x `cols` channels (rows of 128
    bytes) x `strip` rows, `bands` strips per item (the last one ending at
    K_pad); it streams c and dz down the strip `chunk` rows a stage through
    a ring of `stages` TMA stages (c, dz and the own chunk's y1),
    converting them once into a dc ring of `ring` chunks (the conv span
    rounded up to chunks, plus the own chunk); `smem` bytes of dynamic
    shared memory; `grid` CTAs (M * bands * H / cols)."""
    cols: int
    chunk: int
    stages: int
    ring: int
    strip: int
    bands: int
    smem: int
    grid: int


def kb2_resident(P: int, smem: int) -> int:
    """KB2's CTAs resident per SM: three by its launch bounds up to 4 taps,
    two above, fewer where shared memory binds."""
    return min(3 if P <= 4 else 2, SM_SMEM // (smem + 1024))


@functools.lru_cache(maxsize=1024)
def kb2_plan(P: int, dilation: int, H: int, itemsize: int, M: int, Kp: int,
             sms: int) -> StripPlan:
    """Strip plan of KB2 for P taps at `dilation`, width H (a multiple of
    128), activations of `itemsize` bytes and M items of K_pad rows (a
    multiple of 128), on a card of `sms` SMs: the number of strips an item.

    A strip of L rows loads its own L rows of y1, c and dz and writes L
    rows of db, and loads the conv span (rounded up to chunks) of c and dz
    twice, once by the strip before it: a CTA's work is (4 L + 2 span) x
    128 bytes, plus KB2_CTA_BYTES. The card's time is taken as the waves of
    resident CTAs times a CTA's work times the k CTAs an SM runs at once,
    over the SM's rate with k (KB2_SM_RATE). Among the band counts with up
    to twice as many CTAs as the card holds at once, the plan takes the
    least time, then the most strips. At the paper's and taslp's train
    shapes (bf16, H=512, P=3, M=8) on 132 SMs: 64 channels, six strips an
    item (384 CTAs, three an SM) at every dilation 1..128."""
    _require(1 <= P <= 8 and dilation >= 1 and H % KERNEL_WIDTH == 0 and itemsize in (2, 4)
             and M >= 1 and Kp % KB2_CHUNK == 0 and Kp > 0 and sms >= 1,
             f"no strip plan for P={P}, dilation={dilation}, H={H}, M={M}, K_pad={Kp}")
    best = None
    for bands in range(1, Kp // KB2_CHUNK + 1):
        cost, plan = kb2_strip(P, dilation, H, itemsize, M, Kp, bands, sms)
        if bands > 1 and plan.grid > 2 * sms * kb2_resident(P, plan.smem):
            break
        if plan.bands == bands and (best is None or cost <= best[0]):
            best = (cost, plan)
    plan = best[1]
    _require(plan.smem <= SMEM_LIMIT,
             f"no strip plan fits shared memory at P={P}, dilation={dilation}, H={H}")
    return plan


def kb2_strip(P: int, dilation: int, H: int, itemsize: int, M: int, Kp: int, bands: int,
              sms: int = 132) -> Tuple[float, StripPlan]:
    """(cost, plan) of KB2 at `bands` strips per item (see kb2_plan; the
    strip is K_pad / bands rounded up to chunks, so fewer bands may
    result); card tests force plans through it."""
    bc = KB2_VECS * 16 // itemsize
    chunk, stages = KB2_CHUNK, KB2_STAGES
    _require(H % bc == 0 and Kp % chunk == 0 and bands >= 1,
             f"no strip of {chunk}-row chunks x {bc} channels at H={H}, K_pad={Kp}")
    span = (P - 1) * dilation
    pre = -(-span // chunk)
    row = KB2_VECS * 16
    strip = -(-Kp // (bands * chunk)) * chunk
    bands = -(-Kp // strip)
    ring = pre + 1
    smem = DW_HEAD + (stages * 3 + ring) * chunk * row + P * bc * 4  # and the f32 taps
    grid = M * bands * (H // bc)
    plan = StripPlan(bc, chunk, stages, ring, strip, bands, smem, grid)
    resident = max(1, kb2_resident(P, smem)) if smem <= SMEM_LIMIT else 1
    k = min(resident, -(-grid // sms))
    waves = -(-grid // (sms * resident))
    work = row * (4 * strip + 2 * pre * chunk) + KB2_CTA_BYTES
    return waves * k * work / KB2_SM_RATE[min(k, 3) - 1], plan


def kb2_load_rows(plan: StripPlan, Kp: int, band: int, left: int,
                  span: int) -> List[Tuple[int, Optional[int]]]:
    """The rows of an item that strip `band` loads, load chunk by load
    chunk (csrc: the producer's loop): [(first c / dz row, first y1 row or
    None)]; y1 rows are the strip's own, from load chunk ring - 1 on."""
    k_begin = band * plan.strip
    pre = plan.ring - 1
    j0 = k_begin + left - span
    nown = (min(k_begin + plan.strip, Kp) - k_begin) // plan.chunk
    return [(j0 + q * plan.chunk, k_begin + (q - pre) * plan.chunk if q >= pre else None)
            for q in range(nown + pre)]


def kb2_tap_slots(plan: StripPlan, dilation: int, span: int, P: int, i: int, r: int) -> List[int]:
    """The dc ring rows that taps p = 0..P-1 of row r of own chunk i read
    (rows k + left - p * d), by the kernel's arithmetic: own chunk i's tap 0
    starts at ring row (i * chunk + span) mod R, each chunk adding chunk
    rows, a row r more, a tap p * d fewer, each wrapped once."""
    R = plan.ring * plan.chunk
    own = span
    for _ in range(i):
        own += plan.chunk
        if own >= R:
            own -= R
    slot = own + r
    if slot >= R:
        slot -= R
    out = []
    for p in range(P):
        sp = slot - p * dilation
        if sp < 0:
            sp += R
        out.append(sp)
    return out


@functools.lru_cache(maxsize=None)
def _resident(index: int, mode: int) -> Tuple:
    return card_resident(_lib(), index, mode)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_gemm_h(H: int, dt: torch.dtype) -> None:
    _require(dt != torch.bfloat16 or H <= GEMM_MAX_H,
             f"H={H} exceeds the bf16 GEMM kernels' {GEMM_MAX_H}")


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
    """K1. Returns (y1 [M, K_pad, H], partial sums: one pair per row and
    column tile (cLN) or per CTA (gLN)); y1 may be given. bf16 runs on the
    TMA + wgmma pipeline (mode H_IN), tiled by `gemm_plan` with y1 as the
    epilogue's one tile."""
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
    idx = x.device.index
    bm, bn = (gemm_plan(M * Kp, H, B, _sm_count(idx), io_tiles=1, resident=_resident(idx, H_IN))
              if dt == torch.bfloat16 else (BM, BN))
    nct = H // bn
    stats = torch.empty((M, Kp // bm * nct, 2) if gln else (M, Kp, nct, 2),
                        dtype=torch.float32, device=x.device)
    _check_cuda(x, in_w, y1, dtype=dt)
    _check_cuda(x, alpha1, stats, dtype=None)
    _require(y1.shape == (M, Kp, H), "y1 scratch has the wrong shape")
    rc = _lib().tcn_in_gemm(x.device.index, _DTYPES[dt], x.data_ptr(), in_w.data_ptr(),
                            alpha1.data_ptr(), y1.data_ptr(), stats.data_ptr(),
                            M * Kp, Kp, B, H, int(gln), bm, bn, _stream(x))
    _build.check(rc, "tcn_in_gemm")
    ledger.count("tcn_in_gemm")
    return y1, stats


# ---------------------------------------------------------------------------
# K2: norm1 -> dilated depthwise conv -> PReLU, partial sums of e
# ---------------------------------------------------------------------------

def dwconv_stats_shape(M: int, Kp: int, H: int, P: int, dilation: int, itemsize: int,
                       norm_type: str, plain: bool) -> Tuple[int, ...]:
    """Shape of the norm2 partials K2 returns for y1 [M, K_pad, H] of
    `itemsize` bytes (one per CTA tile of dw_plan for gLN, per row and
    channel tile for cLN); plain: those of dwconv_plain (one per item or
    row)."""
    if plain:
        nct, tiles = 1, 1
    else:
        plan = dw_plan(P, dilation, H, itemsize)
        nct = H // plan.cols
        tiles = Kp // plan.rows * nct
    return (M, tiles, 2) if norm_type == "gLN" else (M, Kp, nct, 2)


def dwconv_plain(y1, stats1, alpha1, g1, b1, w, alpha2, norm_type, dilation,
                 causal, valid_k, e: Optional[torch.Tensor] = None,
                 save: bool = False, c: Optional[torch.Tensor] = None,
                 stats: Optional[torch.Tensor] = None):
    """Plain version of K2 (whole_tcn.py:139-188 with the conv halo of
    rows outside [0, K) zero). save=True also returns round(c)
    (whole_tcn.py:277-280, fused_whole_block.py:250-253). e, c and the
    partials `stats` (dwconv_stats_shape) may be given."""
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
    cv = None
    for p in range(P):
        tap = bp[:, p * dilation: p * dilation + Kp].float() * w[p]
        cv = tap if cv is None else cv + tap
    ev = _prelu_f32(cv, alpha2)
    em = torch.where(rows, ev, 0.0)
    stats = _into(stats, _sums(em, (1, 2))[:, None, :] if norm_type == "gLN"
                  else _sums(em, -1)[:, :, None, :])
    if save:
        return _into(e, ev.to(dt)), stats, _into(c, cv.to(dt))
    return _into(e, ev.to(dt)), stats


def _check_dw_plan(plan: DwPlan, H: int) -> None:
    _require(H % plan.cols == 0 and 1 <= plan.stages <= DW_MAX_STAGES
             and plan.smem <= SMEM_LIMIT, f"depthwise tile {tuple(plan)} does not fit H={H}")


def tcn_dwconv(y1, stats1, alpha1, g1, b1, w, alpha2, norm_type, dilation,
               causal, valid_k, e: Optional[torch.Tensor] = None,
               save: bool = False, c: Optional[torch.Tensor] = None,
               plan: Optional[DwPlan] = None, stats: Optional[torch.Tensor] = None):
    """K2. Returns (e [M, K_pad, H], partial sums: one pair per CTA tile of
    `dw_plan` (gLN) or per row and channel tile (cLN)), and c [M, K_pad, H]
    third with save=True; e, c and the partials `stats` (of
    dwconv_stats_shape) may be given. `plan` forces a tile (dw_tile); the
    default is dw_plan's."""
    if y1.device.type == "cpu":
        return dwconv_plain(y1, stats1, alpha1, g1, b1, w, alpha2, norm_type,
                            dilation, causal, valid_k, e, save, c, stats)
    M, Kp, H = y1.shape
    P = w.shape[0]
    dt = y1.dtype
    _check_widths(Kp, BN, H, dt)
    _require(0 < valid_k <= Kp, f"valid_k={valid_k} outside (0, {Kp}]")
    _require(w.shape == (P, H) and g1.shape == (H,) and b1.shape == (H,),
             "depthwise / norm1 parameter shapes do not match H")
    span = (P - 1) * dilation
    _require(span <= DWCONV_MAX_SPAN, f"conv span {span} exceeds the kernel's halo limit")
    gln = norm_type == "gLN"
    alpha1, alpha2 = alpha1.reshape(1), alpha2.reshape(1)
    if e is None:
        e = torch.empty_like(y1)
    if save and c is None:
        c = torch.empty_like(y1)
    plan = plan or dw_plan(P, dilation, H, y1.element_size())
    _check_dw_plan(plan, H)
    nct = H // plan.cols
    shape = (M, Kp // plan.rows * nct, 2) if gln else (M, Kp, nct, 2)
    if stats is None:
        stats = torch.empty(shape, dtype=torch.float32, device=y1.device)
    _require(stats.shape == shape and stats.dtype == torch.float32,
             "K2's partials do not match its tile")
    _check_cuda(y1, e, dtype=dt)
    if save:
        _check_cuda(y1, c, dtype=dt)
        _require(c.shape == y1.shape and e.shape == y1.shape, "e / c do not match y1")
    _check_cuda(y1, stats1, alpha1, g1, b1, w, alpha2, stats, dtype=None)
    for t in (stats1, alpha1, g1, b1, w, alpha2):
        _require(t.dtype == torch.float32, "statistics and parameters must be float32")
    n1 = stats1.shape[1] if gln else stats1.shape[2]
    _require(stats1.shape[0] == M and (gln or stats1.shape[1] == Kp),
             "stats1 does not match y1")
    rc = _lib().tcn_dwconv(y1.device.index, _DTYPES[dt], y1.data_ptr(), stats1.data_ptr(),
                           n1, alpha1.data_ptr(), g1.data_ptr(), b1.data_ptr(),
                           w.data_ptr(), alpha2.data_ptr(), e.data_ptr(),
                           c.data_ptr() if save else None,
                           stats.data_ptr(), M, Kp, valid_k, H, P, dilation,
                           int(causal), int(gln), plan.rows, plan.lanes, plan.staged,
                           plan.chunk, plan.stages, plan.smem, _stream(y1))
    _build.check(rc, "tcn_dwconv")
    ledger.count("tcn_dwconv_save" if save else "tcn_dwconv")
    return (e, stats, c) if save else (e, stats)


# ---------------------------------------------------------------------------
# K3: norm2 -> out_w -> residual add (in place)
# ---------------------------------------------------------------------------

def out_weights(out_w, skip_w=None):
    """The weight of K3's product: out_w [..., H, B], or [out_w | skip_w]
    [..., H, B + Sc] for a block with a skip path (one copy a call)."""
    return out_w if skip_w is None else torch.cat([out_w, skip_w], dim=-1)


def fold_weights(out_w, g2, b2, dtype, skip_w=None):
    """Per-block terms of the norm2 -> out_w fold (whole_tcn.py:189-228)
    for stacked [NB, H, B] / [NB, H] weights: (round(g2 * W), g2 @ W,
    b2 @ W) with W = out_w (or [out_w | skip_w], B + Sc columns) rounded
    to the activation dtype."""
    ow32 = out_weights(out_w, skip_w).to(dtype).float()
    wp = (g2[..., :, None] * ow32).to(dtype)
    g2w = torch.matmul(g2[..., None, :], ow32)[..., 0, :]
    b2w = torch.matmul(b2[..., None, :], ow32)[..., 0, :]
    return wp.contiguous(), g2w.contiguous(), b2w.contiguous()


FOLD_COLS = 64      # columns per CTA of KFW (csrc/tcn_fold_weights.cuh FW_COLS)
FOLD_MIN_ROWS = 64  # rows of a slice of H, at least (FW_MIN_ROWS): 4 loads per thread
FOLD_MIN_PER_SM = 2  # CTAs per SM KFW's plan asks for, at least


def fold_plan(NB: int, H: int, B: int, sms: int, resident: int) -> Tuple[int, int]:
    """(slices of H, rows per slice) of KFW's grid: NB * B / FOLD_COLS
    column tiles, each split over enough slices for FOLD_MIN_PER_SM CTAs
    per SM on `sms` SMs, or as many as are resident at once (`resident`
    per SM) if more, with at least FOLD_MIN_ROWS rows a slice. At the paper
    widths (NB=32, H=512, B=256) on an H100 at four CTAs per SM: 4 slices
    of 128 rows, 512 CTAs; at the scaled ones (NB=60, H=1024): 2 of 512."""
    tiles = NB * (B // FOLD_COLS)
    tiles = max(1, tiles)
    want = max(-(-FOLD_MIN_PER_SM * sms // tiles), resident * sms // tiles)
    splits = max(1, min(want, H // FOLD_MIN_ROWS))
    return splits, -(-H // splits)


@functools.lru_cache(maxsize=None)
def _fold_resident(index: int, code: int) -> int:
    return _lib().tcn_fold_resident(index, code)


# KFW's slice sums and last-arrival tickets per (device, column tiles,
# slices): kept for the life of the process, since a captured CUDA graph
# holds their addresses. The tickets are zero between launches: the
# launch that finds them new zeroes them first, then each launch's last
# CTA of a column tile resets its own.
_FOLD_SCRATCH: dict = {}


def _fold_scratch(device, tiles: int, splits: int):
    """(slice sums, tickets, whether they are new)."""
    key = (str(device), tiles, splits)
    fresh = key not in _FOLD_SCRATCH
    if fresh:
        _FOLD_SCRATCH[key] = (torch.empty((tiles, splits, 2, FOLD_COLS), dtype=torch.float32,
                                          device=device),
                              torch.empty((tiles,), dtype=torch.int32, device=device))
    return (*_FOLD_SCRATCH[key], fresh)


def tcn_fold_weights(out_w, g2, b2, dtype, skip_w=None):
    """KFW: fold_weights in one launch over all NB blocks. out_w f32
    [NB, H, B], g2 / b2 f32 [NB, H] -> (wp [NB, H, B] in `dtype`, g2w,
    b2w f32 [NB, B]); wp equals the plain version's bit for bit, g2w / b2w
    sum in a fixed order of their own (fold_plan's slices of H, added in
    slice order by the last CTA of each column tile). With skip_w [NB, H,
    Sc] the fold covers [out_w | skip_w], B + Sc columns, in KFW's skip
    kernel (counter tcn_fold_weights_skip)."""
    if out_w.device.type == "cpu":
        return fold_weights(out_w, g2, b2, dtype, skip_w)
    skip = skip_w is not None
    out_w = out_weights(out_w, skip_w)
    NB, H, B = out_w.shape
    _require(dtype in _DTYPES, f"unsupported activation dtype {dtype}")
    _require(B % FOLD_COLS == 0, f"B={B} is not a multiple of {FOLD_COLS}")
    _require(g2.shape == (NB, H) and b2.shape == (NB, H),
             "norm2 vectors do not match out_w")
    _check_cuda(out_w, g2, b2, dtype=torch.float32)
    _require(out_w.data_ptr() % 16 == 0, "out_w is not 16-byte aligned")
    idx = out_w.device.index
    splits, rows = fold_plan(NB, H, B, _sm_count(idx), _fold_resident(idx, _DTYPES[dtype]))
    part, ticket, fresh = _fold_scratch(out_w.device, NB * B // FOLD_COLS, splits)
    wp = torch.empty((NB, H, B), dtype=dtype, device=out_w.device)
    g2w = torch.empty((NB, B), dtype=torch.float32, device=out_w.device)
    b2w = torch.empty_like(g2w)
    launch = _lib().tcn_fold_weights_skip if skip else _lib().tcn_fold_weights
    rc = launch(idx, _DTYPES[dtype], out_w.data_ptr(), g2.data_ptr(), b2.data_ptr(),
                wp.data_ptr(), g2w.data_ptr(), b2w.data_ptr(), part.data_ptr(), ticket.data_ptr(),
                int(fresh), splits, rows, NB, H, B, _stream(out_w))
    _build.check(rc, "tcn_fold_weights")
    ledger.count("tcn_fold_weights_skip" if skip else "tcn_fold_weights")
    return wp, g2w, b2w


def out_gemm_plain(e, stats2, res, wmat, vec_a, vec_b, norm_type, valid_k,
                   fold, out=None, skip=None):
    """Plain version of K3: returns round(res + o) with rows >= valid_k
    zero, written into `out` when given (which may be `res`).

    fold:   wmat = round(g2 * out_w), vec_a = g2 @ W, vec_b = b2 @ W;
    unfold: wmat = out_w (activation dtype), vec_a = g2, vec_b = b2.
    With `skip` (the skip sum s [M, K_pad, Sc]), wmat and the fold's
    vectors cover [out_w | skip_w], and o's last Sc columns are added
    into s in place the same way."""
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
    zero = torch.zeros((), dtype=dt, device=e.device)
    B = res.shape[2]
    if skip is not None:
        skip.copy_(torch.where(rows, skip + o[..., B:].to(dt), zero))
    return _into(out, torch.where(rows, res + o[..., :B].to(dt), zero))


def tcn_out_gemm(e, stats2, res, wmat, vec_a, vec_b, norm_type, valid_k, fold,
                 out=None, skip=None):
    """K3: round(res + round(norm2(e) @ out_w)), rows >= valid_k zeroed,
    into `out` (a new tensor when None; in place when out is res). With
    `skip` (s [M, K_pad, Sc], bf16), K3's skip mode: wmat [H, B + Sc] and
    the fold's vectors [B + Sc], the last Sc columns added into s in
    place."""
    if e.device.type == "cpu":
        return out_gemm_plain(e, stats2, res, wmat, vec_a, vec_b, norm_type,
                              valid_k, fold, out, skip)
    M, Kp, H = e.shape
    B = res.shape[2]
    Sc = 0 if skip is None else skip.shape[2]
    dt = e.dtype
    _check_widths(Kp, B, H, dt)
    _require(res.shape == (M, Kp, B) and wmat.shape == (H, B + Sc),
             "residual / weight shapes do not match e")
    if out is None:
        out = torch.empty_like(res)
    _require(0 < valid_k <= Kp, f"valid_k={valid_k} outside (0, {Kp}]")
    nv = B + Sc if fold else H
    _require(vec_a.shape == (nv,) and vec_b.shape == (nv,),
             "norm2 vectors have the wrong length")
    _check_gemm_h(H, dt)
    gln = norm_type == "gLN"
    _check_cuda(e, res, out, wmat, dtype=dt)
    if skip is not None:
        _require(dt == torch.bfloat16, "K3's skip mode runs bf16 only")
        _require(Sc % KERNEL_WIDTH == 0, f"Sc={Sc} is not a multiple of {KERNEL_WIDTH}")
        _require(skip.shape == (M, Kp, Sc), "the skip sum does not match e")
        _check_cuda(e, skip, dtype=dt)
    _require(out.shape == res.shape, "out does not match the residual")
    _check_cuda(e, stats2, vec_a, vec_b)
    for t in (stats2, vec_a, vec_b):
        _require(t.dtype == torch.float32, "statistics and norm2 terms must be float32")
    n2 = stats2.shape[1] if gln else stats2.shape[2]
    _require(stats2.shape[0] == M and (gln or stats2.shape[1] == Kp),
             "stats2 does not match e")
    idx = e.device.index
    mode = (H_FOLD if fold else H_UNFOLD) | (H_SKIP if Sc else 0)
    bm, bn = (gemm_plan(M * Kp, B + Sc, H, _sm_count(idx), resident=_resident(idx, mode),
                        seam=B if Sc else 0)
              if dt == torch.bfloat16 else (0, 0))
    rc = _lib().tcn_out_gemm(e.device.index, _DTYPES[dt], int(fold), e.data_ptr(),
                             stats2.data_ptr(), n2, wmat.data_ptr(), vec_a.data_ptr(),
                             vec_b.data_ptr(), res.data_ptr(), out.data_ptr(),
                             skip.data_ptr() if Sc else None, M * Kp, Kp, valid_k, H, B, Sc,
                             int(gln), bm, bn, _stream(e))
    _build.check(rc, "tcn_out_gemm")
    ledger.count("tcn_out_gemm_" + ("fold" if fold else "unfold") + ("_skip" if Sc else ""))
    return out


# The counters of `counts()`: every forward kernel of csrc/ and its modes,
# and the stream chunk step's block kernel (stream_block.py).
COUNTERS = ("tcn_in_gemm", "tcn_dwconv", "tcn_dwconv_save", "tcn_out_gemm_fold",
            "tcn_out_gemm_unfold", "tcn_fold_weights", "tcn_stream_block",
            "tcn_out_gemm_fold_skip", "tcn_out_gemm_unfold_skip", "tcn_fold_weights_skip")


def reset_counts() -> None:
    ledger.reset(COUNTERS)


def counts() -> dict:
    """Launches of the forward kernels, and of the stream chunk step's
    block kernel (stream_block.py): every kernel of csrc/ but the backward
    ones (tcn_block_bwd.counts()), whose records the timers check."""
    return ledger.read(COUNTERS)
