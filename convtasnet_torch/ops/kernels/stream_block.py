"""Wrapper of the stream chunk step's TCN-block kernel
(csrc/tcn_stream_block.cu) and its plain PyTorch version.

One temporal block of models/streaming.stream_step on a chunk of Kc frames
x [M, Kc, B] with the block's causal history hist [M, span, H] (span =
(P - 1) * dilation, oldest frame first):

  y = bf16(x @ in_w) (f32 accumulation); PReLU1 in bf16; cLN1 (f32
  statistics, then bf16); the causal dilated depthwise conv over [hist; y],
  each tap rounded to bf16 and the taps summed in bf16 in tap order; the
  new history, the last span frames of [hist; y]; PReLU2 in bf16; cLN2;
  x' = bf16(x + bf16(e @ out_w)).

`stream_block_plain` is these ops one by one and returns a new history.
The kernel runs the whole block in one launch, one cluster of 8 CTAs per
stream (`stream_plan`), and writes the new history into `hist` itself, so
the step needs no concatenation of the history and no copy of it into the
state. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. The wrapper counts its launches as "tcn_stream_block"
in the port's launch ledger (utils/ledger.py), which tcn_block.counts()
reads with the other kernels' counters.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from ...utils import ledger
from ..activations import prelu
from ..conv import pointwise
from ..norms import channelwise_layer_norm
from . import _build
from .limits import STREAM_CLUSTER, STREAM_ROWS, STREAM_SMEM, STREAM_WIDTHS, stream_smem

THREADS = 128  # a CTA's threads (csrc/tcn_stream_block.cu THREADS)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tcn_stream_block": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _P],
    "tcn_stream_block_smem": [_I, _I, _I, _I],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("tcn_stream_block")
    for fn, args in _SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes, f.restype = args, ctypes.c_int
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


class StreamPlan(NamedTuple):
    """Launch of the stream kernel: `clusters` clusters (one per stream) of
    `cluster` CTAs of `threads` threads, `ctas` in all; each CTA takes
    `channels` = H / cluster channels and `columns` = B / cluster output
    columns, and runs the chunk's frames in `tiles` tiles of `rows`, keeping
    a ring of `ring` frames (span + rows) in `smem` bytes of shared memory."""
    clusters: int
    cluster: int
    ctas: int
    threads: int
    channels: int
    columns: int
    rows: int
    tiles: int
    ring: int
    smem: int


def stream_plan(M: int, Kc: int, B: int, H: int, P: int, dilation: int) -> StreamPlan:
    """The launch for M streams of Kc frames at widths B, H with P taps at
    `dilation`; raises where the kernel is not built for the widths or the
    ring does not fit shared memory."""
    _require(M >= 1 and Kc >= 1 and P >= 1 and dilation >= 1,
             f"no stream launch for M={M}, Kc={Kc}, P={P}, dilation={dilation}")
    _require((B, H) in STREAM_WIDTHS,
             f"the stream block kernel is built for (B, H) in {STREAM_WIDTHS}")
    span = (P - 1) * dilation
    smem = stream_smem(B, H, P, span)
    _require(smem <= STREAM_SMEM,
             f"conv span {span} overflows the stream kernel's shared-memory ring")
    return StreamPlan(M, STREAM_CLUSTER, M * STREAM_CLUSTER, THREADS, H // STREAM_CLUSTER,
                      B // STREAM_CLUSTER, STREAM_ROWS, -(-Kc // STREAM_ROWS),
                      span + STREAM_ROWS, smem)


def _causal_dw_streaming(x: torch.Tensor, hist: torch.Tensor, w: torch.Tensor,
                         dilation: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv with carried history; the taps sum in x's dtype.

    x: [M, Kc, H] current frames; hist: [M, span, H] previous frames.
    Returns (y [M, Kc, H], new_hist)."""
    P = w.shape[0]
    span = (P - 1) * dilation
    ext = torch.cat([hist, x], dim=1)  # [M, span + Kc, H]
    Kc = x.shape[1]
    wd = w.to(x.dtype)
    out = None
    for p in range(P):
        tap = ext[:, p * dilation: p * dilation + Kc, :] * wd[p]
        out = tap if out is None else out + tap
    new_hist = ext[:, ext.shape[1] - span:, :] if span > 0 else hist
    return out, new_hist


def stream_block_plain(x: torch.Tensor, hist: torch.Tensor, bp: Dict[str, torch.Tensor],
                       dilation: int, dt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the block's ops one by one. x [M, Kc, B] in the
    compute dtype `dt`, hist [M, span, H], bp the block's parameter leaves.
    Returns (x' [M, Kc, B], the new history, a new tensor)."""
    y = pointwise(x, bp["in_w"], dt).to(dt)
    y = prelu(y, bp["in_prelu"])
    y = channelwise_layer_norm(y, bp["in_gamma"], bp["in_beta"])
    y, h = _causal_dw_streaming(y, hist, bp["dw_w"], dilation)
    y = prelu(y, bp["dw_prelu"])
    y = channelwise_layer_norm(y, bp["dw_gamma"], bp["dw_beta"])
    return x + pointwise(y, bp["out_w"], dt).to(dt), h


def stream_block(x: torch.Tensor, hist: torch.Tensor, bp: Dict[str, torch.Tensor],
                 dilation: int, dt: torch.dtype, pdl: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block on x [M, Kc, B] with history hist [M, span, H]: (x', the
    new history). On a card one launch of the kernel, which writes the new
    history into `hist` and returns it; the leaves are taken in the compute
    dtype (the norms' affines in f32), a cast only where they are not.
    `pdl`: a programmatic dependent launch, which loads the leaves while the
    stream's previous kernel runs, so they must not be that kernel's output:
    constant parameters, as the separator's are; where a leaf is cast here
    the launch waits for the cast (False: the kernel alone, as the timers
    take it: a dependent's device time includes its wait)."""
    if x.device.type == "cpu":
        return stream_block_plain(x, hist, bp, dilation, dt)
    _require(dt == torch.bfloat16 and x.dtype == dt and hist.dtype == dt,
             "the stream block kernel runs bf16 activations and history only")
    M, Kc, B = x.shape
    in_w, dw, out_w = (bp[k].to(dt) for k in ("in_w", "dw_w", "out_w"))
    H, P = in_w.shape[1], dw.shape[0]
    plan = stream_plan(M, Kc, B, H, P, dilation)
    span = plan.ring - plan.rows
    a1, a2 = (bp[k].to(dt).reshape(1) for k in ("in_prelu", "dw_prelu"))
    g1, b1, g2, b2 = (bp[k].float() for k in ("in_gamma", "in_beta", "dw_gamma", "dw_beta"))
    _require(in_w.shape == (B, H) and out_w.shape == (H, B) and dw.shape == (P, H)
             and all(v.shape == (H,) for v in (g1, b1, g2, b2)),
             "the block's parameter shapes do not match B and H")
    _require(hist.shape == (M, span, H), f"history shape {tuple(hist.shape)} != {(M, span, H)}")
    ts = (x, hist, in_w, a1, g1, b1, dw, a2, g2, b2, out_w)
    leaves = dict(zip(("in_w", "in_prelu", "in_gamma", "in_beta", "dw_w", "dw_prelu", "dw_gamma",
                       "dw_beta", "out_w"), ts[2:]))
    pdl = pdl and all(t.data_ptr() == bp[k].data_ptr() for k, t in leaves.items())
    _require(all(t.is_cuda and t.device == x.device and t.is_contiguous() for t in ts),
             "all tensors must be contiguous on one CUDA device")
    out = torch.empty_like(x)
    rc = _lib().tcn_stream_block(
        x.device.index, x.data_ptr(), out.data_ptr(), in_w.data_ptr(), a1.data_ptr(),
        g1.data_ptr(), b1.data_ptr(), dw.data_ptr(), a2.data_ptr(), g2.data_ptr(), b2.data_ptr(),
        out_w.data_ptr(), hist.data_ptr(), M, Kc, B, H, P, dilation, int(pdl),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "tcn_stream_block")
    ledger.count("tcn_stream_block")
    return out, hist
