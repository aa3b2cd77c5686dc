"""Chip smoke test of the PyTorch/CUDA port (convtasnet_torch) on one GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit);
2. builds the kernels from convtasnet_torch/csrc with nvcc (timed);
3. kernel phase: holds every kernel form against its plain PyTorch version
   at the paper widths (B=256, H=512, P=3) and the main path's shapes
   (batch 8, K=3199 frames, padded to 3200), for every dilation 1..128,
   gLN and cLN, causal and non-causal, in f32 and in bf16, then the
   32-block chains of both forms; then K1, K3 (fold and unfold, into a
   fresh tensor and in place), KB1 (NaN in the rows >= K of g and c) and
   KB3 at the test width (B=128, H=256, batch 3, K_pad=384) at every tile
   plan of the bf16 wgmma kernels, and K2 (both modes) and KB2 there, with
   rows >= K exact zeros and two launches giving equal bytes; then K2 and
   KB2 at the span and tap limits of ops/kernels/limits.py (K2 span 4096,
   KB2 span 1024 and 8 taps) with NaN in the rows >= K they never read;
4. training kernel phase: holds K2's save mode and the backward kernels
   (KB1 tcn_bwd_dz, KW tcn_wgrad in both forms, also with NaN in the rows
   >= K of its second operand, KB2 tcn_bwd_dwconv with NaN in the rows
   >= K of c and dz, KB3 tcn_bwd_dx) against
   their plain versions at the training shapes (batch
   5 x 4 s, K=3199 padded to 3200), every dilation, gLN and cLN, causal
   and not, f32 and bf16; then the 32-block save-form chain and its
   backward (whole_tcn_bwd), the per-block recompute and hybrid
   backwards, and requires two backward runs to give identical bytes;
5. slice phase: writes seeded paper-config weights with the port's
   save_checkpoint and synthetic 8 kHz mixtures with its wavio, then runs
   `convtasnet_torch.cli.separate` on cuda with --batch_size 8 and
   --use_kernels auto (the main path), block and 0; checks the wavs, the
   launch counts (NB per forward for every kernel of the form) and the
   agreement of the kernel forms with the eager run;
6. evaluate phase: writes two tt sets with the port's modules (harmonic,
   data/synthetic, 6 utterances of 2.5-10 s; broadband, band-passed noise
   mixed at 0-5 dB, 4 utterances), manifests them with
   `convtasnet_torch.cli.preprocess`, and runs `convtasnet_torch.cli.evaluate`
   on the slice phase's checkpoint on cuda with --use_kernels auto, block
   and 0, each with --cal_sdr 1 --sdr_backend device, then the broadband set
   with --sdr_backend host; checks counts, finite metrics, the launches per
   forward, the kernel forms' reordered estimates against the eager chain's,
   device (f64) SDRi against host SDRi on the same estimates, that the
   native decoder decoded every file and that native/*.so did not change;
   times evaluate per utterance, device BSS-Eval (f64 and f32) per
   utterance and the native and wavio decode per batch;
7. train phase: writes a synthetic 4 s, 8 kHz wav dataset (10 tr, 4 cv
   utterances) with the port's synthetic.py and runs
   `convtasnet_torch.cli.train` on cuda at the paper config, --batch_size
   5, with --use_kernels hybrid (the main path), whole and 0: finite
   losses, checkpoints that load, a --continue_from resume, and the launch
   counts of the run; then one train step of each form from the same
   seed: the launches per step, the loss, and the gradients against the
   eager autograd step in f32 and bf16;
8. times the forward at batch 8 and batch 1 (4 s at 8 kHz), the train
   step at batch 5 x 4 s, each kernel per launch beside its plain
   version, one PyTorch call where there is one (torch.matmul of a GEMM
   kernel's product; F.conv1d / F.conv_transpose1d with groups=H of the
   depthwise kernels, cuDNN with TF32 off), and its roofline bound, and the
   backward of each training op beside its plain version; K2, K2 save and
   KB2 also per dilation beside the cuDNN call, with their tile (and KB2's
   f32 channel-partial bytes beside its bound); KW's launch plan
   and its Stage A time (the same splits, one partial per CTA) beside the
   plan's (Stage B: partials summed inside clusters). `ms`, `plain_ms`
   and `library_ms` are device time per call from torch.profiler (the
   kernels' own time: a wrapper's host time can exceed it), `event_ms` the
   CUDA-event time per call of back-to-back calls, `host_us` the host's
   enqueue time per call;
9. prints the card again, a {"kernels": [...]} line (each kernel with its
   `design`) and, last, {"ok": true, "device": {...}}.

Any failed check raises and the script exits non-zero. It imports nothing
of JAX; without a CUDA device, or without the package beside it, it fails.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM data-sheet peaks (dense), for the roofline bound of each kernel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Stated tolerances (max |kernel - plain| / max |plain|, or relative L2).
TOL_F32 = 1e-4          # single kernels and chains in f32
TOL_BF16 = 1.6e-2       # single kernels in bf16: a few bf16 ulps
TOL_CHAIN_BF16 = 1e-2   # 32-block chain in bf16, relative L2
TOL_E2E_BF16 = 5e-2     # separated wavs, kernel forms vs eager, relative L2
TOL_E2E_F32 = 1e-3      # f32 forward, kernel forms vs eager, relative L2
# Training. The backward kernels round their wide streams to bf16 where the
# plain versions do, but sum in another order, so a bf16 rounding can fall
# the other way; through the 32-block backward chain such flips compound
# like the forward chain's (5.9e-3 relative L2 on the H100, PERF.md), twice over
# (forward recompute and backward).
TOL_BWD_CHAIN_BF16 = 5e-2   # 32-block backward / per-block backwards, bf16, relative L2
TOL_GRAD_F32 = 1e-3         # train-step gradients, kernel forms vs eager autograd, per leaf
# bf16 train step against eager autograd: the eager chain rounds every op's
# output to bf16 (PyTorch's bf16 kernels) where the kernels keep f32 inside
# a block and round only the stored streams, so the two differ by the
# bf16 drift of 32 blocks forward and backward: a few 2^-8 relative steps,
# compounded. Stated before the first paper-config run.
TOL_GRAD_BF16 = 1e-1        # train-step gradients, relative L2 per leaf, bf16
TOL_LOSS_BF16 = 2e-2        # first-step loss, kernel forms vs eager, relative
TOL_LOSS_F32 = 1e-4
# d_alpha1 / d_alpha2 are each one sum over M*K*H = 8.2M terms of mixed sign:
# in f32 a change of summation order alone moves the result by about
# eps * sqrt(N) * sum|t| / |sum t| (6e-8 * 2900 * 1..10 = 2e-4..2e-3).
TOL_ALPHA_F32 = 2e-3
# Evaluate: device BSS-Eval (f64) against the host f64 numpy BSS-Eval on the
# same estimates, per utterance in dB; the JAX package's gates for
# non-degenerate and degenerate (tonal) Grams (tests/test_metrics.py).
TOL_SDR_BROADBAND_DB = 1e-3
TOL_SDR_HARMONIC_DB = 1e-2

SR = 8000
SOURCE = "convtasnet_torch/csrc/tcn_block.cu"
WHOLE_TCN = "convtasnet_tpu/ops/pallas/whole_tcn.py:55"
WHOLE_BLOCK = "convtasnet_tpu/ops/pallas/fused_whole_block.py:57"
SOURCE_BWD = "convtasnet_torch/csrc/tcn_block_bwd.cu"
SOURCE_KW = "convtasnet_torch/csrc/tcn_wgrad_sm90.cuh"
BWD_BLOCK = "convtasnet_tpu/ops/pallas/whole_tcn_hybrid.py:64"
GRAD_NAMES = ("dx", "din_w", "da1", "dg1", "db1", "dw", "da2", "dg2", "db2", "dout_w")
# How each kernel is built (bf16, the main path's type).
# stencil+bulk: the staged stencil of csrc/tcn_dwconv_sm90.cuh (row boxes
# by TMA bulk copies on mbarriers, 16-byte vectors, converted once per row).
STENCIL = "stencil+bulk"
DESIGN = {"tcn_in_gemm": "wgmma+tma", "tcn_dwconv": STENCIL, "tcn_out_gemm_fold": "wgmma+tma",
          "tcn_out_gemm_unfold": "wgmma+tma", "tcn_dwconv_save": STENCIL,
          "tcn_bwd_dz": "wgmma+tma", "tcn_wgrad_out": "wgmma+tma", "tcn_bwd_dwconv": STENCIL,
          "tcn_bwd_dx": "wgmma+tma", "tcn_wgrad_in": "wgmma+tma"}
SOURCE_DW = "convtasnet_torch/csrc/tcn_dwconv_sm90.cuh"
TRAIN_KERNELS = ("tcn_dwconv_save", "tcn_bwd_dz", "tcn_wgrad_out", "tcn_bwd_dwconv",
                 "tcn_bwd_dx", "tcn_wgrad_in")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warm=3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warm=3, tries=3) -> float:
    """Device time per call: the device time of every kernel `fn`
    launches, summed by torch.profiler over `iters` calls. A profile that
    recorded no device time (it happens now and then on the H100) is taken
    again, up to `tries` times."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    raise AssertionError("torch.profiler recorded no device time")


def host_us(fn, iters=20) -> float:
    """Host time per call to enqueue `fn` (no synchronisation inside)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def forward_ms(fn, iters=20, warm=3):
    """Median and count of per-forward CUDA-event times (each forward timed
    by its own event pair, the host waiting for each)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), iters


def rel_max(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


class Checks:
    """Collects the comparisons of a phase, prints each, raises at the end."""

    def __init__(self, phase):
        self.phase, self.failed = phase, []

    def __call__(self, what, err, tol):
        ok = np.isfinite(err) and err <= tol
        log(f"  [{'ok' if ok else 'FAIL'}] {what}: {err:.3e} (tol {tol:.1e})")
        if not ok:
            self.failed.append(f"{what}: {err:.3e} > {tol:.1e}")

    def done(self):
        if self.failed:
            raise AssertionError(f"{self.phase}: {len(self.failed)} checks failed:\n"
                                 + "\n".join(self.failed))


def all_counts():
    from convtasnet_torch.ops.kernels import tcn_block as tb, tcn_block_bwd as tbb
    return {**tb.counts(), **tbb.counts()}


def reset_all_counts():
    from convtasnet_torch.ops.kernels import tcn_block as tb, tcn_block_bwd as tbb
    tb.reset_counts()
    tbb.reset_counts()


def gemm_width_phase(dev, M=3, Kp=384, K=300, B=128, H=256):
    """K1, K3 (fold and unfold, fresh output and in place), KB1 and KB3 at
    the test width against their plain versions, at every tile plan of the
    bf16 wgmma kernels: the card's SM count and occupancy, then one CTA
    counted per SM on one SM (gemm_plan takes 128-row tiles), on as many
    SMs as the 64-row tiles of K1 and KB1 (64 x 256) and on unbounded SMs
    (64 x 128); rows >= K exact zeros (KB1 with NaN in the rows >= K of g
    and c); two launches equal bytes."""
    from convtasnet_torch.ops.kernels import tcn_block as tb, tcn_block_bwd as tbb

    chk = Checks("test-width K1 / K3 / KB1 / KB3 phase")
    log(f"test-width K1 / K3 / KB1 / KB3 phase (B={B}, H={H}, M={M}, K_pad={Kp}):")
    gen = torch.Generator(device=dev).manual_seed(21)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    in_w, out_w = rnd(B, H, scale=0.1), rnd(H, B, scale=0.1)
    a1, a2 = torch.full((1,), 0.25, device=dev), torch.full((1,), 0.25, device=dev)
    g1, b1, g2, b2 = rnd(H, scale=0.1, shift=1.0), rnd(H, scale=0.1), rnd(H, scale=0.1, shift=1.0), rnd(H, scale=0.1)
    w = rnd(3, H, scale=0.3)
    x32 = rnd(M, Kp, B)
    x32[:, K:] = 0
    g32 = rnd(M, Kp, B)
    real = (tb._sm_count, tb._resident, tbb._resident)
    idx = torch.cuda.current_device()
    one_each = lambda index, mode: ()  # noqa: E731 (one CTA counted per SM)
    options = [real] + [(lambda index, n=n: n, one_each, one_each)
                        for n in (1, M * Kp // 64 * (H // 256), 10 ** 6)]
    try:
        for sms, res, res_bwd in options:
            tb._sm_count = tbb._sm_count = sms
            tb._resident, tbb._resident = res, res_bwd
            for dt in (torch.float32, torch.bfloat16):
                tol = TOL_F32 if dt == torch.float32 else TOL_BF16
                x, g = x32.to(dt), g32.to(dt)
                for norm in ("gLN", "cLN"):
                    red = (1,) if norm == "gLN" else (2,)
                    n = sms(idx)
                    tiles = ("plans K3 " + str(tb.gemm_plan(M * Kp, B, H, n, resident=res(idx, tb.H_FOLD)))
                             + ", K1 " + str(tb.gemm_plan(M * Kp, H, B, n, io_tiles=1,
                                                          resident=res(idx, tb.H_IN)))
                             + ", KB1 " + str(tb.gemm_plan(M * Kp, H, B, n,
                                                           resident=res_bwd(idx, tb.H_DZ))))
                    what = f"{'f32' if dt == torch.float32 else 'bf16'} {norm} {tiles}"
                    y1, s1 = tb.in_gemm_plain(x, in_w.to(dt), a1, norm)
                    y1k, s1k = tb.tcn_in_gemm(x, in_w.to(dt), a1, norm)
                    chk(f"K1 {what} y1", rel_max(y1k, y1), tol)
                    chk(f"K1 {what} stats", rel_max(s1k.sum(red), s1.sum(red)), tol)
                    chk(f"K1 {what} pad rows zero", float(y1k[:, K:].abs().max()), 0.0)
                    chk(f"K1 {what} repeat", float(sum(not torch.equal(u, v) for u, v in zip(
                        (y1k, s1k), tb.tcn_in_gemm(x, in_w.to(dt), a1, norm)))), 0.0)
                    for causal in (False, True):
                        what = f"{'f32' if dt == torch.float32 else 'bf16'} {norm} causal={causal} {tiles}"
                        e, s2, c = tb.dwconv_plain(y1, s1, a1, g1, b1, w, a2, norm, 2, causal, K,
                                                   save=True)
                        if sms is real[0]:  # K2 and KB2 take no SM count: once
                            dw_checks(chk, what, (y1, s1, a1, g1, b1, w, a2, norm, 2, causal, K),
                                      g, out_w.to(dt).t().contiguous(), g2, tol)
                        for fold in (True, False):
                            wm, va, vb = (tb.fold_weights(out_w, g2, b2, dt) if fold
                                          else (out_w.to(dt), g2, b2))
                            args = (e, s2, x, wm, va, vb, norm, K, fold)
                            want = tb.out_gemm_plain(*args)
                            got = tb.tcn_out_gemm(*args)
                            xi = x.clone()
                            inpl = tb.tcn_out_gemm(e, s2, xi, wm, va, vb, norm, K, fold, out=xi)
                            form = "fold" if fold else "unfold"
                            chk(f"K3 {form} {what}", rel_max(got, want), tol)
                            chk(f"K3 {form} {what} pad rows zero", float(got[:, K:].abs().max()), 0.0)
                            chk(f"K3 {form} {what} in place == fresh",
                                float(not torch.equal(inpl, got)), 0.0)
                            chk(f"K3 {form} {what} repeat",
                                float(not torch.equal(tb.tcn_out_gemm(*args), got)), 0.0)
                        zargs = (nan_pad(g, K), out_w.to(dt).t().contiguous(), nan_pad(c, K), s2,
                                 a2, g2, norm, K)
                        dz, colp, gs2 = tbb.bwd_dz_plain(*zargs)
                        dzk, colk, gs2k = tbb.tcn_bwd_dz(*zargs)
                        chk(f"KB1 {what} dz, NaN in g's and c's rows >= K", rel_max(dzk, dz), tol)
                        chk(f"KB1 {what} dz pad rows zero", float(dzk[:, K:].abs().max()), 0.0)
                        chk(f"KB1 {what} dg2/db2", rel_max(colk.sum(0), colp.sum(0)), tol)
                        chk(f"KB1 {what} norm2 sums", rel_max(gs2k.sum(red), gs2.sum(red)), tol)
                        chk(f"KB1 {what} repeat", float(sum(not torch.equal(u, v) for u, v in zip(
                            (dzk, colk, gs2k), tbb.tcn_bwd_dz(*zargs)))), 0.0)
                        db, _, gs1, _ = tbb.bwd_dwconv_plain(y1, c, dz, s1, s2, gs2, a1, g1, b1, w,
                                                             a2, g2, norm, 2, causal, K)
                        xargs = (db, y1, in_w.to(dt).t().contiguous(), g, s1, gs1, a1, g1, norm, K)
                        dxk, dy1k, da1k = tbb.tcn_bwd_dx(*xargs)
                        dxp, dy1p, da1p = tbb.bwd_dx_plain(*xargs)
                        chk(f"KB3 {what} dx", rel_max(dxk, dxp), tol)
                        chk(f"KB3 {what} dx pad rows zero", float(dxk[:, K:].abs().max()), 0.0)
                        chk(f"KB3 {what} dy1", rel_max(dy1k, dy1p), tol)
                        chk(f"KB3 {what} d_alpha1", rel_max(da1k.sum(), da1p.sum()),
                            max(tol, TOL_ALPHA_F32))
                        again = tbb.tcn_bwd_dx(*xargs)
                        chk(f"KB3 {what} repeat", float(sum(not torch.equal(u, v) for u, v in
                                                            zip((dxk, dy1k, da1k), again))), 0.0)
    finally:
        tb._sm_count = tbb._sm_count = real[0]
        tb._resident, tbb._resident = real[1:]
    torch.cuda.synchronize()
    chk.done()


def dw_checks(chk, what, fargs, g, out_wt, g2, tol):
    """K2 (both modes) and KB2 against their plain versions at one shape:
    NaN in the rows >= K of K2's y1 and KB2's c and dz (never read), db's
    rows >= K exact zeros, two launches equal bytes."""
    from convtasnet_torch.ops.kernels import tcn_block as tb, tcn_block_bwd as tbb
    from convtasnet_torch.ops.kernels.limits import BWD_MAX_SPAN, BWD_MAXP

    y1, s1, a1, g1, b1, w, a2, norm, d, causal, K = fargs
    red = (1,) if norm == "gLN" else (2,)
    kargs = (nan_pad(y1, K),) + fargs[1:]
    ep, s2p, cp = tb.dwconv_plain(*fargs, save=True)
    ek, s2k = tb.tcn_dwconv(*kargs)
    chk(f"K2 {what} d={d} e, NaN in y1's rows >= K", rel_max(ek, ep), tol)
    chk(f"K2 {what} d={d} stats", rel_max(s2k.sum(red), s2p.sum(red)), tol)
    got = tb.tcn_dwconv(*kargs, save=True)
    chk(f"K2 save {what} d={d} c", rel_max(got[2], cp), tol)
    chk(f"K2 save {what} d={d} e and stats as inference",
        float(not (torch.equal(got[0], ek) and torch.equal(got[1], s2k))), 0.0)
    chk(f"K2 save {what} d={d} repeat", float(sum(not torch.equal(u, v) for u, v in zip(
        got, tb.tcn_dwconv(*kargs, save=True)))), 0.0)
    P = w.shape[0]
    if P > BWD_MAXP or (P - 1) * d > BWD_MAX_SPAN:
        return
    dz, _, gs2 = tbb.bwd_dz_plain(g, out_wt, cp, s2p, a2, g2, norm, K)
    tail = (s2p, gs2, a1, g1, b1, w, a2, g2, norm, d, causal, K)
    want = tbb.bwd_dwconv_plain(y1, cp, dz, s1, *tail)
    nargs = (y1, nan_pad(cp, K), nan_pad(dz, K), s1) + tail
    got = tbb.tcn_bwd_dwconv(*nargs)
    chk(f"KB2 {what} d={d} db, NaN in c's and dz's rows >= K", rel_max(got[0], want[0]), tol)
    chk(f"KB2 {what} d={d} db pad rows zero", float(got[0][:, K:].abs().max()), 0.0)
    chk(f"KB2 {what} d={d} dw/dg1/db1", rel_max(got[1].sum(0), want[1].sum(0)), tol)
    chk(f"KB2 {what} d={d} norm1 sums", rel_max(got[2].sum(red), want[2].sum(red)), tol)
    chk(f"KB2 {what} d={d} d_alpha2", rel_max(got[3].sum(), want[3].sum()),
        max(tol, TOL_ALPHA_F32))
    chk(f"KB2 {what} d={d} repeat", float(sum(not torch.equal(u, v) for u, v in zip(
        got, tbb.tcn_bwd_dwconv(*nargs)))), 0.0)


def span_limit_phase(dev, M=2, B=128, H=512):
    """K2 and KB2 at the largest spans and taps the limits admit
    (ops/kernels/limits.py): K2 span 4096 (P=3, d=2048), KB2 span 1024 (P=3,
    d=512) and 8 taps (d=128), f32 and bf16, gLN non-causal and cLN causal,
    with K = 2 * span + 99 (not a multiple of any tile's rows)."""
    from convtasnet_torch.ops.kernels import tcn_block as tb
    from convtasnet_torch.ops.kernels.limits import BWD_MAX_SPAN, BWD_MAXP, DWCONV_MAX_SPAN

    chk = Checks("span-limit phase")
    log("span-limit phase (K2 / KB2 vs plain at the limits):")
    for P, d in ((3, DWCONV_MAX_SPAN // 2), (3, BWD_MAX_SPAN // 2), (BWD_MAXP, 128)):
        span = (P - 1) * d
        K = 2 * span + 99
        Kp = -(-K // tb.ROW_ALIGN) * tb.ROW_ALIGN
        gen = torch.Generator(device=dev).manual_seed(P * d)

        def rnd(*shape, scale=1.0, shift=0.0):
            return torch.randn(shape, generator=gen, device=dev) * scale + shift

        in_w, out_w = rnd(B, H, scale=0.1), rnd(H, B, scale=0.1)
        a1 = a2 = torch.full((1,), 0.25, device=dev)
        g1, b1, g2 = rnd(H, scale=0.1, shift=1.0), rnd(H, scale=0.1), rnd(H, scale=0.1, shift=1.0)
        w = rnd(P, H, scale=0.3)
        x32 = rnd(M, Kp, B)
        x32[:, K:] = 0
        g32 = rnd(M, Kp, B)
        for dt in (torch.float32, torch.bfloat16):
            tol = TOL_F32 if dt == torch.float32 else TOL_BF16
            for norm, causal in (("gLN", False), ("cLN", True)):
                y1, s1 = tb.in_gemm_plain(x32.to(dt), in_w.to(dt), a1, norm)
                what = f"{'f32' if dt == torch.float32 else 'bf16'} {norm} causal={causal} P={P}"
                dw_checks(chk, what, (y1, s1, a1, g1, b1, w, a2, norm, d, causal, K), g32.to(dt),
                          out_w.to(dt).t().contiguous(), g2, tol)
    torch.cuda.synchronize()
    chk.done()


def nan_pad(t, K):
    """A copy of t with its rows >= K (per item) set to NaN."""
    t = t.clone()
    t[:, K:] = float("nan")
    return t


def train_kernel_phase(blocks, stacked, cfg, dev, M=5, K=3199):
    """Training kernels against their plain versions; returns the bf16
    max |kernel - plain| of each."""
    from convtasnet_torch.ops.kernels import tcn_block as tb, tcn_block_bwd as tbb
    from convtasnet_torch.ops.kernels.whole_block_hybrid import whole_block_hybrid
    from convtasnet_torch.ops.kernels.whole_block_vjp import whole_block_train
    from convtasnet_torch.ops.kernels.whole_tcn import PLAIN_STAGES
    from convtasnet_torch.ops.kernels.whole_tcn_hybrid import chain_save, whole_tcn_bwd

    B = cfg.B
    Kp = -(-K // tb.ROW_ALIGN) * tb.ROW_ALIGN
    gen = torch.Generator(device=dev).manual_seed(11)
    x32 = torch.randn((M, Kp, B), generator=gen, device=dev)
    x32[:, K:] = 0
    g32 = torch.randn((M, Kp, B), generator=gen, device=dev)  # pad rows must be ignored
    chk = Checks("training kernel phase")
    errs = {n: 0.0 for n in TRAIN_KERNELS}

    def err(name, k, p, dt):
        if dt == torch.bfloat16:
            errs[name] = max(errs[name], float((k.float() - p.float()).abs().max()))

    log("training kernel phase (kernel vs plain version):")
    nb = 3
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL_F32 if dt == torch.float32 else TOL_BF16
        tag = "f32" if dt == torch.float32 else "bf16"
        x, g = x32.to(dt), g32.to(dt)
        in_w, out_w = blocks["in_w"][nb].to(dt), blocks["out_w"][nb].to(dt)
        in_wt, out_wt = in_w.t().contiguous(), out_w.t().contiguous()
        a1, g1, b1, w, a2, g2, b2 = (blocks[k][nb] for k in (
            "in_prelu", "in_gamma", "in_beta", "dw_w", "dw_prelu", "dw_gamma", "dw_beta"))
        for norm in ("gLN", "cLN"):
            red = (1,) if norm == "gLN" else (2,)
            y1, s1 = tb.in_gemm_plain(x, in_w, a1, norm)
            for causal in (False, True):
                for xi in range(cfg.X):
                    d = 2 ** xi
                    what = f"{tag} {norm} causal={causal} d={d}"
                    args = (y1, s1, a1, g1, b1, w, a2, norm, d, causal, K)
                    _, s2k, ck = tb.tcn_dwconv(*args, save=True)
                    _, s2, c = tb.dwconv_plain(*args, save=True)
                    chk(f"K2 save {what} c", rel_max(ck, c), tol)
                    chk(f"K2 save {what} stats", rel_max(s2k.sum(red), s2.sum(red)), tol)
                    err("tcn_dwconv_save", ck, c, dt)
                    dz, colp, gs2 = tbb.bwd_dz_plain(g, out_wt, c, s2, a2, g2, norm, K)
                    ends = xi in (0, cfg.X - 1)
                    if ends:
                        dzk, colk, gs2k = tbb.tcn_bwd_dz(g, out_wt, c, s2, a2, g2, norm, K)
                        chk(f"KB1 {what} dz", rel_max(dzk, dz), tol)
                        chk(f"KB1 {what} dg2/db2", rel_max(colk.sum(0), colp.sum(0)), tol)
                        chk(f"KB1 {what} norm2 sums", rel_max(gs2k.sum(red), gs2.sum(red)), tol)
                        chk(f"KB1 {what} dz pad rows zero", float(dzk[:, K:].abs().max()), 0.0)
                        nargs = (nan_pad(g, K), out_wt, nan_pad(c, K), s2, a2, g2, norm, K)
                        dzn = tbb.tcn_bwd_dz(*nargs)
                        chk(f"KB1 {what} NaN in g's and c's rows >= K", max(
                            rel_max(dzn[0], dz), rel_max(dzn[1].sum(0), colp.sum(0)),
                            rel_max(dzn[2].sum(red), gs2.sum(red))), tol)
                        chk(f"KB1 {what} repeat", float(sum(not torch.equal(u, v) for u, v in zip(
                            (dzk, colk, gs2k), tbb.tcn_bwd_dz(g, out_wt, c, s2, a2, g2, norm, K)))),
                            0.0)
                        err("tcn_bwd_dz", dzk, dz, dt)
                        z = (s2, a2, g2, b2, norm)
                        wk, wp = tbb.tcn_wgrad(c, g, K, z).sum(0), tbb.wgrad_plain(c, g, K, z).sum(0)
                        chk(f"KW {what} dout_w", rel_max(wk, wp), tol)
                        chk(f"KW {what} dout_w, g's rows >= K NaN",
                            rel_max(tbb.tcn_wgrad(c, nan_pad(g, K), K, z).sum(0), wp), tol)
                        err("tcn_wgrad_out", wk, wp, dt)
                    bargs = (y1, c, dz, s1, s2, gs2, a1, g1, b1, w, a2, g2, norm, d, causal, K)
                    # the kernel never reads c's and dz's rows >= K: NaN there
                    nargs = (y1, nan_pad(c, K), nan_pad(dz, K)) + bargs[3:]
                    dbk, chpk, gs1k, da2k = tbb.tcn_bwd_dwconv(*nargs)
                    db, chp, gs1, da2 = tbb.bwd_dwconv_plain(*bargs)
                    if dt == torch.bfloat16 and norm == "gLN" and not causal:
                        log(f"  tiles at d={d}: K2 {tuple(tb.dw_plan(cfg.P, d, cfg.H, 2)[:3])}, "
                            f"KB2 {tuple(tb.dw_plan(cfg.P, d, cfg.H, 2, True)[:3])} "
                            "(rows, channels, lanes)")
                    chk(f"KB2 {what} db, NaN in c's and dz's rows >= K", rel_max(dbk, db), tol)
                    chk(f"KB2 {what} db pad rows zero", float(dbk[:, K:].abs().max()), 0.0)
                    if ends:
                        chk(f"K2 save {what} repeat", float(sum(not torch.equal(u, v) for u, v in
                                                                zip((s2k, ck), tb.tcn_dwconv(
                                                                    *args, save=True)[1:]))), 0.0)
                        chk(f"KB2 {what} repeat", float(sum(not torch.equal(u, v) for u, v in zip(
                            (dbk, chpk, gs1k, da2k), tbb.tcn_bwd_dwconv(*nargs)))), 0.0)
                    chk(f"KB2 {what} dw/dg1/db1", rel_max(chpk.sum(0), chp.sum(0)), tol)
                    chk(f"KB2 {what} norm1 sums", rel_max(gs1k.sum(red), gs1.sum(red)), tol)
                    chk(f"KB2 {what} d_alpha2", rel_max(da2k.sum(), da2.sum()),
                        max(tol, TOL_ALPHA_F32))
                    err("tcn_bwd_dwconv", dbk, db, dt)
                    if ends:
                        xargs = (db, y1, in_wt, g, s1, gs1, a1, g1, norm, K)
                        dxk, dy1k, da1k = tbb.tcn_bwd_dx(*xargs)
                        dx, dy1, da1 = tbb.bwd_dx_plain(*xargs)
                        chk(f"KB3 {what} dx", rel_max(dxk, dx), tol)
                        chk(f"KB3 {what} dx pad rows zero", float(dxk[:, K:].abs().max()), 0.0)
                        chk(f"KB3 {what} dy1", rel_max(dy1k, dy1), tol)
                        chk(f"KB3 {what} d_alpha1", rel_max(da1k.sum(), da1.sum()),
                            max(tol, TOL_ALPHA_F32))
                        err("tcn_bwd_dx", dxk, dx, dt)
                        wk, wp = tbb.tcn_wgrad(x, dy1, K).sum(0), tbb.wgrad_plain(x, dy1, K).sum(0)
                        chk(f"KW {what} din_w", rel_max(wk, wp), tol)
                        chk(f"KW {what} din_w, dy1's rows >= K NaN",
                            rel_max(tbb.tcn_wgrad(x, nan_pad(dy1, K), K).sum(0), wp), tol)
                        chk(f"KW {what} repeat", float(not torch.equal(
                            tbb.tcn_wgrad(x, dy1, K), tbb.tcn_wgrad(x, dy1, K))), 0.0)
                        err("tcn_wgrad_in", wk, wp, dt)
        # The 32-block chain: save-form forward and the backward of every block.
        ctol = TOL_F32 if dt == torch.float32 else TOL_BWD_CHAIN_BF16
        for norm in ("gLN", "cLN"):
            for causal in (False, True):
                what = f"{tag} {norm} causal={causal}"
                want = chain_save(x, *stacked, norm, causal, cfg.X, K, PLAIN_STAGES)
                got = chain_save(x, *stacked, norm, causal, cfg.X, K)
                for name, a, b in zip(("out", "x_res", "c_res"), got, want):
                    chk(f"save-form chain {what} {name}", rel_l2(a, b),
                        TOL_F32 if dt == torch.float32 else TOL_CHAIN_BF16)
                _, x_res, c_res, s2 = want
                gw = whole_tcn_bwd(g, x_res, c_res, s2, *stacked, norm, causal, cfg.X, K,
                                   tb.in_gemm_plain, tbb.PLAIN_BWD)
                gk = whole_tcn_bwd(g, x_res, c_res, s2, *stacked, norm, causal, cfg.X, K)
                for name, a, b in zip(GRAD_NAMES, gk, gw):
                    chk(f"whole_tcn_bwd {what} {name}", rel_l2(a, b),
                        max(ctol, TOL_ALPHA_F32) if name in ("da1", "da2") else ctol)
                chk(f"whole_tcn_bwd {what} dx pad rows zero", float(gk[0][:, K:].abs().max()), 0.0)
        # Rows 4 and 5: one block at the smallest and the largest dilation.
        for op in (whole_block_train, whole_block_hybrid):
            for norm, d in (("gLN", 1), ("cLN", 2 ** (cfg.X - 1))):
                params = [t[nb] for t in stacked]
                res = []
                for plain in (False, True):
                    leaves = [x.clone().requires_grad_(True)] + [
                        p.clone().requires_grad_(True) for p in params]
                    out = op(*leaves, norm, d, cfg.causal, K, plain=plain)
                    res.append(torch.autograd.grad(out, leaves, g))
                for name, a, b in zip(GRAD_NAMES, *res):
                    chk(f"{op.__name__} {tag} {norm} d={d} {name}", rel_l2(a, b),
                        max(ctol, TOL_ALPHA_F32) if name in ("da1", "da2") else ctol)
    # Gradients repeat bit for bit.
    x, g = x32.to(torch.bfloat16), g32.to(torch.bfloat16)
    _, x_res, c_res, s2 = chain_save(x, *stacked, "gLN", False, cfg.X, K)
    a = whole_tcn_bwd(g, x_res, c_res, s2, *stacked, "gLN", False, cfg.X, K)
    b = whole_tcn_bwd(g, x_res, c_res, s2, *stacked, "gLN", False, cfg.X, K)
    chk("whole_tcn_bwd bf16 two runs, differing tensors",
        float(sum(not torch.equal(u, v) for u, v in zip(a, b))), 0.0)
    torch.cuda.synchronize()
    chk.done()
    return errs


def step_grads(params, state, cfg, mix, src, lens):
    """(loss, gradient leaves) of one training forward + backward."""
    from convtasnet_torch.models.conv_tasnet import forward
    from convtasnet_torch.ops.loss import cal_loss
    from convtasnet_torch.training.optim import tree_leaves, tree_map

    leaves_tree = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    est, _ = forward(leaves_tree, state, cfg, mix, train=True)
    loss = cal_loss(src, est, lens)[0]
    return float(loss.detach()), torch.autograd.grad(loss, tree_leaves(leaves_tree))


def per_step_launches(form, NB):
    """Kernel launches of one train step of `form` (see ops/kernels)."""
    bwd = {k: NB for k in ("tcn_bwd_dz", "tcn_wgrad_out", "tcn_bwd_dwconv", "tcn_bwd_dx",
                           "tcn_wgrad_in")}
    if form == "hybrid":
        return dict(tcn_in_gemm=2 * NB, tcn_dwconv=0, tcn_dwconv_save=NB,
                    tcn_out_gemm_fold=0, tcn_out_gemm_unfold=NB, **bwd)
    if form == "whole":
        return dict(tcn_in_gemm=2 * NB, tcn_dwconv=NB, tcn_dwconv_save=NB,
                    tcn_out_gemm_fold=0, tcn_out_gemm_unfold=NB, **bwd)
    return {}


def train_phase(cfg, dev, tmp):
    """The train CLI at the paper config and one train step of each form;
    returns (launch counts of the main path's run, step-time medians)."""
    import dataclasses

    from convtasnet_torch.cli.train import main as train_main
    from convtasnet_torch.data.dataset import AudioDataset
    from convtasnet_torch.data.synthetic import make_wav_dataset
    from convtasnet_torch.models.conv_tasnet import init_params
    from convtasnet_torch.training.checkpoint import load_checkpoint
    from convtasnet_torch.training.optim import Optimizer
    from convtasnet_torch.training.solver import make_train_step

    NB = cfg.R * cfg.X
    chk = Checks("train phase")
    tr = os.path.join(make_wav_dataset(os.path.join(tmp, "tr"), n_utts=10, min_sec=4.0,
                                       max_sec=4.0, seed=0, splits=("tr",)), "tr")
    cv = os.path.join(make_wav_dataset(os.path.join(tmp, "cv"), n_utts=4, min_sec=4.0,
                                       max_sec=4.0, seed=1, splits=("cv",)), "cv")
    steps, n_cv = 2, 4
    cv_launch = {"tcn_in_gemm": NB, "tcn_dwconv": NB, "tcn_out_gemm_fold": NB}
    base = ["--train_dir", tr, "--valid_dir", cv, "--batch_size", "5", "--device", str(dev),
            "--num_workers", "2", "--print_freq", "1", "--seed", "0",
            "--norm_type", cfg.norm_type, "--compute_dtype", cfg.compute_dtype]
    for k in ("N", "L", "B", "H", "P", "X", "R", "C"):
        base += [f"--{k}", str(getattr(cfg, k))]
    path_counts = {}
    for form in ("hybrid", "whole", "0"):
        folder = os.path.join(tmp, f"exp_{form}")
        reset_all_counts()
        t0 = time.perf_counter()
        out = train_main(base + ["--use_kernels", form, "--epochs", "1", "--checkpoint", "1",
                                 "--save_every_steps", "1", "--save_folder", folder])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_counts()
        path_counts[form] = counts
        log(f"train --use_kernels {form}: {out['steps']} steps + {n_cv} CV forwards in "
            f"{wall:.2f} s, tr_loss {out['tr_loss']}, cv_loss {out['cv_loss']}, launches {counts}")
        chk(f"train {form}: steps", abs(out["steps"] - steps), 0)
        chk(f"train {form}: losses finite",
            float(not np.all(np.isfinite(out["tr_loss"] + out["cv_loss"]))), 0)
        per = per_step_launches(form, NB)
        for k, v in counts.items():
            want = steps * per.get(k, 0) + (n_cv * cv_launch.get(k, 0) if form != "0" else 0)
            chk(f"train {form}: {k} launches", abs(v - want), 0)
        for name in ("epoch1.ckpt", "final.ckpt", "latest.ckpt"):
            ck = load_checkpoint(os.path.join(folder, name), dev)
            chk(f"train {form}: {name} has optimizer state",
                float(not ck["header"]["has_opt"]), 0)
    folder = os.path.join(tmp, "exp_hybrid")
    out = train_main(base + ["--use_kernels", "hybrid", "--epochs", "2", "--save_folder",
                             folder, "--continue_from", os.path.join(folder, "epoch1.ckpt")])
    log(f"train --continue_from epoch1.ckpt: {out['steps']} steps, history {out['history']}")
    chk("resume: one more epoch of steps", abs(out["steps"] - steps), 0)
    chk("resume: two epochs of losses", abs(len(out["tr_loss"]) - 2), 0)
    chk("resume: losses finite", float(not np.all(np.isfinite(out["tr_loss"]))), 0)

    # One train step of each form from the same seed and batch.
    batch = AudioDataset(tr, 5).load_batch(0)
    mix, lens, src = (torch.from_numpy(np.asarray(a)).to(dev)
                      for a in (batch.mixture, batch.lengths, batch.source))
    params, state = init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    for dtype, gtol, ltol in (("float32", TOL_GRAD_F32, TOL_LOSS_F32),
                              ("bfloat16", TOL_GRAD_BF16, TOL_LOSS_BF16)):
        ref_loss, ref = step_grads(params, state, dataclasses.replace(
            cfg, compute_dtype=dtype, use_kernels="0"), mix, src, lens)
        for form in ("hybrid", "whole"):
            c = dataclasses.replace(cfg, compute_dtype=dtype, use_kernels=form)
            loss, grads = step_grads(params, state, c, mix, src, lens)
            chk(f"step {dtype} {form}: loss vs eager ({loss:.5f} vs {ref_loss:.5f})",
                abs(loss - ref_loss) / max(abs(ref_loss), 1e-6), ltol)
            worst = max((rel_l2(a, b), i) for i, (a, b) in enumerate(zip(grads, ref)))
            chk(f"step {dtype} {form}: gradients vs eager autograd, worst leaf #{worst[1]} "
                "(relative L2)", worst[0], gtol)
    timing = {}
    for form in ("hybrid", "whole", "0"):
        c = dataclasses.replace(cfg, use_kernels=form)
        opt = Optimizer("adam", lr=1e-3)
        step = make_train_step(c, opt, 5.0)
        opt_state = opt.init(params)
        reset_all_counts()
        step(params, opt_state, state, mix, src, lens)
        torch.cuda.synchronize()
        counts = all_counts()
        for k, v in counts.items():
            chk(f"one {form} step: {k} launches", abs(v - per_step_launches(form, NB).get(k, 0)), 0)
        ms, n = forward_ms(lambda: step(params, opt_state, state, mix, src, lens), iters=10,
                           warm=2)
        timing[f"train_step_batch5_{form}_ms"] = ms
        timing[f"train_step_batch5_{form}_audio_s_per_s"] = 5 * 4.0 / (ms / 1e3)
        log(f"  train step batch 5 x 4 s, --use_kernels {form}: median {ms:.3f} ms of {n} "
            f"({5 * 4.0 / (ms / 1e3):.1f} audio-s/s)")
    torch.cuda.synchronize()
    chk.done()
    return path_counts["hybrid"], timing

def _band_noise(rng, n, lo, hi):
    """White noise band-passed to [lo, hi] Hz by an FFT mask, unit RMS."""
    f = np.fft.rfft(rng.standard_normal(n))
    hz = np.fft.rfftfreq(n, 1.0 / SR)
    x = np.fft.irfft(f * ((hz >= lo) & (hz <= hi)), n)
    return x / np.sqrt(np.mean(x * x))


def _write_eval_sets(tmp):
    """Two tt sets written with the port's own modules, manifested by its
    preprocess CLI: harmonic (data/synthetic, 6 utterances of 2.5-10 s,
    FLOAT wavs) and broadband (seeded band-passed noise sources mixed at
    0-5 dB, 4 utterances of 3-6 s, PCM_16 wavs). Returns {name: (manifest
    dir, utterances)}."""
    from convtasnet_torch.data.synthetic import make_wav_dataset
    from convtasnet_torch.data.wavio import write_wav

    sets = {}
    harm = os.path.join(tmp, "harmonic")
    make_wav_dataset(harm, n_utts=6, min_sec=2.5, max_sec=10.0, seed=11, splits=("tt",))
    broad = os.path.join(tmp, "broadband")
    rng = np.random.default_rng(12)
    for u in range(4):
        n = int(rng.uniform(3.0, 6.0) * SR)
        s1 = _band_noise(rng, n, 100.0, 3000.0)
        s2 = _band_noise(rng, n, 300.0, 3800.0) * 10 ** (-rng.uniform(0.0, 5.0) / 20)
        g = 0.9 / np.abs(s1 + s2).max()
        for name, x in (("mix", s1 + s2), ("s1", s1), ("s2", s2)):
            write_wav(os.path.join(broad, "wav", "tt", name, f"b{u}.wav"), g * x, SR)
    for name, root, n_utts in (("harmonic", harm, 6), ("broadband", broad, 4)):
        for split in ("tr", "cv"):  # preprocess manifests every split
            for spk in ("mix", "s1", "s2"):
                os.makedirs(os.path.join(root, "wav", split, spk), exist_ok=True)
        subprocess.run([sys.executable, "-m", "convtasnet_torch.cli.preprocess",
                        "--in-dir", os.path.join(root, "wav"),
                        "--out-dir", os.path.join(root, "manifests")],
                       check=True, timeout=120,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
        sets[name] = (os.path.join(root, "manifests", "tt"), n_utts)
    return sets


def _native_so_digests():
    import hashlib

    here = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for f in sorted(glob.glob(os.path.join(here, "native", "*.so"))):
        with open(f, "rb") as fh:
            out[f] = hashlib.sha256(fh.read()).hexdigest()
    return out


def evaluate_phase(cfg, dev, ckpt, tmp):
    """The evaluate CLI on the slice phase's paper-config checkpoint; returns
    its timings. Checks the counts and finite metrics, the launches per
    forward, the kernel forms' estimates against the eager chain's, device
    (f64) SDRi against host SDRi on the same estimates, and that the native
    decoder decoded every file without touching native/*.so."""
    from convtasnet_torch.cli.evaluate import build_parser, evaluate
    from convtasnet_torch.data import dataset as ds_mod
    from convtasnet_torch.ops.metrics import sdr_improvement
    from convtasnet_torch.ops.metrics_device import sdr_improvement_batch
    from convtasnet_torch.training.checkpoint import load_model

    chk = Checks("evaluate phase")
    NB = cfg.R * cfg.X
    so_before = _native_so_digests()
    sets = _write_eval_sets(tmp)
    want_launch = {"auto": ("tcn_in_gemm", "tcn_dwconv", "tcn_out_gemm_fold"),
                   "block": ("tcn_in_gemm", "tcn_dwconv", "tcn_out_gemm_unfold"), "0": ()}
    sdr_tol = {"broadband": TOL_SDR_BROADBAND_DB, "harmonic": TOL_SDR_HARMONIC_DB}
    timing, runs = {}, {}

    def run(name, form, backend):
        data_dir, n_utts = sets[name]
        reset_all_counts()
        ds_mod.reset_counts()
        utts, stamps = [], []

        def stamp(line):  # when each utterance's results reach the host
            if line.startswith("Utt "):
                stamps.append(time.perf_counter())

        t0 = time.perf_counter()
        res = evaluate(build_parser().parse_args(
            ["--model_path", ckpt, "--data_dir", data_dir, "--cal_sdr", "1",
             "--sdr_backend", backend, "--use_kernels", form, "--device", str(dev)]),
            log=stamp, utterances=utts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # Steady state: from the first utterance's results to the last's
        # (load_model, the loader's start and the first batch excluded).
        steady = (stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3
        counts, decoded = all_counts(), ds_mod.counts()
        tag = f"{name} --use_kernels {form} --sdr_backend {backend}"
        log(f"evaluate {tag}: SI-SNRi {res['si_snri']:.4f} dB, SDRi {res['sdri']:.4f} dB over "
            f"{res['count']} utterances in {wall:.2f} s ({wall / n_utts * 1e3:.1f} ms per "
            f"utterance, {steady:.1f} ms per utterance after the first); decoded {decoded}; "
            f"launches {counts}")
        chk(f"{tag}: count", abs(res["count"] - n_utts), 0)
        chk(f"{tag}: metrics finite", float(not all(np.isfinite(
            [res["si_snri"], res["sdri"]] + [u[k] for u in utts for k in ("si_snri", "sdri")]))), 0)
        for k, v in counts.items():
            chk(f"{tag}: {k} launches", abs(v - (NB * n_utts if k in want_launch[form] else 0)),
                0)
        chk(f"{tag}: native decoder decoded every file",
            abs(decoded["native"] - 3 * n_utts) + decoded["wavio"], 0)
        timing[f"{name}_{form}_{backend}_ms_per_utt"] = wall / n_utts * 1e3
        timing[f"{name}_{form}_{backend}_steady_ms_per_utt"] = steady
        runs[(name, form, backend)] = utts
        return utts

    # One-time set-up outside the timed runs: the cuFFT / cuSOLVER handles of
    # the device BSS-Eval, and the checkpoint load each run repeats.
    warm = torch.randn((1, 2, 4000), generator=torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    for dtype in (torch.float64, torch.float32):
        sdr_improvement_batch(warm, warm.flip(1), warm.sum(1), dtype=dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    load_model(ckpt, dev)
    torch.cuda.synchronize()
    timing["model_load_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"  load_model of the paper checkpoint: {timing['model_load_ms']:.1f} ms (in every "
        "evaluate run's wall time)")
    for name in ("harmonic", "broadband"):
        for form in ("auto", "block", "0"):
            run(name, form, "device")
        eager = np.concatenate([u["estimate"].ravel() for u in runs[(name, "0", "device")]])
        for form in ("auto", "block"):
            got = np.concatenate([u["estimate"].ravel() for u in runs[(name, form, "device")]])
            chk(f"{name}: reordered estimates --use_kernels {form} vs 0 (bf16, rel L2)",
                rel_l2(torch.from_numpy(got), torch.from_numpy(eager)), TOL_E2E_BF16)
        # Device (f64) SDRi against the host's on the main path's estimates.
        t0 = time.perf_counter()
        worst = max(abs(u["sdri"] - sdr_improvement(u["source"], u["estimate"], u["mixture"]))
                    for u in runs[(name, "auto", "device")])
        timing[f"{name}_host_bss_eval_ms_per_utt"] = (
            (time.perf_counter() - t0) / len(runs[(name, "auto", "device")]) * 1e3)
        chk(f"{name}: device (f64) vs host SDRi on the same estimates, worst utterance (dB)",
            worst, sdr_tol[name])
    host = run("broadband", "auto", "host")
    worst = max(abs(h["sdri"] - d["sdri"]) for h, d in zip(host, runs[("broadband", "auto",
                                                                          "device")]))
    chk("broadband: --sdr_backend host vs device SDRi, worst utterance (dB)", worst,
        TOL_SDR_BROADBAND_DB)

    # Device BSS-Eval alone, one utterance per call, f64 and f32.
    import warnings

    for name in ("broadband", "harmonic"):
        u = max(runs[(name, "auto", "device")], key=lambda u: u["mixture"].size)
        src, est, mix = (torch.from_numpy(np.ascontiguousarray(u[k]))[None].to(dev)
                         for k in ("source", "estimate", "mixture"))
        for dtype in (torch.float64, torch.float32):
            # No host synchronisation inside a call (the forward's enqueue
            # runs on past it): PyTorch's sync debug mode warns on each.
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    sdr_improvement_batch(src, est, mix, dtype=dtype)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs = [str(w.message)[:120] for w in caught
                     if "called a synchronizing" in str(w.message)]
            chk(f"device BSS-Eval {str(dtype)[6:]}: host synchronisations in one call "
                f"{syncs[:2]}", len(syncs), 0)
            ms, n = forward_ms(lambda: sdr_improvement_batch(src, est, mix, dtype=dtype),
                               iters=10, warm=2)
            key = f"{name}_device_bss_eval_{str(dtype)[6:]}_ms_per_utt"
            timing[key] = ms
            log(f"  device BSS-Eval {str(dtype)[6:]}, {name} utterance of "
                f"{u['mixture'].size / SR:.2f} s: median {ms:.3f} ms of {n}")
            if name == "broadband":
                # Where its device time goes, by operation (5 calls).
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        sdr_improvement_batch(src, est, mix, dtype=dtype)
                    torch.cuda.synchronize()
                ops = sorted(((e.self_device_time_total / 5 / 1e3, e.key)
                              for e in prof.key_averages()
                              if e.device_type == torch.autograd.DeviceType.CUDA),
                             reverse=True)
                busy = sum(t for t, _ in ops)
                timing[f"device_bss_eval_{str(dtype)[6:]}_device_busy_ms"] = busy
                log(f"    device busy {busy:.3f} ms per call; top: " + "; ".join(
                    f"{k[:60]} {t:.3f}" for t, k in ops[:6]))

    # Host decode per batch (evaluate's batch of one utterance), native and wavio.
    for name, (data_dir, n_utts) in sets.items():
        ds = ds_mod.AudioDataset(data_dir, 1, segment=-1, cv_maxlen=1e9)
        for native in (True, False):
            ds.disable_native = not native
            t0 = time.perf_counter()
            for i in range(len(ds)):
                ds.load_batch(i)
            ms = (time.perf_counter() - t0) / len(ds) * 1e3
            key = f"{name}_decode_{'native' if native else 'wavio'}_ms_per_batch"
            timing[key] = ms
            log(f"  host decode, {name}, {'native' if native else 'wavio'}: {ms:.2f} ms per "
                "batch of 1 utterance (3 files)")
    chk("native/*.so unchanged", float(_native_so_digests() != so_before), 0)
    log(f"evaluate phase timing: {json.dumps(timing)}")
    chk.done()
    return timing


def train_kernel_specs(blocks, cfg, dev, M=5, K=3199):
    """Timing specs of the training kernels at the main path's shapes (bf16)."""
    from convtasnet_torch.ops.kernels import tcn_block as tb, tcn_block_bwd as tbb

    B, H, P = cfg.B, cfg.H, cfg.P
    Kp = -(-K // tb.ROW_ALIGN) * tb.ROW_ALIGN
    dt, it, rows, nb = torch.bfloat16, 2, M * Kp, 3
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((M, Kp, B), generator=gen, device=dev)
    x[:, K:] = 0
    x = x.to(dt)
    g = torch.randn((M, Kp, B), generator=gen, device=dev).to(dt)
    in_w, out_w = blocks["in_w"][nb].to(dt), blocks["out_w"][nb].to(dt)
    in_wt, out_wt = in_w.t().contiguous(), out_w.t().contiguous()
    a1, g1, b1, w, a2, g2, b2 = (blocks[k][nb] for k in (
        "in_prelu", "in_gamma", "in_beta", "dw_w", "dw_prelu", "dw_gamma", "dw_beta"))
    norm = cfg.norm_type
    y1, s1 = tb.tcn_in_gemm(x, in_w, a1, norm)
    _, s2, c = tb.tcn_dwconv(y1, s1, a1, g1, b1, w, a2, norm, 1, cfg.causal, K, save=True)
    dz, colpart, gs2 = tbb.tcn_bwd_dz(g, out_wt, c, s2, a2, g2, norm, K)
    db, _, gs1, _ = tbb.tcn_bwd_dwconv(y1, c, dz, s1, s2, gs2, a1, g1, b1, w, a2, g2, norm, 1,
                                       cfg.causal, K)
    _, dy1, _ = tbb.tcn_bwd_dx(db, y1, in_wt, g, s1, gs1, a1, g1, norm, K)
    z = (s2, a2, g2, b2, norm)
    gemm = 2.0 * rows * B * H
    # KW's launch plans (Stage B: split partials summed inside clusters) and
    # Stage A of the same splits, one partial per CTA.
    plan_z, plan_in = tbb.wgrad_launch_plan(c, g, z), tbb.wgrad_launch_plan(x, dy1)
    log(f"KW plan at M={M} ({rows} rows): dout_w {tuple(plan_z)}, din_w {tuple(plan_in)} "
        "(splits, cluster, bn, tiles, partials); resident clusters (size, count) "
        f"{tbb._max_clusters(x.device.index, B)}")
    # The depthwise conv alone as one cuDNN call, [M, H, K_pad] layout made
    # outside the timed region: F.conv1d for K2's save mode, its transpose
    # for KB2 (values do not matter to the time).
    y1_t, dz_t = y1.transpose(1, 2).contiguous(), dz.transpose(1, 2).contiguous()
    w_t = w.t().contiguous().unsqueeze(1).to(dt)

    def conv(d, transpose=False):
        pad = (P - 1) * d if cfg.causal else (P - 1) * d // 2
        if transpose:
            F.conv_transpose1d(dz_t, w_t, groups=H, dilation=d, padding=pad)
        else:
            F.conv1d(y1_t, w_t, groups=H, dilation=d, padding=pad)

    def per_dilation(fn, **kw):
        def run():
            for xi in range(cfg.X):
                fn(2 ** xi, **kw)
        return run

    def dws(d, plain=False):
        f = tb.dwconv_plain if plain else tb.tcn_dwconv
        f(y1, s1, a1, g1, b1, w, a2, norm, d, cfg.causal, K, save=True)

    def kb2(d, plain=False):
        f = tbb.bwd_dwconv_plain if plain else tbb.tcn_bwd_dwconv
        f(y1, c, dz, s1, s2, gs2, a1, g1, b1, w, a2, g2, norm, d, cfg.causal, K)

    def kb2_chpart(d):
        return rows // tb.dw_plan(P, d, H, it, backward=True).rows * (P + 2) * H * 4

    return {
        "tcn_dwconv_save": dict(
            source=SOURCE_DW, replaces=WHOLE_TCN, kernel=per_dilation(dws),
            plain=per_dilation(dws, plain=True), library=per_dilation(conv), per=cfg.X,
            per_d=dict(kernel=dws, library=conv, plan=lambda d: tb.dw_plan(P, d, H, it)),
            bytes=3 * rows * H * it + (s1.numel() + s2.numel()) * 4 + (P + 2) * H * 4,
            flops=rows * H * (2.0 * P + 12)),
        "tcn_bwd_dz": dict(
            source=SOURCE_BWD, replaces=BWD_BLOCK,
            kernel=lambda: tbb.tcn_bwd_dz(g, out_wt, c, s2, a2, g2, norm, K),
            plain=lambda: tbb.bwd_dz_plain(g, out_wt, c, s2, a2, g2, norm, K),
            library=lambda: torch.matmul(g.view(rows, B), out_wt),
            bytes=(rows * B + B * H + 2 * rows * H) * it
            + (s2.numel() + colpart.numel() + gs2.numel()) * 4 + 2 * H * 4,
            flops=gemm, per=1),
        "tcn_wgrad_out": dict(
            source=SOURCE_KW, replaces=BWD_BLOCK,
            kernel=lambda: tbb.tcn_wgrad(c, g, K, z).sum(0),
            plain=lambda: tbb.wgrad_plain(c, g, K, z).sum(0),
            stage_a=lambda: tbb.tcn_wgrad(c, g, K, z, plan=(plan_z.splits, 1)).sum(0),
            library=lambda: torch.matmul(c.view(rows, H).t(), g.view(rows, B)),
            bytes=rows * (B + H) * it + H * B * 4, flops=gemm, per=1),
        "tcn_bwd_dwconv": dict(
            source=SOURCE_DW, replaces=BWD_BLOCK, kernel=per_dilation(kb2),
            plain=per_dilation(kb2, plain=True), library=per_dilation(conv, transpose=True),
            per=cfg.X,
            # the bound is the work's bytes; the f32 channel partials the
            # tile writes (and block_bwd sums back) are logged beside it
            per_d=dict(kernel=kb2, library=lambda d: conv(d, transpose=True),
                       plan=lambda d: tb.dw_plan(P, d, H, it, backward=True),
                       chpart_bytes=kb2_chpart),
            bytes=4 * rows * H * it + (s1.numel() + s2.numel() + gs2.numel()) * 4
            + (2 * P + 4) * H * 4, flops=rows * H * (4.0 * P + 30)),
        "tcn_bwd_dx": dict(
            source=SOURCE_BWD, replaces=BWD_BLOCK,
            kernel=lambda: tbb.tcn_bwd_dx(db, y1, in_wt, g, s1, gs1, a1, g1, norm, K),
            plain=lambda: tbb.bwd_dx_plain(db, y1, in_wt, g, s1, gs1, a1, g1, norm, K),
            library=lambda: torch.matmul(dy1.view(rows, H), in_wt),
            bytes=(3 * rows * H + 2 * rows * B + H * B) * it + (s1.numel() + gs1.numel()) * 4,
            flops=gemm, per=1),
        "tcn_wgrad_in": dict(
            source=SOURCE_KW, replaces=BWD_BLOCK,
            kernel=lambda: tbb.tcn_wgrad(x, dy1, K).sum(0),
            plain=lambda: tbb.wgrad_plain(x, dy1, K).sum(0),
            stage_a=lambda: tbb.tcn_wgrad(x, dy1, K, plan=(plan_in.splits, 1)).sum(0),
            library=lambda: torch.matmul(x.view(rows, B).t(), dy1.view(rows, H)),
            bytes=rows * (B + H) * it + B * H * 4, flops=gemm, per=1),
    }


def backward_timing(stacked, cfg, dev, M=5, K=3199):
    """ms of the backward of the three training ops at the main path's
    shapes (bf16, gLN, dilation 1 for the per-block ones), beside their
    plain versions: row 3 over all NB blocks, rows 4 and 5 for one block."""
    from convtasnet_torch.ops.kernels import tcn_block as tb, tcn_block_bwd as tbb
    from convtasnet_torch.ops.kernels.whole_block_hybrid import hybrid_bwd_math
    from convtasnet_torch.ops.kernels.whole_block_vjp import recompute_bwd
    from convtasnet_torch.ops.kernels.whole_tcn_hybrid import chain_save, whole_tcn_bwd

    Kp = -(-K // tb.ROW_ALIGN) * tb.ROW_ALIGN
    dt, norm = torch.bfloat16, "gLN"
    gen = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn((M, Kp, cfg.B), generator=gen, device=dev)
    x[:, K:] = 0
    x = x.to(dt)
    g = torch.randn((M, Kp, cfg.B), generator=gen, device=dev).to(dt)
    _, x_res, c_res, s2 = chain_save(x, *stacked, norm, False, cfg.X, K)
    one = [t[0] for t in stacked]
    in_w, a1 = one[0].to(dt), one[1]
    y1, s1 = tb.tcn_in_gemm(x, in_w, a1, norm)
    _, _, c = tb.tcn_dwconv(y1, s1, a1, *one[2:6], norm, 1, False, K, save=True)
    runs = {
        "bwd_chain_hybrid": lambda: whole_tcn_bwd(g, x_res, c_res, s2, *stacked, norm, False,
                                                  cfg.X, K),
        "bwd_chain_hybrid_plain": lambda: whole_tcn_bwd(g, x_res, c_res, s2, *stacked, norm,
                                                        False, cfg.X, K, tb.in_gemm_plain,
                                                        tbb.PLAIN_BWD),
        "bwd_block_whole": lambda: recompute_bwd(g, x, *one, norm, 1, False, K),
        "bwd_block_whole_plain": lambda: recompute_bwd(g, x, *one, norm, 1, False, K,
                                                       plain=True),
        "bwd_block_hybrid_torch": lambda: hybrid_bwd_math(x, y1, c, g, *one, norm, 1, False, K),
    }
    out = {f"{k}_ms": cuda_ms(fn, iters=5, warm=1) for k, fn in runs.items()}
    for k, v in out.items():
        log(f"  {k}: {v:.3f} ms at M={M}, K_pad={Kp}, bf16")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    from convtasnet_torch.config import ConvTasNetConfig
    from convtasnet_torch.data.wavio import read_wav, write_wav
    from convtasnet_torch.models.conv_tasnet import forward, init_params
    from convtasnet_torch.ops.kernels import _build, tcn_block as tb
    from convtasnet_torch.ops.kernels.whole_block import whole_block
    from convtasnet_torch.ops.kernels.whole_tcn import (PLAIN_STAGES, alloc_scratch,
                                                        tcn_chain, whole_tcn,
                                                        whole_tcn_reference)
    from convtasnet_torch.training.checkpoint import save_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- build ----------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all(["tcn_block", "tcn_block_bwd"])
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")
    from convtasnet_torch.ops.kernels import tcn_block_bwd as tbb

    idx = torch.cuda.current_device()
    modes = (("K3 fold", tb, tb.H_FOLD), ("K3 unfold", tb, tb.H_UNFOLD), ("K1", tb, tb.H_IN),
             ("KB3", tbb, tb.H_DX), ("KB1", tbb, tb.H_DZ))
    occ = {name: {f"{bm}x{bn}": r for (bm, bn), r in mod._resident(idx, mode)}
           for name, mod, mode in modes}
    log(f"wgmma template, CTAs resident per SM by tile: {json.dumps(occ)}")
    for rows in (8 * 3200, 5 * 3200, 3200):
        log(f"  plans at {rows} rows (B=256, H=512): "
            f"K1 {tb.gemm_plan(rows, 512, 256, tb._sm_count(idx), io_tiles=1, resident=tb._resident(idx, tb.H_IN))}, "
            f"K3 {tb.gemm_plan(rows, 256, 512, tb._sm_count(idx), resident=tb._resident(idx, tb.H_FOLD))}, "
            f"KB1 {tb.gemm_plan(rows, 512, 256, tb._sm_count(idx), resident=tbb._resident(idx, tb.H_DZ))}, "
            f"KB3 {tb.gemm_plan(rows, 256, 512, tb._sm_count(idx), split=False, resident=tbb._resident(idx, tb.H_DX))}")

    cfg = ConvTasNetConfig()  # the paper config
    NB, B, H, P = cfg.R * cfg.X, cfg.B, cfg.H, cfg.P
    gen = torch.Generator(device=dev).manual_seed(1234)
    params, state = init_params(gen, cfg, device=dev)
    blocks = {k: v.reshape((NB,) + tuple(v.shape[2:]))
              for k, v in params["separator"]["blocks"].items()}
    order = ("in_w", "in_prelu", "in_gamma", "in_beta", "dw_w", "dw_prelu",
             "dw_gamma", "dw_beta", "out_w")
    stacked = [blocks[k] for k in order]

    # ---- kernel phase -----------------------------------------------------
    M, K = 8, 3199                     # batch 8 of 4 s at 8 kHz
    Kp = -(-K // tb.ROW_ALIGN) * tb.ROW_ALIGN
    x_rng = torch.Generator(device=dev).manual_seed(7)
    x32 = torch.randn((M, Kp, B), generator=x_rng, device=dev)
    x32[:, K:] = 0
    chk = Checks("kernel phase")
    errs = {n: 0.0 for n in ("tcn_in_gemm", "tcn_dwconv", "tcn_out_gemm_fold",
                             "tcn_out_gemm_unfold")}
    log("kernel phase (kernel vs plain version):")
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL_F32 if dt == torch.float32 else TOL_BF16
        tag = "f32" if dt == torch.float32 else "bf16"
        x = x32.to(dt)
        nb = 3
        in_w = blocks["in_w"][nb].to(dt)
        a1, a2 = blocks["in_prelu"][nb], blocks["dw_prelu"][nb]
        for norm in ("gLN", "cLN"):
            y1k, s1k = tb.tcn_in_gemm(x, in_w, a1, norm)
            y1p, s1p = tb.in_gemm_plain(x, in_w, a1, norm)
            red = (1,) if norm == "gLN" else (2,)
            e1 = rel_max(y1k, y1p)
            chk(f"K1 {tag} {norm} y1", e1, tol)
            chk(f"K1 {tag} {norm} stats", rel_max(s1k.sum(red), s1p.sum(red)), tol)
            chk(f"K1 {tag} {norm} pad rows zero", float(y1k[:, K:].abs().max()), 0.0)
            chk(f"K1 {tag} {norm} repeat", float(sum(not torch.equal(u, v) for u, v in zip(
                (y1k, s1k), tb.tcn_in_gemm(x, in_w, a1, norm)))), 0.0)
            if dt == torch.bfloat16:
                errs["tcn_in_gemm"] = max(errs["tcn_in_gemm"], float((y1k.float() - y1p.float()).abs().max()))
            for causal in (False, True):
                for xi in range(cfg.X):
                    d = 2 ** xi
                    args = (y1k, s1k, a1, blocks["in_gamma"][nb], blocks["in_beta"][nb],
                            blocks["dw_w"][nb], a2, norm, d, causal, K)
                    ek, s2k = tb.tcn_dwconv(*args)
                    ep, s2p = tb.dwconv_plain(*args)
                    chk(f"K2 {tag} {norm} causal={causal} d={d} e", rel_max(ek, ep), tol)
                    chk(f"K2 {tag} {norm} causal={causal} d={d} stats",
                        rel_max(s2k.sum(red), s2p.sum(red)), tol)
                    if dt == torch.bfloat16:
                        errs["tcn_dwconv"] = max(errs["tcn_dwconv"], float((ek.float() - ep.float()).abs().max()))
            for fold in (True, False):
                if fold:
                    wp, ga, gb = tb.fold_weights(blocks["out_w"][nb], blocks["dw_gamma"][nb],
                                                 blocks["dw_beta"][nb], dt)
                else:
                    wp, ga, gb = (blocks["out_w"][nb].to(dt), blocks["dw_gamma"][nb],
                                  blocks["dw_beta"][nb])
                ok_ = tb.tcn_out_gemm(ek, s2k, x, wp, ga, gb, norm, K, fold)
                op_ = tb.out_gemm_plain(ek, s2k, x, wp, ga, gb, norm, K, fold)
                name = "tcn_out_gemm_fold" if fold else "tcn_out_gemm_unfold"
                chk(f"K3 {tag} {norm} {'fold' if fold else 'unfold'}", rel_max(ok_, op_), tol)
                chk(f"K3 {tag} {norm} pad rows zero", float(ok_[:, K:].abs().max()), 0.0)
                if dt == torch.bfloat16:
                    errs[name] = max(errs[name], float((ok_.float() - op_.float()).abs().max()))
        # Both 32-block chains, every dilation in scan order.
        for norm in ("gLN", "cLN"):
            for causal in (False, True):
                want = whole_tcn_reference(x, *stacked, norm, causal, cfg.X, valid_k=K)
                got = whole_tcn(x, *stacked, norm, causal, cfg.X, valid_k=K)
                ctol = TOL_F32 if dt == torch.float32 else TOL_CHAIN_BF16
                chk(f"whole_tcn chain {tag} {norm} causal={causal}", rel_l2(got, want), ctol)
                wantb = tcn_chain(x, *stacked, norm, causal,
                                  [2 ** (i % cfg.X) for i in range(NB)], K, False,
                                  PLAIN_STAGES)
                gotb = x.clone()
                scratch = alloc_scratch(M, Kp, H, dt, dev)
                for i in range(NB):
                    gotb = whole_block(gotb, *[t[i] for t in stacked], norm,
                                       2 ** (i % cfg.X), causal, valid_k=K,
                                       scratch=scratch)
                chk(f"whole_block chain {tag} {norm} causal={causal}", rel_l2(gotb, wantb), ctol)
                chk(f"chains {tag} {norm} causal={causal} pad rows zero",
                    float(got[:, K:].abs().max() + gotb[:, K:].abs().max()), 0.0)
    torch.cuda.synchronize()
    chk.done()

    gemm_width_phase(dev)
    span_limit_phase(dev)

    # ---- training kernel phase ---------------------------------------------
    train_errs = train_kernel_phase(blocks, stacked, cfg, dev)

    # ---- slice phase: the separate CLI ------------------------------------
    from convtasnet_torch.cli.separate import main as separate_main

    chk = Checks("slice phase")
    path_counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "paper.ckpt")
        save_checkpoint(ckpt, cfg, params, state)
        mix_dir = os.path.join(tmp, "mix")
        rng = np.random.default_rng(0)
        secs = [4.0] * 8 + [2.5, 7.3, 10.0]
        for i, s in enumerate(secs):
            n = int(s * SR)
            t = np.arange(n) / SR
            sig = (0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t)
                   + 0.2 * np.sin(2 * np.pi * (900 + 75 * i) * t)
                   + 0.05 * rng.normal(size=n))
            write_wav(os.path.join(mix_dir, f"utt{i:02d}.wav"), sig, SR)
        n_forwards = -(-len(secs) // 8)
        outs = {}
        for form in ("auto", "block", "0"):
            out_dir = os.path.join(tmp, f"out_{form}")
            tb.reset_counts()
            t0 = time.perf_counter()
            written = separate_main(["--model_path", ckpt, "--mix_dir", mix_dir,
                                     "--out_dir", out_dir, "--batch_size", "8",
                                     "--use_kernels", form, "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = tb.counts()
            path_counts[form] = counts
            log(f"separate --use_kernels {form}: {written} mixtures in {wall:.2f} s, "
                f"launches {counts}")
            chk(f"{form}: mixtures written", abs(written - len(secs)), 0)
            want = {"auto": dict(tcn_in_gemm=1, tcn_dwconv=1, tcn_out_gemm_fold=1,
                                 tcn_out_gemm_unfold=0),
                    "block": dict(tcn_in_gemm=1, tcn_dwconv=1, tcn_out_gemm_fold=0,
                                  tcn_out_gemm_unfold=1),
                    "0": {k: 0 for k in counts}}[form]
            for k, per in want.items():
                chk(f"{form}: {k} launches == NB per forward",
                    abs(counts[k] - per * NB * n_forwards), 0)
            outs[form] = {}
            for i in range(len(secs)):
                for c in range(cfg.C):
                    f = os.path.join(out_dir, f"utt{i:02d}_s{c + 1}.wav")
                    y, _ = read_wav(f)
                    chk(f"{form}: {os.path.basename(f)} length",
                        abs(len(y) - int(secs[i] * SR)), 0)
                    chk(f"{form}: {os.path.basename(f)} finite",
                        float(not np.all(np.isfinite(y))), 0)
                    outs[form][f] = y
            chk(f"{form}: wav count", abs(len(glob.glob(os.path.join(out_dir, "*.wav")))
                                          - 3 * len(secs)), 0)
        for form in ("auto", "block"):
            a = np.concatenate([outs[form][f.replace("out_0", f"out_{form}")]
                                for f in sorted(outs["0"])])
            b = np.concatenate([outs["0"][f] for f in sorted(outs["0"])])
            chk(f"separations --use_kernels {form} vs 0 (bf16, rel L2)",
                rel_l2(torch.from_numpy(a), torch.from_numpy(b)), TOL_E2E_BF16)

        # f32 forward on a short input: kernel forms against the eager chain.
        mix = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 8000))
                               .astype(np.float32)).to(dev)
        with torch.inference_mode():
            outs32 = {}
            for form in ("auto", "block", "0"):
                c32 = ConvTasNetConfig(compute_dtype="float32", use_kernels=form)
                outs32[form], _ = forward(params, state, c32, mix)
                chk(f"f32 forward {form} shape", float(outs32[form].shape != (2, 2, 8000)), 0)
            for form in ("auto", "block"):
                chk(f"f32 forward {form} vs eager (rel L2)",
                    rel_l2(outs32[form], outs32["0"]), TOL_E2E_F32)
        chk.done()

        # ---- evaluate phase: the evaluate CLI on the slice's checkpoint -----
        log("evaluate phase:")
        eval_timing = evaluate_phase(cfg, dev, ckpt, tmp)

    # ---- train phase: the train CLI and one step of each form ---------------
    log("train phase:")
    with tempfile.TemporaryDirectory() as tmp:
        train_counts, train_timing = train_phase(cfg, dev, tmp)

    # ---- timing -------------------------------------------------------------
    log("timing (CUDA events, after warm-up):")
    latency = {}
    with torch.inference_mode():
        for bs in (8, 1):
            mix = torch.from_numpy(np.random.default_rng(bs).normal(size=(bs, 4 * SR))
                                   .astype(np.float32)).to(dev)
            for form in ("auto", "block", "0"):
                c = ConvTasNetConfig(use_kernels=form)
                ms, n = forward_ms(lambda: forward(params, state, c, mix))
                latency[f"batch{bs}_{form}_ms"] = ms
                log(f"  forward batch {bs} x 4 s, --use_kernels {form}: median {ms:.3f} ms "
                    f"of {n}")

    dt = torch.bfloat16
    x = x32.to(dt)
    nb = 3
    in_w = blocks["in_w"][nb].to(dt)
    a1, a2 = blocks["in_prelu"][nb], blocks["dw_prelu"][nb]
    norm = cfg.norm_type
    y1, s1 = tb.tcn_in_gemm(x, in_w, a1, norm)
    e, s2 = tb.tcn_dwconv(y1, s1, a1, blocks["in_gamma"][nb], blocks["in_beta"][nb],
                          blocks["dw_w"][nb], a2, norm, 1, cfg.causal, K)
    wp, ga, gb = tb.fold_weights(blocks["out_w"][nb], blocks["dw_gamma"][nb],
                                 blocks["dw_beta"][nb], dt)
    ow = blocks["out_w"][nb].to(dt)
    out = torch.empty_like(x)
    rows, it = M * Kp, 2

    def dw_one(fn, d):
        fn(y1, s1, a1, blocks["in_gamma"][nb], blocks["in_beta"][nb], blocks["dw_w"][nb], a2,
           norm, d, cfg.causal, K)

    def dw_all(fn):
        # One launch per dilation of a repeat (the chain's mix of halos).
        def run():
            for xi in range(cfg.X):
                dw_one(fn, 2 ** xi)
        return run

    # K2's conv alone: one cuDNN depthwise F.conv1d per dilation on a
    # [M, H, K_pad] copy made outside the timed region.
    y1_t = y1.transpose(1, 2).contiguous()
    w_t = blocks["dw_w"][nb].t().contiguous().unsqueeze(1).to(dt)

    def conv_one(d):
        F.conv1d(y1_t, w_t, groups=H, dilation=d,
                 padding=(P - 1) * d if cfg.causal else (P - 1) * d // 2)

    def conv_all():
        for xi in range(cfg.X):
            conv_one(2 ** xi)

    gemm_flops = 2.0 * rows * B * H
    specs = {
        "tcn_in_gemm": dict(
            replaces=WHOLE_TCN,
            kernel=lambda: tb.tcn_in_gemm(x, in_w, a1, norm, y1),
            plain=lambda: tb.in_gemm_plain(x, in_w, a1, norm),
            library=lambda: torch.matmul(x.view(rows, B), in_w),
            bytes=(rows * B + B * H + rows * H) * it + s1.numel() * 4,
            flops=gemm_flops, per=1),
        "tcn_dwconv": dict(
            replaces=WHOLE_TCN, source=SOURCE_DW,
            kernel=dw_all(tb.tcn_dwconv), plain=dw_all(tb.dwconv_plain), library=conv_all,
            per_d=dict(kernel=lambda d: dw_one(tb.tcn_dwconv, d), library=conv_one,
                       plan=lambda d: tb.dw_plan(P, d, H, it)),
            bytes=(2 * rows * H * it + s1.numel() * 4 + s2.numel() * 4 + (P + 2) * H * 4),
            flops=rows * H * (2.0 * P + 12), per=cfg.X),
        "tcn_out_gemm_fold": dict(
            replaces=WHOLE_TCN,
            kernel=lambda: tb.tcn_out_gemm(e, s2, x, wp, ga, gb, norm, K, True, out),
            plain=lambda: tb.out_gemm_plain(e, s2, x, wp, ga, gb, norm, K, True),
            library=lambda: torch.matmul(e.view(rows, H), wp),
            bytes=(rows * H + 2 * rows * B + H * B) * it + s2.numel() * 4,
            flops=gemm_flops, per=1),
        "tcn_out_gemm_unfold": dict(
            replaces=WHOLE_BLOCK,
            kernel=lambda: tb.tcn_out_gemm(e, s2, x, ow, blocks["dw_gamma"][nb],
                                           blocks["dw_beta"][nb], norm, K, False, out),
            plain=lambda: tb.out_gemm_plain(e, s2, x, ow, blocks["dw_gamma"][nb],
                                            blocks["dw_beta"][nb], norm, K, False),
            library=lambda: torch.matmul(e.view(rows, H), ow),
            bytes=(rows * H + 2 * rows * B + H * B) * it + s2.numel() * 4,
            flops=gemm_flops, per=1),
    }
    path_of = {"tcn_in_gemm": "auto", "tcn_dwconv": "auto",
               "tcn_out_gemm_fold": "auto", "tcn_out_gemm_unfold": "block"}
    def measure(s):
        """Device, event and host times of a spec, its plain version's and
        library call's device times, and its bound (all per launch)."""
        per = s["per"]
        t_bytes = s["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = s["flops"] / PEAK_FLOPS[dt] * 1e3
        return {
            "ms": device_ms(s["kernel"]) / per, "plain_ms": device_ms(s["plain"]) / per,
            "library_ms": device_ms(s["library"]) / per if s["library"] else None,
            "event_ms": cuda_ms(s["kernel"]) / per, "host_us": host_us(s["kernel"]) / per,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }

    def per_dilation_times(name, s, shape):
        """Device ms per launch of the kernel and of the cuDNN call at each
        dilation of the chain (the mean hides the worst), with the tile."""
        rows_ = []
        t_bytes = s["bytes"] / PEAK_BYTES_PER_S * 1e3  # per launch, as measure()
        for xi in range(cfg.X):
            d = 2 ** xi
            pd = s["per_d"]
            row = {"dilation": d, "tile": list(pd["plan"](d)[:3]),
                   "ms": device_ms(lambda: pd["kernel"](d)),
                   "library_ms": device_ms(lambda: pd["library"](d))}
            if "chpart_bytes" in pd:
                row["chpart_bytes"] = pd["chpart_bytes"](d)
            rows_.append(row)
            extra = f", chpart {row['chpart_bytes']} B" if "chpart_bytes" in row else ""
            log(f"    {name} d={d}: {row['ms']:.4f} ms (cuDNN {row['library_ms']:.4f}, bound "
                f"{t_bytes:.4f} by bytes; tile rows x channels x lanes {row['tile']}{extra}) "
                f"at {shape}")
        return rows_

    def report(name, t, shape):
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        log(f"  {name} ({DESIGN[name]}): {t['ms']:.4f} ms/launch on the device (plain "
            f"{t['plain_ms']:.4f}, library {lib}, bound {t['bound_ms']:.4f} by {t['bound_by']}; "
            f"event {t['event_ms']:.4f} ms, host {t['host_us']:.1f} us per call) at {shape}, bf16")

    kernels = []
    for name, s in specs.items():
        t = measure(s)
        shape = f"M={M}, K_pad={Kp}, B={B}, H={H}"
        if "per_d" in s:
            t["per_dilation"] = per_dilation_times(name, s, shape)
        kernels.append({
            "name": name, "route": "cuda", "source": s.get("source", SOURCE),
            "design": DESIGN[name], "replaces": s["replaces"],
            "launches": path_counts[path_of[name]][name],
            "path": f"separate --use_kernels {path_of[name]}",
            "max_abs_err": errs[name], **t,
        })
        report(name, t, shape)
    M5, rows5 = 5, 5 * Kp
    for name, s in train_kernel_specs(blocks, cfg, dev, M=M5, K=K).items():
        t = measure(s)
        if "stage_a" in s:
            # the same splits with one partial per CTA (no cluster sums)
            t["stage_a_ms"] = device_ms(s["stage_a"])
            log(f"  {name}: Stage A {t['stage_a_ms']:.4f} ms, Stage B {t['ms']:.4f} ms per "
                "tcn_wgrad(...).sum(0) call")
        if "per_d" in s:
            t["per_dilation"] = per_dilation_times(name, s, f"M={M5}, K_pad={Kp}, H={H}")
        kernels.append({
            "name": name, "route": "cuda", "source": s["source"], "design": DESIGN[name],
            "replaces": s["replaces"], "launches": train_counts[name],
            "path": "train --use_kernels hybrid", "max_abs_err": train_errs[name], **t,
        })
        report(name, t, f"M={M5}, K_pad={Kp} ({rows5} rows), B={B}, H={H}")
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on its path")

    train_timing.update(backward_timing(stacked, cfg, dev, M=M5, K=K))
    log(json.dumps({"build_s": build_s, "latency": latency, "train": train_timing,
                    "evaluate": eval_timing}))
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
