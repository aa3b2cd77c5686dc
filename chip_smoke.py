"""Chip smoke test of the PyTorch/CUDA port (convtasnet_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --timing   # the twelve kernels' warm and cold times alone
    python3 chip_smoke.py --stream   # the stream phase and the stream block kernel's alone
    python3 chip_smoke.py --skip     # the skip phase alone (the taslp widths' skip modes)

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
   then KFW tcn_fold_weights (the fold's weight terms of K3 fold, one
   launch per forward over all blocks) against fold_weights at the paper
   widths (NB=32, H=512, B=256), the scaled ones (NB=60, H=1024) and the
   edges (NB=1, H=130), f32 and bf16: wp bit for bit, g2w / b2w within
   TOL_F32 of the sum of |g2| |W| per column, a second launch bit for bit;
4. training kernel phase: holds K2's save mode and the backward kernels
   (KB1 tcn_bwd_dz, KW tcn_wgrad in both forms, also with NaN in the rows
   >= K of its second operand, KB2 tcn_bwd_dwconv with NaN in the rows
   >= K of c and dz, KB3 tcn_bwd_dx) against
   their plain versions at the training shapes (batch
   5 x 4 s, K=3199 padded to 3200), every dilation, gLN and cLN, causal
   and not, f32 and bf16, and KF tcn_bwd_finish on those kernels'
   partials in groups of 1, 3 and 32 slots, a full group and the chain's
   last, uneven one (other rows untouched, a second launch bit for bit);
   then the 32-block save-form chain and its backward (whole_tcn_bwd), the
   per-block recompute and hybrid backwards, and requires two backward
   runs, and runs with KF in groups of 1 and 3, to give identical bytes;
4b. hybrid-chain phase: the per-block hybrid form as one autograd
   Function over the chain (whole_chain_hybrid, the model's form past the
   memory gate) against NB per-block whole_block_hybrid calls over views
   of the stacked leaves, bf16, paper config, batch 5 x 4 s: the output
   bit for bit, every gradient leaf within TOL_BWD_CHAIN_BF16; forward +
   backward device time of both in turns; the torch ops of gradient
   allocation and accumulation per call (torch.profiler);
4c. skip phase (skip_phase; alone with --skip): the skip modes of the
   paper's final version at the taslp cell's widths (B=128, Sc=128,
   H=512, 24 blocks; batch 8 x 4 s, K=3999 padded to 4096): each
   skip-mode kernel (K3 fold / unfold, KB1, KW z, KF, KFW) against its
   plain version, its launches counted under its `_skip` name; the
   24-block fold chain and the training op against their plain stages;
   the launches of the graphed hybrid train step's replays and of the
   `auto` forward; the six kernels' warm and cold times and bounds, a
   {"skip_kernels": [...]} line;
5. slice phase: writes seeded paper-config weights with the port's
   save_checkpoint and synthetic 8 kHz mixtures with its wavio, then runs
   `convtasnet_torch.cli.separate` on cuda with --batch_size 8 and
   --use_kernels auto (the main path), block and 0; checks the wavs, the
   launch counts (NB per forward for every kernel of the form, KFW once
   per `auto` forward) and the agreement of the kernel forms with the
   eager run;
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
6b. graph phase (models/graphed.GraphedForward, the forwards as CUDA
   graphs, one per input shape): at the paper config, batch 8 and 1 x 4 s,
   auto and block, and at the scaled config, batch 1 and 2 x 8 s at 16 kHz,
   the graphed forward against the eager kernel forward, bit for bit, with
   the same launches per forward (KFW exactly once per `auto` forward, the
   chain kernels NB times); eager and graphed ms (CUDA events), device
   busy and idle share, capture ms and pool bytes per graph; three keys of
   one wrapper (one shared pool) replayed in turn, bit for bit; the separate
   CLI over 40 mixtures in two repeating shapes (--pad_to_multiple 8000),
   graphed against a run with the cap at 0 (every call eager): byte-equal
   wavs, one capture per shape seen twice; the evaluate CLI with --cal_sdr 1
   on the evaluate phase's two tt sets, each padded to one shape: SI-SNRi,
   SDRi and reordered estimates equal to the eager run's, steady ms per
   utterance of both;
7. stream phase: at the causal paper config (cLN, causal; seeded weights
   written as a bf16 checkpoint and an f32 copy) on 4 mixtures of 2-5.9 s,
   two of them a multiple of the 20 ms chunk: `convtasnet_torch.cli.separate`
   padded to the chunk (--use_kernels auto, with K1 / K2 / K3 fold in their
   cLN and causal modes counted, and 0) as the offline reference, and
   `convtasnet_torch.cli.stream` at --batch 1 and 4 (wavs against the
   offline wavs); StreamingSeparator (CUDA graphs and eager) against
   forward: f32 streamed vs eager and auto, bf16 vs both, graphed vs eager,
   batch 4 vs each stream alone, reset() vs fresh separators; push() under
   strict_mode (no host synchronisation); ms per chunk with a host fetch per
   chunk, RTF, device busy and device operations per chunk, eager and
   graphed, at 10 / 20 / 40 ms chunks (batch 1) and 20 ms at batch 1-1024;
   the stream CLI's block-kernel launches (a multiple of R * X in bf16,
   none in f32);
7b. stream block phase: the stream chunk step's TCN-block kernel
   (csrc/tcn_stream_block.cu) against stream_block_plain at the causal
   widths in bf16, every dilation 1..128, 1, 15, 16 and 300 frames, 1 and
   4 streams, two chunks in a row (relative L2 of the block's increment and
   of the new history, the carried frames bit for bit, one launch a call);
   then its device ms a launch at one 20 ms chunk, warm and cold, per
   dilation, beside its byte bound and the plain version's;
8. train phase: writes a synthetic 4 s, 8 kHz wav dataset (10 tr, 4 cv
   utterances) with the port's synthetic.py and runs
   `convtasnet_torch.cli.train` on cuda at the paper config, --batch_size
   5, with --use_kernels hybrid (the main path), whole and 0: finite
   losses, checkpoints that load, a --continue_from resume, and the launch
   counts of the run (on one card the CLI's train and CV steps are CUDA
   graphs, training/solver.GraphedStep: a CV key's capture runs one more
   forward, its side-stream warm-up); then one train step of each form
   from the same seed: the launches per step, the loss, and the gradients
   against the eager autograd step in f32 and bf16;
8b. train-graph phase (training/solver.GraphedStep, the train step as a
   CUDA graph with its trees updated in place) at the paper config, bf16,
   batch 5 x 4 s on the train phase's set: 10 steps graphed against 10
   with graphed.MAX_GRAPHS = 0 (every call eager) for hybrid, whole, 0,
   0 with remat block and dots, and hybrid at BN (the eager chain): loss
   per step and every parameter, moment and BN-state leaf (bit for bit
   where two eager runs are), opt_state.step, launches, capture ms, pool
   bytes, peak memory, and step ms (CUDA events; device busy and idle
   share for hybrid, in turns, and the remat modes); for hybrid and whole
   the graphed step's device busy and at::native reduce and copy launches
   per step (torch.profiler), again at R = 2, which they must not exceed
   (no library op in the per-block loops); set_lr between two
   replays against eager and against the full rate; the train CLI
   (hybrid) two epochs graphed against eager (histories, launches), then
   graphed --continue_from epoch1.ckpt and a resume from a latest.ckpt
   cut mid-epoch (batch 2, step 3 of 5) against the uncut run; the scaled
   config's hybrid step at batch 2 x 8 s graphed against eager, timed;
9. times the forward at batch 8 and batch 1 (4 s at 8 kHz), the train
   step at batch 5 x 4 s, each kernel per launch beside its plain
   version, one PyTorch call where there is one (torch.matmul of a GEMM
   kernel's product; F.conv1d / F.conv_transpose1d with groups=H of the
   depthwise kernels, cuDNN with TF32 off; KFW's is fold_weights, the
   library calls it replaced, timed in turns with it: library, kernel,
   kernel, library), and its roofline bound, its cold-L2 time (launches
   cycling over copies of its inputs and outputs past twice the 50 MB L2;
   one below its byte bound fails the run), and the backward of each
   training op beside its plain version; K2, K2 save and
   KB2 also per dilation beside the cuDNN call, with their tile (and KB2's
   f32 channel-partial bytes beside its bound); KW's launch plan
   and its Stage A time (the same splits, one partial per CTA) beside the
   plan's (Stage B: partials summed inside clusters); KF on the main
   path's group of 32 blocks' slots. `ms`, `cold_ms`, `plain_ms` and
   `library_ms` are device time per call from torch.profiler through the
   port's kernel timer (convtasnet_torch/tools/_bench.py: records counted,
   CUDA event time and `profiler_blind` after three short profiles; the
   kernels' own time: a wrapper's host time can exceed it), `event_ms` the
   CUDA-event time per call of back-to-back calls, `host_us` the host's
   enqueue time per call;
10. options phase: (a) the eager train step at the paper config (bf16,
   batch 5 x 4 s) per remat mode (none, repeat, block, dots): loss and
   per-leaf gradients against remat none (and whether they are equal bit
   for bit), step ms by CUDA events, and the forward + backward peak of
   max_memory_allocated, which must order none > dots > block (repeat's is
   printed, not ordered); (b) `convtasnet_torch.cli.train --visualize 1`
   for one epoch (--use_kernels hybrid): loss.png written or "visualize
   failed" logged, a checkpoint either way, the launches of the run; (c)
   the scaled config (BASELINE.json configs[4]: N=256, L=32, B=256,
   H=1024, P=3, X=10, R=6, gLN, 16 kHz; on the kernels' launch limits H =
   1024 and conv span 1024) through convtasnet_torch/tools/
   bench_scaled_config.py: every training tier (eager_noremat, eager_dots,
   whole, hybrid) at batch 2 and 8 x 8 s, ok / out of memory, step ms and
   peak GB, with the launches of whole and hybrid against the counters (60
   blocks, dilations up to 512); one hybrid and one whole step's loss and
   gradients against the eager step at batch 2 (bf16); the forward at
   batch 1 and 2; the kernels line carries each kernel's launches on these
   runs (`scaled_launches`);
11. parallel phase (parallel/, over torch.distributed) at the paper config,
   last, on the train phase's dataset: two ranks spawned on cuda:0 over
   gloo (NCCL refuses two ranks on one card; gloo carries all-reduce and
   broadcast of CUDA tensors through the host) run the DP train step
   (--use_kernels hybrid, batch 5 x 4 s padded to 6, 3 rows per rank, f32
   and bf16, SGD at lr 1 so the parameter change is the clipped gradient),
   the DP forward (auto, batch 8 split 4 + 4) and the TP = 2 forward and
   train step (eager chain); each is held against the single-process run,
   with each rank's kernel launches and the collectives per step (2 for
   DP: the real-row count and the gradient bucket), and a Solver on the
   gloo DP mesh keeps eager steps. Then one rank over NCCL: the train CLI
   for two epochs through its distributed path (torchrun's variables), its
   steps graphed and replayed, the first epoch against the train phase's
   losses; the DP step bit for
   bit against the plain step, cp_forward at n = 1 (the padding path)
   against forward, and the DP step timed against the plain step in turns
   (CUDA events, device busy from torch.profiler); then the DP `hybrid`
   and `whole` steps through GraphedStep with their NCCL all-reduces
   captured, 10 steps bit for bit against the eager DP step and the
   graphed plain step, 1 capture, 8 replays, 2 collectives on every call,
   and `hybrid` timed in turns (plain graphed, DP graphed, DP graphed,
   plain graphed, DP eager). The world-2 step times go through the host
   and are printed as such;
12. prints the card again, a {"kernels": [...]} line (each kernel with its
   `design`, `cold_ms` and shares of its bound) and, last, {"ok": true,
   "device": {...}}.

With --timing only the kernels are built and timed (warm and cold, no
plain or library calls), in one fresh process, and a {"kernel_times":
[...]} line is printed; a cold time below its byte bound or a short
profile fails it.

Any failed check raises and the script exits non-zero. It imports nothing
of JAX; without a CUDA device, or without the package beside it, it fails.
"""

from __future__ import annotations

import glob
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# The port's one kernel timer (records counted, warm and cold L2).
from convtasnet_torch.tools._bench import PROFILER_BLIND, cold_timed, device_ms, timed

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
# Streamed against offline separated wavs in f32 (tests/test_e2e_cli.py:225):
# two PCM16 roundings (2^-16 each) and the f32 paths' summation order.
TOL_PCM16 = 5e-4

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
# stream+ring: KB2's strip, streamed through a ring of TMA stages by a
# producer warp, each row converted once per CTA into a ring of dc.
# grouped-stream: KF over a group of blocks' slots, a grid resident on every
# SM looping over units, 8 loads in flight per thread. split-h+ticket: KFW
# with H split over CTAs, the last CTA of a column tile (a device ticket)
# adding the slices in order.
STENCIL = "stencil+bulk"
DESIGN = {"tcn_in_gemm": "wgmma+tma", "tcn_dwconv": STENCIL, "tcn_out_gemm_fold": "wgmma+tma",
          "tcn_out_gemm_unfold": "wgmma+tma", "tcn_dwconv_save": STENCIL,
          "tcn_bwd_dz": "wgmma+tma", "tcn_wgrad_out": "wgmma+tma", "tcn_bwd_dwconv": "stream+ring",
          "tcn_bwd_dx": "wgmma+tma", "tcn_wgrad_in": "wgmma+tma",
          "tcn_bwd_finish": "grouped-stream", "tcn_fold_weights": "split-h+ticket"}
# The skip modes share their first-version kernel's body and design.
DESIGN.update({k + "_skip": DESIGN[k] for k in (
    "tcn_out_gemm_fold", "tcn_out_gemm_unfold", "tcn_fold_weights", "tcn_bwd_dz",
    "tcn_wgrad_out", "tcn_bwd_finish")})
SOURCE_DW = "convtasnet_torch/csrc/tcn_dwconv_sm90.cuh"
SOURCE_KF = "convtasnet_torch/csrc/tcn_bwd_finish.cuh"
SOURCE_KFW = "convtasnet_torch/csrc/tcn_fold_weights.cuh"
SKIP_REPLAYS = 3  # graphed train steps whose launches the skip phase counts
TRAIN_KERNELS = ("tcn_dwconv_save", "tcn_bwd_dz", "tcn_wgrad_out", "tcn_bwd_dwconv",
                 "tcn_bwd_dx", "tcn_wgrad_in", "tcn_bwd_finish")


def log(*a):
    print(*a, flush=True)


def auto_launches(NB):
    """Kernel launches of one `auto` (whole-TCN, fold) forward of NB blocks:
    KFW once, then K1, K2 and K3 fold per block."""
    return {"tcn_fold_weights": 1, "tcn_in_gemm": NB, "tcn_dwconv": NB, "tcn_out_gemm_fold": NB}


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


def _kernel_counters():
    from convtasnet_torch.ops.kernels import tcn_block as tb, tcn_block_bwd as tbb
    return tb.COUNTERS + tbb.COUNTERS


def all_counts():
    """Every hand-written kernel's launches in the launch ledger."""
    from convtasnet_torch.utils import ledger
    return ledger.read(_kernel_counters())


def reset_all_counts():
    from convtasnet_torch.utils import ledger
    ledger.reset(_kernel_counters())


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


def kf_slots(parts, G, dev):
    """A FinishSlots of G slots filled from one block's kernel partials
    (wz, win, chpart, colpart, da1part, da2part; wz [nz, H, B + Sc] with a
    skip path), slot j scaled by 1 + j / 64 so that no two slots are
    equal, and the block's PartCounts."""
    from convtasnet_torch.ops.kernels import tcn_block_bwd as tbb

    n = tbb.PartCounts(*(t.shape[0] for t in parts))
    _, B, H = parts[1].shape
    P = parts[2].shape[1] - 2
    slots = tbb.FinishSlots.alloc(G, n, B, H, P, dev, parts[0].shape[2] - B)
    for j in range(G):
        for dst, src in zip(slots.slot(j, n), parts):
            dst.copy_(src * (1 + j / 64))
    return slots, n


def kf_check(chk, what, parts, NB):
    """KF grouped against bwd_finish_plain on the same f32 partials (one
    block's kernel partials in every slot, scaled per slot), for groups of
    1, 3 and NB slots: a full group into rows NB - G ... NB - 1 and the
    chain's last group, rows 0 ... (NB mod G or G) - 1 (two blocks of three
    at NB = 32), each with its last slot holding half the KB2 partials;
    every other row untouched, a second launch giving the same bits. Each
    gradient's error is relative to its largest plain value; d_alpha1 and
    d_alpha2, single sums of partials of mixed sign, relative to the sum of
    their partials' magnitudes (what a change of summation order moves
    them by). Returns the max |KF - plain|."""
    from convtasnet_torch.ops.kernels import tcn_block_bwd as tbb

    dev = parts[0].device
    _, B, H = parts[1].shape
    P = parts[2].shape[1] - 2
    shapes = [(NB, B, H), (NB,), (NB, H), (NB, H), (NB, P, H), (NB,), (NB, H), (NB, H),
              (NB, H, parts[0].shape[2])]
    worst_abs = 0.0
    for G in (1, 3, NB):
        slots, n = kf_slots(parts, G, dev)
        short = n._replace(nch=max(1, n.nch // 2), nda2=max(1, n.nda2 // 2))
        for nb0, m in ((NB - G, G), (0, NB % G or G)):
            counts = [n] * (m - 1) + [short]
            want, got, again = ([torch.full(sh, float("nan"), device=dev) for sh in shapes]
                                for _ in range(3))
            tbb.bwd_finish_plain(slots, counts, want, nb0)
            tbb.tcn_bwd_finish(slots, counts, got, nb0)
            tbb.tcn_bwd_finish(slots, counts, again, nb0)
            rows = slice(nb0, nb0 + m)
            scale = {"da1": float(slots.da1part[:m].abs().sum(1).max()),
                     "da2": float(slots.da2part[:m].abs().sum(1).max())}
            worst = 0.0
            for name, a, b in zip(tbb.GRAD_ORDER, got, want):
                if name in scale:
                    worst = max(worst, float((a[rows] - b[rows]).abs().max())
                                / max(scale[name], 1e-30))
                else:
                    worst = max(worst, rel_max(a[rows], b[rows]))
                worst_abs = max(worst_abs, float((a[rows] - b[rows]).abs().max()))
            tag = f"KF {what} G={G} rows {nb0}..{nb0 + m - 1}"
            chk(tag, worst, TOL_F32)
            chk(f"{tag}: other rows untouched", float(sum(
                not bool(torch.isnan(a[:nb0]).all() and torch.isnan(a[nb0 + m:]).all())
                for a in got)), 0.0)
            chk(f"{tag}: repeat", float(sum(not torch.equal(a[rows], b[rows])
                                            for a, b in zip(got, again))), 0.0)
        del slots
    return worst_abs


# (NB, H, B): the paper and the scaled config; one block of an H that is a
# multiple of nothing (KFW's edges: one column tile pair, a short slice)
FOLD_SHAPES = ((32, 512, 256), (60, 1024, 256), (1, 130, 256))


def fold_inputs(dev, NB, H, B, seed):
    """Seeded f32 out_w [NB, H, B] (xavier scale), g2 and b2 [NB, H]."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out_w = torch.randn((NB, H, B), generator=gen, device=dev) * (2.0 / (H + B)) ** 0.5
    g2 = torch.randn((NB, H), generator=gen, device=dev) * 0.2 + 1
    b2 = torch.randn((NB, H), generator=gen, device=dev) * 0.1
    return out_w, g2, b2


def fold_phase(dev):
    """KFW against fold_weights at the paper and the scaled widths and at
    the edges (NB = 1, H = 130), f32 and bf16: wp bit for bit; g2w and b2w
    within TOL_F32 of the sum of |v| |W| per column (another summation
    order); a second launch bit for bit (the H-split tickets were reset).
    Returns max |kernel - plain| over the three terms, bf16, paper widths."""
    from convtasnet_torch.ops.kernels import tcn_block as tb

    chk = Checks("fold phase")
    log("fold phase (KFW vs fold_weights):")
    err = 0.0
    for NB, H, B in FOLD_SHAPES:
        out_w, g2, b2 = fold_inputs(dev, NB, H, B, NB)
        for dt in (torch.float32, torch.bfloat16):
            what = f"KFW {'f32' if dt == torch.float32 else 'bf16'} NB={NB} H={H} B={B}"
            got = tb.tcn_fold_weights(out_w, g2, b2, dt)
            want = tb.fold_weights(out_w, g2, b2, dt)
            chk(f"{what} wp bit for bit (differing elements)",
                float((got[0] != want[0]).sum()), 0)
            wr = out_w.to(dt).float().abs()
            for name, a, b, v in zip(("g2w", "b2w"), got[1:], want[1:], (g2, b2)):
                scale = torch.einsum("nh,nhb->nb", v.abs(), wr).clamp_min(1e-30)
                chk(f"{what} {name} / sum |v| |W|", float(((a - b).abs() / scale).max()),
                    TOL_F32)
            chk(f"{what} repeat", float(sum(not torch.equal(u, v) for u, v in zip(
                got, tb.tcn_fold_weights(out_w, g2, b2, dt)))), 0)
            if dt == torch.bfloat16 and NB == FOLD_SHAPES[0][0]:
                err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    torch.cuda.synchronize()
    chk.done()
    return err


def kb2_cell_phase(blocks, cfg, dev, M=8):
    """KB2 at the train cells' shapes (batch 8 of K = 3,199 and 3,999
    frames; H = 512, P = 3, the config's norm, not causal) at every
    dilation of the chain, in f32 and bf16, against bwd_dwconv_plain: db
    with NaN in y1's, c's and dz's rows >= K and its pad rows zero, the
    channel partials (dw, dg1, db1), the norm1 sums, d_alpha2, two launches
    equal bytes, and the launches counted under tcn_bwd_dwconv alone. The
    strip plan depends on the batch: these are the plans the cells run."""
    from convtasnet_torch.ops.kernels import tcn_block as tb, tcn_block_bwd as tbb

    chk = Checks("KB2 train-cell phase")
    log(f"KB2 at the train cells' shapes, batch {M} (kernel vs plain version):")
    nb, norm = 3, cfg.norm_type
    red = (1,) if norm == "gLN" else (2,)
    a1, g1, b1, w, a2, g2 = (blocks[k][nb] for k in (
        "in_prelu", "in_gamma", "in_beta", "dw_w", "dw_prelu", "dw_gamma"))
    reset_all_counts()
    launches = 0
    for K in (3199, 3999):
        Kp = -(-K // tb.ROW_ALIGN) * tb.ROW_ALIGN
        gen = torch.Generator(device=dev).manual_seed(K)
        x32 = torch.randn((M, Kp, cfg.B), generator=gen, device=dev)
        x32[:, K:] = 0
        g32 = torch.randn((M, Kp, cfg.B), generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            tol = TOL_F32 if dt == torch.float32 else TOL_BF16
            tag = f"{'f32' if dt == torch.float32 else 'bf16'} M={M} K={K}"
            x, g = x32.to(dt), g32.to(dt)
            out_wt = blocks["out_w"][nb].to(dt).t().contiguous()
            y1, s1 = tb.in_gemm_plain(x, blocks["in_w"][nb].to(dt), a1, norm)
            for xi in range(cfg.X):
                d = 2 ** xi
                what = f"{tag} d={d}"
                _, s2, c = tb.dwconv_plain(y1, s1, a1, g1, b1, w, a2, norm, d, False, K,
                                           save=True)
                dz, _, gs2 = tbb.bwd_dz_plain(g, out_wt, c, s2, a2, g2, norm, K)
                bargs = (y1, c, dz, s1, s2, gs2, a1, g1, b1, w, a2, g2, norm, d, False, K)
                nargs = (nan_pad(y1, K), nan_pad(c, K), nan_pad(dz, K)) + bargs[3:]
                got = tbb.tcn_bwd_dwconv(*nargs)
                again = tbb.tcn_bwd_dwconv(*nargs)
                launches += 2
                db, chp, gs1, da2 = tbb.bwd_dwconv_plain(*bargs)
                sp = tbb._kb2_plan(cfg.P, d, cfg.H, dt, M, Kp, dev.index)
                log(f"  KB2 plan {what}: {sp.bands} strips of {sp.strip} rows x {sp.cols} "
                    f"channels, ring {sp.ring * sp.chunk} rows, {sp.stages} stages of "
                    f"{sp.chunk} rows, {sp.grid} CTAs")
                chk(f"KB2 {what} db, NaN in the rows >= K", rel_max(got[0], db), tol)
                chk(f"KB2 {what} db pad rows zero", float(got[0][:, K:].abs().max()), 0.0)
                chk(f"KB2 {what} dw/dg1/db1", rel_max(got[1].sum(0), chp.sum(0)), tol)
                chk(f"KB2 {what} norm1 sums", rel_max(got[2].sum(red), gs1.sum(red)), tol)
                chk(f"KB2 {what} d_alpha2", rel_max(got[3].sum(), da2.sum()),
                    max(tol, TOL_ALPHA_F32))
                chk(f"KB2 {what} repeat", float(sum(not torch.equal(u, v)
                                                    for u, v in zip(got, again))), 0.0)
    counted = all_counts()
    chk(f"KB2 launches: {launches} under tcn_bwd_dwconv, none under another name",
        float(abs(counted["tcn_bwd_dwconv"] - launches)
              + sum(v for k, v in counted.items() if k != "tcn_bwd_dwconv")), 0.0)
    torch.cuda.synchronize()
    chk.done()


def train_specs(blocks, cfg, dev, K):
    """train_kernel_specs at batch 5, KB2's at the train cells' batch 8 (its
    strip plan depends on the batch)."""
    specs = train_kernel_specs(blocks, cfg, dev, M=5, K=K)
    specs["tcn_bwd_dwconv"] = train_kernel_specs(blocks, cfg, dev, M=8, K=K)["tcn_bwd_dwconv"]
    return specs


def hybrid_chain_phase(stacked, cfg, dev, M=5, K=3199):
    """The per-block hybrid form as one autograd Function over the chain
    (whole_chain_hybrid) against NB per-block whole_block_hybrid calls over
    views of the stacked leaves, bf16, at the paper config and the train
    step's shapes: the output bit for bit and every gradient leaf within
    TOL_BWD_CHAIN_BF16 (relative L2); the chain's kernel launches per
    forward + backward (K1, K2 save, K3 unfold NB times each; the backward
    is plain PyTorch); forward + backward device ms of both
    in turns (per block, chain, chain, per block); the torch ops that
    allocate and accumulate gradients per call (torch.profiler, CPU)."""
    from convtasnet_torch.ops.kernels import tcn_block as tb
    from convtasnet_torch.ops.kernels.whole_block_hybrid import (whole_block_hybrid,
                                                                 whole_chain_hybrid)

    chk = Checks("hybrid-chain phase")
    NB = cfg.R * cfg.X
    Kp = -(-K // tb.ROW_ALIGN) * tb.ROW_ALIGN
    gen = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn((M, Kp, cfg.B), generator=gen, device=dev)
    x[:, K:] = 0
    x = x.to(torch.bfloat16)
    g = torch.randn((M, Kp, cfg.B), generator=gen, device=dev).to(torch.bfloat16)

    def per_block(y, *params):
        for nb in range(NB):
            y = whole_block_hybrid(y, *[p[nb] for p in params], cfg.norm_type,
                                   2 ** (nb % cfg.X), cfg.causal, valid_k=K)
        return y

    def chain(*leaves):
        return whole_chain_hybrid(*leaves, cfg.norm_type, cfg.causal, cfg.X, valid_k=K)

    def run(fn):
        leaves = [x.detach().requires_grad_(True)] + [p.detach().requires_grad_(True)
                                                      for p in stacked]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves, g)

    log("hybrid-chain phase (whole_chain_hybrid vs per-block whole_block_hybrid, bf16, "
        f"M={M}, K_pad={Kp}):")
    (ob, gb) = run(per_block)
    reset_all_counts()
    oc, gc = run(chain)
    torch.cuda.synchronize()
    launches = {k: v for k, v in all_counts().items() if v}
    want = dict(tcn_in_gemm=NB, tcn_dwconv_save=NB, tcn_out_gemm_unfold=NB)
    chk(f"chain: launches per forward + backward {launches} == K1, K2 save, K3 unfold NB "
        "times each", float(launches != want), 0)
    chk("chain vs per-block ops: output, differing elements", float((oc != ob).sum()), 0)
    for name, a, b in zip(GRAD_NAMES, gc, gb):
        chk(f"chain vs per-block ops: {name} (relative L2)", rel_l2(a, b),
            max(TOL_BWD_CHAIN_BF16, TOL_ALPHA_F32) if name in ("da1", "da2")
            else TOL_BWD_CHAIN_BF16)
    del gb, gc
    res = {"per_block_ms": [], "chain_ms": [], "chain_launches": launches}
    for label, fn in (("per_block", per_block), ("chain", chain), ("chain", chain),
                      ("per_block", per_block)):
        res[f"{label}_ms"].append(device_ms(lambda fn=fn: run(fn), iters=3, warm=1))
    ops = ("aten::select_backward", "aten::zeros", "aten::add", "aten::add_", "aten::copy_",
           "aten::empty", "aten::empty_strided", "aten::_to_copy")
    for label, fn in (("per_block", per_block), ("chain", chain)):
        run(fn)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            run(fn)
            torch.cuda.synchronize()
        found = {e.key: e.count for e in prof.key_averages() if e.key in ops}
        res[f"{label}_ops_per_call"] = {k: found.get(k, 0) for k in ops}
    chk("chain: no select_backward (no per-block view gradient)",
        res["chain_ops_per_call"]["aten::select_backward"], 0)
    chk("per-block ops: a select_backward per block and stacked leaf (9 NB at least)",
        float(res["per_block_ops_per_call"]["aten::select_backward"] < 9 * NB), 0)
    log(f"  forward + backward device ms, in turns: per block {res['per_block_ms']}, chain "
        f"{res['chain_ms']}")
    log(f"  torch ops per call: per block {res['per_block_ops_per_call']}, chain "
        f"{res['chain_ops_per_call']}")
    torch.cuda.synchronize()
    chk.done()
    return res


# The final version's published widths (benchmark/configs/taslp.json): the
# skip phase's configuration.
TASLP = dict(N=512, L=16, B=128, Sc=128, H=512, P=3, X=8, R=3, C=2, norm_type="gLN",
             causal=False, mask_nonlinear="sigmoid", encoder_relu=False, input_norm="gLN")


def skip_kernel_specs(blocks, cfg, dev, M=8, K=3999):
    """Timing specs of the six skip-mode kernels at the taslp cell's shapes
    (bf16, batch 8 x 4 s at L = 16, block 3's weights; KFW on the stacked
    weights; KF on the main path's group of blocks' slots), as
    forward_kernel_specs. Bytes and operations as benchmark/kernels'
    `*_skip` work files count them: e read once for both outputs, x, s, g
    and g_s read (and x, s written) once."""
    from convtasnet_torch.ops.kernels import tcn_block as tb, tcn_block_bwd as tbb
    from convtasnet_torch.ops.kernels.whole_tcn_hybrid import finish_plan

    B, H, P, Sc, norm = cfg.B, cfg.H, cfg.P, cfg.Sc, cfg.norm_type
    Kp = -(-K // tb.ROW_ALIGN) * tb.ROW_ALIGN
    dt, it, rows, nb, bs = torch.bfloat16, 2, M * Kp, 3, cfg.B + cfg.Sc
    gen = torch.Generator(device=dev).manual_seed(26)

    def rnd(ch, zero_pad=True):
        t = torch.randn((M, Kp, ch), generator=gen, device=dev)
        if zero_pad:
            t[:, K:] = 0
        return t.to(dt)

    x, s, g, gs = rnd(B), rnd(Sc), rnd(B, False), rnd(Sc, False)
    in_w = blocks["in_w"][nb].to(dt)
    a1, g1, b1, w, a2, g2, b2 = (blocks[k][nb] for k in (
        "in_prelu", "in_gamma", "in_beta", "dw_w", "dw_prelu", "dw_gamma", "dw_beta"))
    out_w, skip_w = blocks["out_w"][nb], blocks["skip_w"][nb]
    y1, s1 = tb.tcn_in_gemm(x, in_w, a1, norm)
    e, s2, c = tb.tcn_dwconv(y1, s1, a1, g1, b1, w, a2, norm, 1, cfg.causal, K, save=True)
    wp, ga, gb = tb.fold_weights(out_w, g2, b2, dt, skip_w)
    ow = tb.out_weights(out_w, skip_w).to(dt)
    wt = ow.t().contiguous()
    out = torch.empty_like(x)
    gcat = torch.cat([g, gs], dim=-1)
    dz, colpart, gs2 = tbb.tcn_bwd_dz(g, wt, c, s2, a2, g2, norm, K, gs=gs)
    db, chpart, gs1, da2part = tbb.tcn_bwd_dwconv(y1, c, dz, s1, s2, gs2, a1, g1, b1, w, a2,
                                                  g2, norm, 1, cfg.causal, K)
    _, dy1, da1part = tbb.tcn_bwd_dx(db, y1, in_w.t().contiguous(), g, s1, gs1, a1, g1,
                                     norm, K)
    z = (s2, a2, g2, b2, norm)
    kf_parts = (tbb.tcn_wgrad(c, g, K, z, gs=gs), tbb.tcn_wgrad(x, dy1, K), chpart, colpart,
                da1part, da2part)
    stacked = [blocks[k] for k in ("in_w", "in_prelu", "in_gamma", "in_beta", "dw_w",
                                   "dw_prelu", "dw_gamma", "dw_beta")]
    stacked.append(tb.out_weights(blocks["out_w"], blocks["skip_w"]))
    NB = stacked[0].shape[0]
    G = finish_plan(M, Kp, B, H, P, tuple(2 ** (i % cfg.X) for i in range(NB)), dt, False,
                    x.device.index, None, Sc)[0]
    kf_slots_, kf_n = kf_slots(kf_parts, G, dev)
    kf_counts = [kf_n] * G
    kf_grads = tbb.alloc_grads(stacked)
    kf_bytes = 4 * (G * sum(t.numel() for t in kf_parts)
                    + sum(t[:G].numel() for t in kf_grads))
    kf_read = G * sum(t.numel() for t in kf_parts)
    fold_in = (blocks["out_w"], blocks["dw_gamma"], blocks["dw_beta"], blocks["skip_w"])
    fold_n = NB * H * bs
    gemm = 2.0 * rows * bs * H
    k3_bytes = (rows * H + 2 * rows * bs + H * bs) * it + s2.numel() * 4

    def k3(fold, wmat, va, vb):
        return dict(
            source=SOURCE, replaces=WHOLE_TCN if fold else WHOLE_BLOCK,
            call=lambda e_, s_, x_, w_, ga_, gb_, o_, sk_: tb.tcn_out_gemm(
                e_, s_, x_, w_, ga_, gb_, norm, K, fold, o_, sk_),
            args=(e, s2, x, wmat, va, vb, out, s.clone()),
            plain=lambda: tb.out_gemm_plain(e, s2, x, wmat, va, vb, norm, K, fold,
                                            skip=s.clone()),
            library=lambda: torch.matmul(e.view(rows, H), wmat),
            bytes=k3_bytes, flops=gemm, per=1)

    return {
        "tcn_out_gemm_fold_skip": k3(True, wp, ga, gb),
        "tcn_out_gemm_unfold_skip": k3(False, ow, g2, b2),
        "tcn_fold_weights_skip": dict(
            source=SOURCE_KFW, replaces=WHOLE_TCN,
            call=lambda o_, g_, b_, k_: tb.tcn_fold_weights(o_, g_, b_, dt, k_), args=fold_in,
            plain=lambda: tb.fold_weights(*fold_in[:3], dt, fold_in[3]),
            library=lambda: tb.fold_weights(*fold_in[:3], dt, fold_in[3]), turns=True,
            shape=f"NB={NB}, H={H}, B + Sc={bs} (stacked weights)",
            bytes=fold_n * (4 + it) + 2 * NB * (H + bs) * 4, flops=5.0 * fold_n, per=1,
            dtype=torch.float32),
        "tcn_bwd_dz_skip": dict(
            source=SOURCE_BWD, replaces=BWD_BLOCK,
            call=lambda g_, w_, c_, s_, gs_: tbb.tcn_bwd_dz(g_, w_, c_, s_, a2, g2, norm, K,
                                                           gs=gs_),
            args=(g, wt, c, s2, gs),
            plain=lambda: tbb.bwd_dz_plain(g, wt, c, s2, a2, g2, norm, K, gs=gs),
            library=lambda: torch.matmul(gcat.view(rows, bs), wt),
            bytes=(rows * bs + bs * H + 2 * rows * H) * it
            + (s2.numel() + colpart.numel() + gs2.numel()) * 4 + 2 * H * 4,
            flops=gemm, per=1),
        "tcn_wgrad_out_skip": dict(
            source=SOURCE_KW, replaces=BWD_BLOCK,
            call=lambda c_, g_, s_, gs_: tbb.tcn_wgrad(c_, g_, K, (s_, a2, g2, b2, norm),
                                                       gs=gs_),
            args=(c, g, s2, gs),
            plain=lambda: tbb.wgrad_plain(c, g, K, z, gs=gs),
            library=lambda: torch.matmul(c.view(rows, H).t(), gcat.view(rows, bs)),
            bytes=rows * (bs + H) * it + H * bs * 4, flops=gemm, per=1),
        "tcn_bwd_finish_skip": dict(
            source=SOURCE_KF, replaces=BWD_BLOCK,
            call=lambda sl, gr: tbb.tcn_bwd_finish(sl, kf_counts, gr, 0),
            args=(kf_slots_, kf_grads),
            plain=lambda: tbb.bwd_finish_plain(kf_slots_, kf_counts, kf_grads, 0),
            library=lambda: [t.sum(1) for t in kf_slots_],
            shape=f"a group of {G} blocks' slots, M={M}, K_pad={Kp}, B={B}, Sc={Sc}, H={H}",
            bytes=kf_bytes, flops=float(kf_read), per=1, dtype=torch.float32),
    }


def skip_phase(dev, M=8, K=3999):
    """The skip modes (a block with a skip path, the paper's final version)
    at the taslp cell's widths and shapes (TASLP; batch 8 x 4 s at L = 16,
    K = 3,999 padded to 4,096; seeded weights): (a) each skip-mode kernel
    against its plain version, gLN and cLN (causal), bf16: K3 fold and
    unfold (x and the skip sum s, in place), KB1 (NaN in the rows >= K of
    g, g_s and c), KW z (NaN in those of g and g_s), KF (kf_check over the
    skip partials), KFW over [out_w | skip_w]; rows >= K exact zeros, a
    second launch bit for bit, each launch counted under its `_skip` name
    and none under the first version's; (b) the 24-block whole-TCN fold
    chain (x and s) and the training op (out, s, dx and every gradient, d
    skip_w included) against their plain stages; the training op within
    TOL_BWD_CHAIN_BF16 or twice what the same blocks without the skip path
    read against theirs; (c) the hybrid train path's own launches: the
    train step graphed (training/solver.GraphedStep: an eager call, a
    capture, then SKIP_REPLAYS replays counted from zero), and the `auto`
    forward (KFW and K3 fold skip) against the eager forward; (d) the six
    kernels timed warm and cold beside their bounds. Returns (results,
    kernel rows)."""
    import dataclasses

    from convtasnet_torch.config import ConvTasNetConfig
    from convtasnet_torch.models.conv_tasnet import forward, init_params
    from convtasnet_torch.ops.kernels import tcn_block as tb, tcn_block_bwd as tbb
    from convtasnet_torch.ops.kernels.whole_tcn import whole_tcn, whole_tcn_reference
    from convtasnet_torch.ops.kernels.whole_tcn_hybrid import finish_plan, whole_tcn_train
    from convtasnet_torch.training.optim import Optimizer, tree_map
    from convtasnet_torch.training.solver import GraphedStep, make_train_step

    cfg = ConvTasNetConfig(**TASLP, use_kernels="hybrid")
    NB, B, H, P, Sc = cfg.R * cfg.X, cfg.B, cfg.H, cfg.P, cfg.Sc
    Kp = -(-K // tb.ROW_ALIGN) * tb.ROW_ALIGN
    dt, nb = torch.bfloat16, 3
    params, state = init_params(torch.Generator(device=dev).manual_seed(24), cfg, device=dev)
    blocks = {k: v.reshape((NB,) + tuple(v.shape[2:]))
              for k, v in params["separator"]["blocks"].items()}
    chk = Checks("skip phase")
    res = {}
    log(f"skip phase (taslp widths B={B}, Sc={Sc}, H={H}, NB={NB}; M={M}, K={K}, "
        f"K_pad={Kp}; bf16):")
    gen = torch.Generator(device=dev).manual_seed(25)

    def rnd(ch, zero_pad=True):
        t = torch.randn((M, Kp, ch), generator=gen, device=dev)
        if zero_pad:
            t[:, K:] = 0
        return t.to(dt)

    def counted(name, n):
        """The launches since the last reset: n of `name`, none of the
        first version's kernel of the same mode."""
        c = all_counts()
        chk(f"{name}: {n} launches counted, none as {name[:-5]}",
            float(abs(c[name] - n) + c[name[:-5]]), 0.0)

    # (a) each kernel against its plain version
    x, s0, g, gs = rnd(B), rnd(Sc), rnd(B, False), rnd(Sc, False)
    in_w = blocks["in_w"][nb].to(dt)
    a1, g1, b1, w, a2, g2, b2 = (blocks[k][nb] for k in (
        "in_prelu", "in_gamma", "in_beta", "dw_w", "dw_prelu", "dw_gamma", "dw_beta"))
    out_w, skip_w = blocks["out_w"][nb], blocks["skip_w"][nb]
    for norm, causal in (("gLN", False), ("cLN", True)):
        red = 1 if norm == "gLN" else 2
        y1, s1 = tb.tcn_in_gemm(x, in_w, a1, norm)
        e, s2, c = tb.tcn_dwconv(y1, s1, a1, g1, b1, w, a2, norm, 2, causal, K, save=True)
        for fold in (True, False):
            mode = "fold" if fold else "unfold"
            if fold:
                wmat, va, vb = tb.fold_weights(out_w, g2, b2, dt, skip_w)
            else:
                wmat, va, vb = tb.out_weights(out_w, skip_w).to(dt), g2, b2
            sp, sk, sk2 = s0.clone(), s0.clone(), s0.clone()
            want = tb.out_gemm_plain(e, s2, x, wmat, va, vb, norm, K, fold, skip=sp)
            reset_all_counts()
            got = tb.tcn_out_gemm(e, s2, x, wmat, va, vb, norm, K, fold, skip=sk)
            counted(f"tcn_out_gemm_{mode}_skip", 1)
            chk(f"K3 {mode} skip {norm} x", rel_max(got, want), TOL_BF16)
            chk(f"K3 {mode} skip {norm} s (in place)", rel_max(sk, sp), TOL_BF16)
            chk(f"K3 {mode} skip {norm} pad rows zero",
                float(got[:, K:].abs().max() + sk[:, K:].abs().max()), 0.0)
            again = tb.tcn_out_gemm(e, s2, x, wmat, va, vb, norm, K, fold, skip=sk2)
            chk(f"K3 {mode} skip {norm} repeat",
                float((not torch.equal(again, got)) + (not torch.equal(sk2, sk))), 0.0)
        wt = tb.out_weights(out_w, skip_w).t().contiguous().to(dt)
        gn, gsn, cn = nan_pad(g, K), nan_pad(gs, K), nan_pad(c, K)
        args = (gn, wt, cn, s2, a2, g2, norm, K)
        dzp, colp, gs2p = tbb.bwd_dz_plain(*args, gs=gsn)
        reset_all_counts()
        dzk, colk, gs2k = tbb.tcn_bwd_dz(*args, gs=gsn)
        counted("tcn_bwd_dz_skip", 1)
        chk(f"KB1 skip {norm} dz", rel_max(dzk, dzp), TOL_BF16)
        chk(f"KB1 skip {norm} colpart", rel_max(colk.sum(0), colp.sum(0)), TOL_BF16)
        chk(f"KB1 skip {norm} norm2 partials", rel_max(gs2k.sum(red), gs2p.sum(red)), TOL_BF16)
        chk(f"KB1 skip {norm} pad rows zero", float(dzk[:, K:].abs().max()), 0.0)
        chk(f"KB1 skip {norm} repeat", float(sum(not torch.equal(u, v) for u, v in zip(
            (dzk, colk, gs2k), tbb.tcn_bwd_dz(*args, gs=gsn)))), 0.0)
        z = (s2, a2, g2, b2, norm)
        want = tbb.wgrad_plain(c, gn, K, z, gs=gsn).sum(0)
        reset_all_counts()
        part = tbb.tcn_wgrad(c, gn, K, z, gs=gsn)
        counted("tcn_wgrad_out_skip", 1)
        chk(f"KW z skip {norm} d[out_w | skip_w] [{H}, {B + Sc}]",
            rel_max(part.sum(0), want) + float(part.shape[1:] != (H, B + Sc)), TOL_BF16)
        chk(f"KW z skip {norm} repeat",
            float(not torch.equal(tbb.tcn_wgrad(c, gn, K, z, gs=gsn), part)), 0.0)
        db, chpart, gs1, da2part = tbb.tcn_bwd_dwconv(y1, c, dzk, s1, s2, gs2k, a1, g1, b1, w,
                                                      a2, g2, norm, 2, causal, K)
        _, dy1, da1part = tbb.tcn_bwd_dx(db, y1, in_w.t().contiguous(), g, s1, gs1, a1, g1,
                                         norm, K)
        parts = (tbb.tcn_wgrad(c, g, K, z, gs=gs), tbb.tcn_wgrad(x, dy1, K), chpart, colk,
                 da1part, da2part)
        reset_all_counts()
        res[f"kf_max_abs_{norm}"] = kf_check(chk, f"skip {norm}", parts, NB)
        counted("tcn_bwd_finish_skip", 12)  # kf_check: 3 groups x 2 row ranges x 2 launches
        del parts, e, c, y1
    fold_in = (blocks["out_w"], blocks["dw_gamma"], blocks["dw_beta"])
    reset_all_counts()
    got = tb.tcn_fold_weights(*fold_in, dt, blocks["skip_w"])
    counted("tcn_fold_weights_skip", 1)
    want = tb.fold_weights(*fold_in, dt, blocks["skip_w"])
    chk(f"KFW skip NB={NB} wp bit for bit (differing elements)",
        float((got[0] != want[0]).sum()), 0)
    wr = tb.out_weights(blocks["out_w"], blocks["skip_w"]).to(dt).float().abs()
    for name, a, b, v in zip(("g2w", "b2w"), got[1:], want[1:], fold_in[1:]):
        scale = torch.einsum("nh,nhb->nb", v.abs(), wr).clamp_min(1e-30)
        chk(f"KFW skip {name} / sum |v| |W|", float(((a - b).abs() / scale).max()), TOL_F32)
    chk("KFW skip repeat", float(sum(not torch.equal(u, v) for u, v in zip(
        got, tb.tcn_fold_weights(*fold_in, dt, blocks["skip_w"])))), 0)

    # (b) the chains of all NB blocks against their plain stages
    order = ("in_w", "in_prelu", "in_gamma", "in_beta", "dw_w", "dw_prelu", "dw_gamma",
             "dw_beta", "out_w")
    stacked = [blocks[k] for k in order]
    sw = blocks["skip_w"]
    xin = rnd(B)
    norm = cfg.norm_type
    with torch.no_grad():
        reset_all_counts()
        got = whole_tcn(xin, *stacked, norm, False, cfg.X, valid_k=K, skip_w=sw)
        counted("tcn_fold_weights_skip", 1)
        counted("tcn_out_gemm_fold_skip", NB)
        want = whole_tcn_reference(xin, *stacked, norm, False, cfg.X, valid_k=K, skip_w=sw)
    for name, a, b in zip(("x", "s"), got, want):
        res[f"whole_tcn_{name}_rel_l2"] = rel_l2(a, b)
        chk(f"whole_tcn fold chain skip {name} (rel L2)", rel_l2(a, b), TOL_CHAIN_BF16)
        chk(f"whole_tcn fold chain skip {name} pad rows zero", float(a[:, K:].abs().max()), 0.0)
    del got, want
    g = rnd(B, False)

    def train_errors(skip):
        outs = []
        for plain in (True, False):
            leaves = [p.clone().requires_grad_(True) for p in stacked]
            swl = sw.clone().requires_grad_(True) if skip else None
            xl = xin.clone().requires_grad_(True)
            out, s = whole_tcn_train(xl, *leaves, norm, False, cfg.X, valid_k=K, plain=plain,
                                     skip_w=swl)
            torch.autograd.backward((out, s) if skip else out, (g, gs) if skip else g)
            outs.append([out, xl.grad] + [p.grad for p in leaves]
                        + ([s, swl.grad] if skip else []))
        return [rel_l2(a.detach(), b.detach()) for a, b in zip(outs[1], outs[0])]

    reset_all_counts()
    errs = train_errors(True)
    G = finish_plan(M, Kp, B, H, P, tuple(2 ** (i % cfg.X) for i in range(NB)), dt, False,
                    torch.cuda.current_device(), None, Sc)[0]
    groups = -(-NB // G)
    for name in ("tcn_out_gemm_unfold_skip", "tcn_bwd_dz_skip", "tcn_wgrad_out_skip"):
        counted(name, NB)
    counted("tcn_bwd_finish_skip", groups)
    first = train_errors(False)
    names = ("out",) + GRAD_NAMES + ("s", "dskip_w")
    bounds = [max(TOL_BWD_CHAIN_BF16, 2 * e) for e in first] + [TOL_BWD_CHAIN_BF16] * 2
    res["train_op_rel_l2"] = dict(zip(names, errs))
    res["train_op_first_version_rel_l2"] = dict(zip(names, first))
    for name, err, bound in zip(names, errs, bounds):
        chk(f"whole_tcn_train skip {name} (rel L2; first version's x 2 or the tolerance)",
            err, bound)
    del xin, g
    torch.cuda.empty_cache()

    # (c) the hybrid train path's own launches, graphed; the auto forward
    T = K * cfg.L // 2 + cfg.L // 2
    src = torch.randn((M, cfg.C, T), generator=gen, device=dev) * 0.1
    mix, lengths = src.sum(1), torch.full((M,), T, dtype=torch.int32, device=dev)
    opt = Optimizer("adam", lr=1e-3)
    p0 = tree_map(torch.clone, params)
    step = GraphedStep(make_train_step(cfg, opt, 5.0), p0, opt.init(p0), state)
    losses = [float(step(step.params, step.opt_state, step.state, mix, src, lengths)[3])
              for _ in range(2)]  # eager, then captured
    reset_all_counts()
    losses += [float(step(step.params, step.opt_state, step.state, mix, src, lengths)[3])
               for _ in range(SKIP_REPLAYS)]
    torch.cuda.synchronize()
    stats = step.graphed.stats()
    train_counts = {k: v for k, v in all_counts().items() if v}
    res["train_step"] = {"losses": losses, "counts_per_step": {
        k: v / SKIP_REPLAYS for k, v in train_counts.items()}, "graph": stats}
    log(f"  graphed hybrid train step: losses {losses}, launches over {SKIP_REPLAYS} replays "
        f"{train_counts}, {stats}")
    per_step = {"tcn_in_gemm": 2 * NB, "tcn_dwconv_save": NB, "tcn_out_gemm_unfold_skip": NB,
                "tcn_bwd_dz_skip": NB, "tcn_wgrad_out_skip": NB, "tcn_bwd_dwconv": NB,
                "tcn_bwd_dx": NB, "tcn_wgrad_in": NB, "tcn_bwd_finish_skip": -(-NB // G)}
    chk("graphed train step: the launches of SKIP_REPLAYS replays (differing names or counts)",
        float(train_counts != {k: v * SKIP_REPLAYS for k, v in per_step.items()}), 0.0)
    chk("graphed train step: replays", float(stats["replays"] != SKIP_REPLAYS), 0.0)
    chk("graphed train step: losses finite", float(not np.all(np.isfinite(losses))), 0.0)
    del step, p0
    torch.cuda.empty_cache()
    with torch.inference_mode():
        reset_all_counts()
        est, _ = forward(params, state, dataclasses.replace(cfg, use_kernels="auto"), mix)
        fwd_counts = {k: v for k, v in all_counts().items() if v}
        ref_est, _ = forward(params, state, dataclasses.replace(cfg, use_kernels="0"), mix)
    want = {"tcn_fold_weights_skip": 1, "tcn_in_gemm": NB, "tcn_dwconv": NB,
            "tcn_out_gemm_fold_skip": NB}
    chk("auto forward: launches (differing names or counts)", float(fwd_counts != want), 0.0)
    res["auto_vs_eager_rel_l2"] = rel_l2(est, ref_est)
    chk("auto forward vs eager (bf16, rel L2)", res["auto_vs_eager_rel_l2"], TOL_E2E_BF16)
    torch.cuda.synchronize()
    chk.done()

    # (d) the six kernels' times
    rows = time_kernels(skip_kernel_specs(blocks, cfg, dev, M, K),
                        f"M={M}, K_pad={Kp}, B={B}, Sc={Sc}, H={H}")
    kernels = [{"name": k, **{kk: vv for kk, vv in v.items() if kk != "turns_ms"}}
               for k, v in rows.items()]
    check_cold(kernels)
    return res, kernels


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
                        sp = tbb._kb2_plan(cfg.P, d, cfg.H, dt, M, Kp, dev.index)
                        log(f"  plans at d={d}: K2 {tuple(tb.dw_plan(cfg.P, d, cfg.H, 2)[:3])} "
                            f"(rows, channels, lanes), KB2 strips of {sp.strip} rows x "
                            f"{sp.cols} channels, ring {sp.ring * sp.chunk} rows, {sp.stages} "
                            f"stages of {sp.chunk} rows, {sp.grid} CTAs")
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
                        # KF on the kernels' partials of this block
                        parts = (tbb.tcn_wgrad(c, g, K, z), tbb.tcn_wgrad(x, dy1, K), chpk,
                                 colk, da1k, da2k)
                        kf = kf_check(chk, what, parts, len(stacked[0]))
                        if dt == torch.bfloat16:
                            errs["tcn_bwd_finish"] = max(errs["tcn_bwd_finish"], kf)
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
    # Gradients repeat bit for bit, whatever KF's group (1, 3 with a group
    # of two last, all NB blocks: the default at these shapes).
    x, g = x32.to(torch.bfloat16), g32.to(torch.bfloat16)
    _, x_res, c_res, s2 = chain_save(x, *stacked, "gLN", False, cfg.X, K)
    a = whole_tcn_bwd(g, x_res, c_res, s2, *stacked, "gLN", False, cfg.X, K)
    b = whole_tcn_bwd(g, x_res, c_res, s2, *stacked, "gLN", False, cfg.X, K)
    chk("whole_tcn_bwd bf16 two runs, differing tensors",
        float(sum(not torch.equal(u, v) for u, v in zip(a, b))), 0.0)
    for group in (1, 3):
        tbb.reset_counts()
        b = whole_tcn_bwd(g, x_res, c_res, s2, *stacked, "gLN", False, cfg.X, K, group=group)
        chk(f"whole_tcn_bwd bf16, KF in groups of {group} against one group, differing tensors",
            float(sum(not torch.equal(u, v) for u, v in zip(a, b))), 0.0)
        chk(f"whole_tcn_bwd bf16, KF launches in groups of {group}",
            abs(tbb.counts()["tcn_bwd_finish"] - -(-len(stacked[0]) // group)), 0.0)
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


def per_step_launches(form, NB, kf):
    """Kernel launches of one train step of `form` (see ops/kernels), with
    `kf` KF launches (kf_launches: one per group of blocks)."""
    bwd = {k: NB for k in ("tcn_bwd_dz", "tcn_wgrad_out", "tcn_bwd_dwconv", "tcn_bwd_dx",
                           "tcn_wgrad_in")}
    bwd["tcn_bwd_finish"] = kf
    if form == "hybrid":
        return dict(tcn_in_gemm=2 * NB, tcn_dwconv=0, tcn_dwconv_save=NB,
                    tcn_out_gemm_fold=0, tcn_out_gemm_unfold=NB, **bwd)
    if form == "whole":
        return dict(tcn_in_gemm=2 * NB, tcn_dwconv=NB, tcn_dwconv_save=NB,
                    tcn_out_gemm_fold=0, tcn_out_gemm_unfold=NB, **bwd)
    return {}


def kf_launches(cfg, M, T):
    """KF launches of one train step of the kernel forms at M items of T
    samples: one per group of blocks (whole_tcn_hybrid.finish_plan on this
    card: at the paper config every batch up to 8 is one group of 32)."""
    from convtasnet_torch.ops.kernels import tcn_block as tb
    from convtasnet_torch.ops.kernels.whole_tcn_hybrid import finish_plan

    NB = cfg.R * cfg.X
    Kp = -(-cfg.num_frames(T) // tb.ROW_ALIGN) * tb.ROW_ALIGN
    G = finish_plan(M, Kp, cfg.B, cfg.H, cfg.P, tuple(2 ** (i % cfg.X) for i in range(NB)),
                    cfg.dtype, False, torch.cuda.current_device())[0]
    return -(-NB // G)


def cv_forwards(out, n_cv):
    """CV forwards a train CLI run executed over `n_cv` CV batches: one per
    batch, plus the side-stream warm-up of each captured CV key
    (models/graphed.py; a train step's warm-up is its one update)."""
    from convtasnet_torch.models import graphed

    return n_cv + graphed.CAPTURE_WARMUP * out["graphs"]["cv_step"]["captures"]


def train_phase(cfg, dev, tmp):
    """The train CLI at the paper config and one train step of each form;
    returns (step-time medians, the hybrid run: its argv and result)."""
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
    cv_launch = auto_launches(NB)
    base = ["--train_dir", tr, "--valid_dir", cv, "--batch_size", "5", "--device", str(dev),
            "--num_workers", "2", "--print_freq", "1", "--seed", "0",
            "--norm_type", cfg.norm_type, "--compute_dtype", cfg.compute_dtype]
    for k in ("N", "L", "B", "H", "P", "X", "R", "C"):
        base += [f"--{k}", str(getattr(cfg, k))]
    path_counts, runs = {}, {}
    for form in ("hybrid", "whole", "0"):
        folder = os.path.join(tmp, f"exp_{form}")
        argv = base + ["--use_kernels", form, "--epochs", "1", "--checkpoint", "1",
                       "--save_every_steps", "1"]
        reset_all_counts()
        t0 = time.perf_counter()
        out = train_main(argv + ["--save_folder", folder])
        runs[form] = {"argv": argv, "out": out, "tr": tr}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_counts()
        path_counts[form] = counts
        log(f"train --use_kernels {form}: {out['steps']} steps + {n_cv} CV forwards in "
            f"{wall:.2f} s, tr_loss {out['tr_loss']}, cv_loss {out['cv_loss']}, launches {counts}")
        chk(f"train {form}: steps", abs(out["steps"] - steps), 0)
        chk(f"train {form}: losses finite",
            float(not np.all(np.isfinite(out["tr_loss"] + out["cv_loss"]))), 0)
        per = per_step_launches(form, NB, kf_launches(cfg, 5, 4 * SR))
        cv_runs = cv_forwards(out, n_cv)
        for k, v in counts.items():
            want = steps * per.get(k, 0) + (cv_runs * cv_launch.get(k, 0) if form != "0" else 0)
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
            chk(f"one {form} step: {k} launches",
                abs(v - per_step_launches(form, NB, kf_launches(c, 5, 4 * SR)).get(k, 0)), 0)
        ms, n = forward_ms(lambda: step(params, opt_state, state, mix, src, lens), iters=10,
                           warm=2)
        timing[f"train_step_batch5_{form}_ms"] = ms
        timing[f"train_step_batch5_{form}_audio_s_per_s"] = 5 * 4.0 / (ms / 1e3)
        log(f"  train step batch 5 x 4 s, --use_kernels {form}: median {ms:.3f} ms of {n} "
            f"({5 * 4.0 / (ms / 1e3):.1f} audio-s/s)")
    torch.cuda.synchronize()
    chk.done()
    return timing, runs["hybrid"]

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
    # launches per forward (one per utterance) of each form
    want_launch = {"auto": auto_launches(NB),
                   "block": dict(tcn_in_gemm=NB, tcn_dwconv=NB, tcn_out_gemm_unfold=NB),
                   "0": {}}
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
            chk(f"{tag}: {k} launches", abs(v - want_launch[form].get(k, 0) * n_utts), 0)
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
                recs = timed(lambda: sdr_improvement_batch(src, est, mix, dtype=dtype),
                             iters=5, warm=0, label="device BSS-Eval").records or {}
                ops = sorted(((us / 5 / 1e3, k) for k, (_, us) in recs.items()), reverse=True)
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
    return timing, sets


# The graph phase's separate set: 24 mixtures of 3.6-4.0 s and 16 of
# 1.6-2.0 s at --batch_size 8 --pad_to_multiple 8000: three batches of
# [8, 32000] and two of [8, 16000], so both shapes come again.
GRAPH_SEP_SECS = [4.0 - 0.4 * i / 23 for i in range(24)] + [2.0 - 0.4 * i / 15 for i in range(16)]
GRAPH_SEP_PAD = 8000
# Evaluate at batch 1: every harmonic utterance (2.5-10 s) pads to 10 s and
# every broadband one (3-6 s) to 6 s, so each set is one shape.
GRAPH_EVAL_PAD = {"harmonic": 80000, "broadband": 48000}


def _graph_forward_case(chk, what, fn, mix, tag, want_kernels):
    """One forward captured and replayed against its eager run: bit for bit,
    launches per replay, each kernel's launches per forward as
    `want_kernels` says (every other counter 0), event ms eager / graphed
    (median of 20), device busy and idle share of each, capture ms and
    pool bytes."""
    from convtasnet_torch.models import graphed

    torch.cuda.synchronize()
    ref = fn(mix)
    reset_all_counts()
    fn(mix)
    torch.cuda.synchronize()
    per_eager = all_counts()
    g = graphed.GraphedForward(fn, tag=tag)
    g(mix)          # eager first call
    first = g(mix)  # warm-up, capture, replay
    reset_all_counts()
    graphed.reset_counts()
    outs = [g(mix) for _ in range(3)]
    torch.cuda.synchronize()
    per_replay, calls = all_counts(), graphed.counts()
    chk(f"{what}: graphed == eager kernel forward, bit for bit",
        float(sum(not torch.equal(o, ref) for o in [first] + outs)), 0)
    chk(f"{what}: 3 replays, no eager call", abs(calls["replays"] - 3) + calls["eager_calls"], 0)
    chk(f"{what}: launches per replay == per eager forward {per_eager}",
        max(abs(per_replay[k] - 3 * v) for k, v in per_eager.items()), 0)
    for k, v in per_eager.items():
        chk(f"{what}: {k} launches per forward == {want_kernels.get(k, 0)}",
            abs(v - want_kernels.get(k, 0)), 0)
    info = next(iter(g.graphs().values()))
    res = {"eager_ms": forward_ms(lambda: fn(mix))[0], "graphed_ms": forward_ms(lambda: g(mix))[0],
           "eager_busy_ms": device_ms(lambda: fn(mix), iters=10),
           "graphed_busy_ms": device_ms(lambda: g(mix), iters=10),
           "capture_ms": info["capture_ms"], "pool_bytes": info["pool_bytes"],
           "launches_per_forward": per_eager}
    for side in ("eager", "graphed"):
        res[f"{side}_idle_share"] = max(0.0, 1.0 - res[f"{side}_busy_ms"] / res[f"{side}_ms"])
    log(f"  {what}: eager {res['eager_ms']:.3f} ms (busy {res['eager_busy_ms']:.3f}, idle "
        f"{res['eager_idle_share']:.3f}), graphed {res['graphed_ms']:.3f} ms (busy "
        f"{res['graphed_busy_ms']:.3f}, idle {res['graphed_idle_share']:.3f}); capture "
        f"{res['capture_ms']:.1f} ms, pool {res['pool_bytes'] / 1e6:.1f} MB")
    del g
    return res


def _graph_shared_pool_case(chk, fn, mixes):
    """One wrapper over several keys, whose graphs share one pool: each
    captured, then all replayed in turn in another order, each bit for bit
    against its eager forward."""
    from convtasnet_torch.models import graphed

    want = [fn(m) for m in mixes]
    g = graphed.GraphedForward(fn)
    for m in mixes:
        g(m), g(m)  # eager first call, then capture and replay
    order = [i for _ in range(2) for i in reversed(range(len(mixes)))]
    wrong = sum(not torch.equal(g(mixes[i]), want[i]) for i in order)
    torch.cuda.synchronize()
    chk(f"shared pool: {len(mixes)} keys replayed in turn == eager, bit for bit",
        float(wrong) + abs(len(g.graphs()) - len(mixes)), 0)
    pools = [v["pool_bytes"] for v in g.graphs().values()]
    log(f"  shared pool: bytes added per capture {pools}")
    return pools


def graph_phase(cfg, dev, params, state, ckpt, eval_sets, tmp):
    """The forwards as CUDA graphs (models/graphed.GraphedForward): (a) the
    paper config at batch 8 and 1 x 4 s, auto and block, and the scaled
    config at batch 1 and 2 x 8 s, each graphed against its eager kernel
    forward, and three paper-config keys of one wrapper replayed in turn;
    (b) the separate CLI over a set whose shapes repeat, graphed
    against a run with the cap at 0 (every call eager): byte-equal wavs,
    captures == shapes seen twice; (c) the evaluate CLI with --cal_sdr 1
    on the evaluate phase's tt sets, padded to one shape per set, graphed
    against eager: equal SI-SNRi and SDRi, steady ms per utterance."""
    from convtasnet_torch.cli.evaluate import build_parser, evaluate
    from convtasnet_torch.cli.separate import main as separate_main
    from convtasnet_torch.config import ConvTasNetConfig
    from convtasnet_torch.data.wavio import write_wav
    from convtasnet_torch.models import graphed
    from convtasnet_torch.models.conv_tasnet import forward, init_params
    from convtasnet_torch.tools import bench_scaled_config as bsc
    from convtasnet_torch.tools._bench import device_batch

    chk = Checks("graph phase")
    NB = cfg.R * cfg.X
    res = {"forward": {}}
    want = {"auto": auto_launches(NB),
            "block": dict(tcn_in_gemm=NB, tcn_dwconv=NB, tcn_out_gemm_unfold=NB)}
    log(" (a) forwards, graphed vs eager kernel forward:")
    with torch.inference_mode():
        mixes = []
        for bs in (8, 1):
            mix = torch.from_numpy(np.random.default_rng(bs).normal(size=(bs, 4 * SR))
                                   .astype(np.float32)).to(dev)
            mixes.append(mix)
            for form in ("auto", "block"):
                c = ConvTasNetConfig(use_kernels=form)
                res["forward"][f"paper_batch{bs}_{form}"] = _graph_forward_case(
                    chk, f"paper batch {bs} x 4 s {form}",
                    lambda m, c=c: forward(params, state, c, m)[0], mix,
                    (c.kernel_form(False, dev),), want[form])
        c = ConvTasNetConfig(use_kernels="auto")
        res["shared_pool_bytes"] = _graph_shared_pool_case(
            chk, lambda m: forward(params, state, c, m)[0],
            mixes + [mixes[0][:4, :2 * SR].contiguous()])
        scfg = bsc.scaled_cfg(use_kernels="auto")
        sparams, sstate = init_params(torch.Generator(device=dev).manual_seed(0), scfg,
                                      device=dev)
        for bs in (1, 2):
            mix = device_batch(1, bs, scfg.C, int(SCALED_SEG_S * bsc.SR), bsc.SR, dev)[0]
            res["forward"][f"scaled_batch{bs}_auto"] = _graph_forward_case(
                chk, f"scaled batch {bs} x 8 s auto",
                lambda m: forward(sparams, sstate, scfg, m)[0], mix,
                (scfg.kernel_form(False, dev),), auto_launches(scfg.R * scfg.X))
        del sparams, sstate
    torch.cuda.empty_cache()

    log(" (b) separate CLI, shapes repeating, graphed vs eager (cap 0):")
    mix_dir = os.path.join(tmp, "graph_mix")
    rng = np.random.default_rng(21)
    for i, sec in enumerate(GRAPH_SEP_SECS):
        n = int(sec * SR)
        t = np.arange(n) / SR
        write_wav(os.path.join(mix_dir, f"g{i:02d}.wav"),
                  0.3 * np.sin(2 * np.pi * (150 + 11 * i) * t) + 0.05 * rng.normal(size=n), SR)
    wavs, calls = {}, {}
    for run, cap in (("eager", 0), ("graphed", graphed.MAX_GRAPHS)):
        out_dir = os.path.join(tmp, f"graph_out_{run}")
        saved, graphed.MAX_GRAPHS = graphed.MAX_GRAPHS, cap
        reset_all_counts()
        graphed.reset_counts()
        t0 = time.perf_counter()
        try:
            written = separate_main(["--model_path", ckpt, "--mix_dir", mix_dir,
                                     "--out_dir", out_dir, "--batch_size", "8",
                                     "--pad_to_multiple", str(GRAPH_SEP_PAD),
                                     "--use_kernels", "auto", "--device", "cuda"])
        finally:
            graphed.MAX_GRAPHS = saved
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls[run], launches = graphed.counts(), all_counts()
        log(f"  separate {run}: {written} mixtures in {wall:.2f} s; {calls[run]}; "
            f"launches {launches}")
        res[f"separate_{run}_s"] = wall
        chk(f"separate {run}: mixtures written", abs(written - len(GRAPH_SEP_SECS)), 0)
        executed = calls[run]["eager_calls"] + calls[run]["replays"] + (
            graphed.CAPTURE_WARMUP * calls[run]["captures"])
        for k, v in launches.items():
            chk(f"separate {run}: {k} launches == {want['auto'].get(k, 0)} per executed "
                f"forward ({executed})", abs(v - want["auto"].get(k, 0) * executed), 0)
        wavs[run] = {}
        for f in sorted(glob.glob(os.path.join(out_dir, "*.wav"))):
            with open(f, "rb") as fh:
                wavs[run][os.path.basename(f)] = fh.read()
    chk("separate: 3 wavs per mixture", abs(len(wavs["graphed"]) - 3 * len(GRAPH_SEP_SECS)), 0)
    chk("separate: graphed wavs byte-equal to eager",
        float(wavs["graphed"] != wavs["eager"]), 0)
    # 5 batches in two shapes ([8, 32000] three times, [8, 16000] twice).
    chk("separate eager: every call eager", abs(calls["eager"]["eager_calls"] - 5)
        + calls["eager"]["captures"], 0)
    chk("separate graphed: captures == shapes seen twice (2)",
        abs(calls["graphed"]["captures"] - 2), 0)
    chk("separate graphed: 2 eager first calls, 3 replays",
        abs(calls["graphed"]["eager_calls"] - 2) + abs(calls["graphed"]["replays"] - 3), 0)

    log(" (c) evaluate CLI --cal_sdr 1, one shape per set, graphed vs eager (cap 0):")
    for name, pad in GRAPH_EVAL_PAD.items():
        data_dir, n_utts = eval_sets[name]
        got = {}
        for run, cap in (("eager", 0), ("graphed", graphed.MAX_GRAPHS)):
            utts, stamps = [], []

            def stamp(line):
                if line.startswith("Utt "):
                    stamps.append(time.perf_counter())

            saved, graphed.MAX_GRAPHS = graphed.MAX_GRAPHS, cap
            graphed.reset_counts()
            try:
                out = evaluate(build_parser().parse_args(
                    ["--model_path", ckpt, "--data_dir", data_dir, "--cal_sdr", "1",
                     "--sdr_backend", "device", "--use_kernels", "auto",
                     "--pad_to_multiple", str(pad), "--device", "cuda"]),
                    log=stamp, utterances=utts)
            finally:
                graphed.MAX_GRAPHS = saved
            torch.cuda.synchronize()
            n = graphed.counts()
            steady = (stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3
            res[f"evaluate_{name}_{run}_steady_ms_per_utt"] = steady
            got[run] = (out, utts, n)
            log(f"  evaluate {name} {run}: SI-SNRi {out['si_snri']:.6f} dB, SDRi "
                f"{out['sdri']:.6f} dB, {steady:.2f} ms per utterance after the first; {n}")
        (e, eu, en), (g_, gu, gn) = got["eager"], got["graphed"]
        chk(f"evaluate {name}: count", abs(g_["count"] - n_utts) + abs(e["count"] - n_utts), 0)
        chk(f"evaluate {name}: eager run all eager", abs(en["eager_calls"] - n_utts), 0)
        chk(f"evaluate {name}: one capture, the rest replays",
            abs(gn["captures"] - 1) + abs(gn["replays"] - (n_utts - 1)), 0)
        worst = max(max(abs(a["si_snri"] - b["si_snri"]), abs(a["sdri"] - b["sdri"]))
                    for a, b in zip(gu, eu))
        chk(f"evaluate {name}: graphed SI-SNRi / SDRi == eager, worst utterance (dB)",
            worst, 0.0)
        chk(f"evaluate {name}: graphed reordered estimates == eager",
            float(sum(not np.array_equal(a["estimate"], b["estimate"])
                      for a, b in zip(gu, eu))), 0)
    res["graphs_live_after"] = graphed.counts()["graphs"]
    log(f"graph phase: {json.dumps(res)}")
    chk.done()
    return res


# Mixture lengths in samples (2-5.9 s): 16000 and 47200 are multiples of the
# 160-sample chunk (20 ms), 26403 and 37517 are not.
STREAM_LENGTHS = (16000, 26403, 37517, 47200)
STREAM_CHUNK_MS = 20.0
STREAM_TIMING = [(10.0, 1), (20.0, 1), (40.0, 1), (20.0, 16), (20.0, 64), (20.0, 256),
                 (20.0, 1024)]


def _streamed(sep, block, chunk):
    """Streamed output of a [M, n * chunk] block (host or device), pushed
    chunk by chunk, then the flush."""
    outs = [sep.push(block[:, k:k + chunk]) for k in range(0, block.shape[1], chunk)]
    return torch.cat(outs + [sep.flush()], dim=-1)


def stream_phase(cfg16, dev, tmp):
    """The streaming path at `cfg16`, the causal paper config (cLN, causal,
    bf16; an f32 copy of the same seeded weights beside it): the separate
    CLI (--use_kernels auto and 0, padded to the chunk multiple) as the
    offline reference, the stream CLI at --batch 1 and 4, the array checks
    of StreamingSeparator against forward, push() under strict_mode, and ms
    per chunk, RTF, device busy and device operations per chunk, eager and
    graphed. Returns its timings."""
    import dataclasses

    from convtasnet_torch.cli.separate import main as separate_main
    from convtasnet_torch.cli.stream import chunk_samples, main as stream_main
    from convtasnet_torch.data.wavio import read_wav, write_wav
    from convtasnet_torch.models.conv_tasnet import forward, init_params
    from convtasnet_torch.models.streaming import StreamingSeparator
    from convtasnet_torch.ops.kernels import tcn_block as tb
    from convtasnet_torch.tools.bench_streaming import measure
    from convtasnet_torch.training.checkpoint import save_checkpoint
    from convtasnet_torch.utils.debugging import strict_mode

    chk = Checks("stream phase")
    cfg32 = dataclasses.replace(cfg16, compute_dtype="float32")
    NB = cfg16.R * cfg16.X
    params, state = init_params(torch.Generator(device=dev).manual_seed(4321), cfg16, device=dev)
    ckpt = {"bf16": os.path.join(tmp, "causal_bf16.ckpt"),
            "f32": os.path.join(tmp, "causal_f32.ckpt")}
    save_checkpoint(ckpt["bf16"], cfg16, params, state)
    save_checkpoint(ckpt["f32"], cfg32, params, state)
    mix_dir = os.path.join(tmp, "stream_mix")
    rng = np.random.default_rng(21)
    for i, n in enumerate(STREAM_LENGTHS):
        t = np.arange(n) / SR
        sig = (0.25 * np.sin(2 * np.pi * (150 + 55 * i) * t)
               + 0.2 * np.sin(2 * np.pi * (700 + 90 * i) * t) + 0.05 * rng.normal(size=n))
        write_wav(os.path.join(mix_dir, f"s{i}.wav"), sig, SR)
    lengths = list(STREAM_LENGTHS)
    chunk = chunk_samples(STREAM_CHUNK_MS, SR, cfg16.L, cfg16.stride)
    log(f"  {len(lengths)} mixtures of {lengths} samples; chunk {chunk} samples; "
        f"multiples of the chunk: {[n % chunk == 0 for n in lengths]}")
    timing = {}

    def wavs(out_dir):
        got = {}
        for i, n in enumerate(lengths):
            for c in range(cfg16.C):
                f = f"s{i}_s{c + 1}.wav"
                y, _ = read_wav(os.path.join(out_dir, f))
                chk(f"{os.path.basename(out_dir)}: {f} length", abs(len(y) - n), 0)
                chk(f"{os.path.basename(out_dir)}: {f} finite", float(not np.all(np.isfinite(y))), 0)
                got[f] = y
        chk(f"{os.path.basename(out_dir)}: wav count",
            abs(len(glob.glob(os.path.join(out_dir, "*.wav"))) - 3 * len(lengths)), 0)
        return got

    # Offline references: the separate CLI padded to the chunk multiple, so
    # that it sees the frames the streams see.
    offline = {}
    for dt, form, bs in (("bf16", "auto", 1), ("bf16", "0", 1), ("f32", "0", 1), ("f32", "0", 4)):
        out_dir = os.path.join(tmp, f"sep_{dt}_{form}_b{bs}")
        tb.reset_counts()
        t0 = time.perf_counter()
        n = separate_main(["--model_path", ckpt[dt], "--mix_dir", mix_dir, "--out_dir", out_dir,
                           "--batch_size", str(bs), "--pad_to_multiple", str(chunk),
                           "--use_kernels", form, "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = tb.counts()
        log(f"  separate {dt} --use_kernels {form} --batch_size {bs}: {n} mixtures in "
            f"{wall:.2f} s, launches {counts}")
        chk(f"separate {dt} {form} b{bs}: mixtures written", abs(n - len(lengths)), 0)
        want = auto_launches(NB) if form == "auto" else {}
        for k, v in counts.items():
            chk(f"separate {dt} {form} b{bs} (cLN, causal): {k} launches",
                abs(v - want.get(k, 0) * -(-len(lengths) // bs)), 0)
        offline[(dt, form, bs)] = wavs(out_dir)

    # The stream CLI: the block kernel in bf16 (R * X launches a chunk), no
    # other kernel; the library ops in f32.
    for dt, bs in (("bf16", 1), ("f32", 1), ("f32", 4)):
        out_dir = os.path.join(tmp, f"stream_{dt}_b{bs}")
        tb.reset_counts()
        t0 = time.perf_counter()
        n = stream_main(["--model_path", ckpt[dt], "--mix_dir", mix_dir, "--out_dir", out_dir,
                         "--chunk_ms", str(STREAM_CHUNK_MS), "--batch", str(bs),
                         "--device", str(dev)])
        wall = time.perf_counter() - t0
        log(f"  stream {dt} --batch {bs}: {n} mixtures in {wall:.2f} s")
        timing[f"stream_cli_{dt}_b{bs}_wall_s"] = wall
        chk(f"stream {dt} b{bs}: mixtures written", abs(n - len(lengths)), 0)
        sbl = tb.counts()["tcn_stream_block"]
        chk(f"stream {dt} b{bs}: launches of other kernels",
            sum(tb.counts().values()) - sbl, 0)
        ok = sbl > 0 and sbl % NB == 0 if dt == "bf16" else sbl == 0
        chk(f"stream {dt} b{bs}: block kernel launches ({sbl}; bf16 a positive multiple of "
            "R * X, f32 none)", float(not ok), 0)
        got = wavs(out_dir)
        if dt == "f32":
            ref = offline[("f32", "0", bs)]
            chk(f"stream f32 b{bs} vs separate f32 0 b{bs} wavs (max abs, PCM16)",
                max(float(np.abs(got[f] - ref[f]).max()) for f in got), TOL_PCM16)
        else:
            a = np.concatenate([got[f] for f in sorted(got)])
            for form in ("auto", "0"):
                b = np.concatenate([offline[("bf16", form, 1)][f] for f in sorted(got)])
                chk(f"stream bf16 b1 vs separate bf16 {form} b1 wavs (rel L2)",
                    rel_l2(torch.from_numpy(a), torch.from_numpy(b)), TOL_E2E_BF16)

    # Arrays: StreamingSeparator against forward on the padded group block.
    mixes = [read_wav(os.path.join(mix_dir, f"s{i}.wav"))[0] for i in range(len(lengths))]
    Tpad = -(-max(lengths) // chunk) * chunk
    block = torch.zeros((len(mixes), Tpad))
    for i, m in enumerate(mixes):
        block[i, : len(m)] = torch.from_numpy(m)
    cfgs = {"f32": cfg32, "bf16": cfg16}
    streamed, off = {}, {}
    with torch.no_grad():
        for dt, c in cfgs.items():
            for form in ("auto", "0"):
                off[(dt, form)], _ = forward(params, state, dataclasses.replace(c, use_kernels=form),
                                             block.to(dev))
            for graph in (True, False):
                sep = StreamingSeparator(c, params, batch=len(mixes), device=dev, graph=graph)
                streamed[(dt, graph)] = _streamed(sep, block, chunk)
                chk(f"streamed {dt} graph={graph} shape",
                    float(tuple(streamed[(dt, graph)].shape) != (len(mixes), cfg16.C, Tpad)), 0)
                del sep
    s32 = streamed[("f32", True)]
    chk("streamed (graphed) vs offline eager, f32, TF32 off (rel L2)", rel_l2(s32, off[("f32", "0")]),
        TOL_F32)
    chk("streamed (graphed) vs offline auto, f32 (rel L2)", rel_l2(s32, off[("f32", "auto")]),
        TOL_E2E_F32)
    for form in ("auto", "0"):
        chk(f"streamed (graphed) vs offline {form}, bf16 (rel L2)",
            rel_l2(streamed[("bf16", True)], off[("bf16", form)]), TOL_E2E_BF16)
    chk("graphed vs eager StreamingSeparator, f32 (rel L2)", rel_l2(s32, streamed[("f32", False)]),
        TOL_F32)
    for dt in cfgs:
        same = torch.equal(streamed[(dt, True)], streamed[(dt, False)])
        timing[f"graphed_eager_identical_bytes_{dt}"] = same
        log(f"  graphed vs eager {dt}: identical bytes {same}, rel L2 "
            f"{rel_l2(streamed[(dt, True)], streamed[(dt, False)]):.3e}")

    # Batch 4 against each stream alone, and reset() against fresh separators,
    # over the first 2 s of the block.
    short = block[:, : 100 * chunk]
    with torch.no_grad():
        together = _streamed(StreamingSeparator(cfg32, params, batch=4, device=dev), short, chunk)
        alone = [_streamed(StreamingSeparator(cfg32, params, batch=1, device=dev), short[i:i + 1],
                           chunk) for i in range(4)]
        for i in range(4):
            chk(f"batch-4 stream {i} vs the stream alone, f32 (rel L2)",
                rel_l2(together[i:i + 1], alone[i]), TOL_F32)
        sep = StreamingSeparator(cfg32, params, batch=1, device=dev)
        for i in range(2):
            if i:
                sep.reset()
            again = _streamed(sep, short[i:i + 1], chunk)
            chk(f"utterance {i} after {'reset()' if i else 'construction'} vs a fresh separator, "
                f"f32 (rel L2; identical bytes {torch.equal(again, alone[i])})",
                rel_l2(again, alone[i]), TOL_F32)
        del sep

    # push() without a host synchronisation, graphed and eager (bf16, batch
    # 1): chunks from pinned host memory; the fetch after strict_mode.
    pinned = [short[:1, k:k + chunk].clone().pin_memory() for k in range(0, 20 * chunk, chunk)]
    for graph in (True, False):
        sep = StreamingSeparator(cfg16, params, batch=1, device=dev, graph=graph)
        for _ in range(2):  # the first-chunk step captured at its second call
            for c in pinned[:3]:
                sep.push(c)
            sep.reset()
        err = ""
        try:
            with strict_mode():
                outs = [sep.push(c) for c in pinned]
        except RuntimeError as e:
            err = str(e)[:200]
        chk(f"push() graph={graph} under strict_mode: host synchronisations ({err})",
            float(bool(err)), 0)
        if not err:
            chk(f"push() graph={graph} under strict_mode: outputs finite",
                float(not torch.isfinite(torch.cat(outs, -1)).all()), 0)
        del sep
    torch.cuda.synchronize()

    # ms per chunk (a host fetch per chunk), device busy and operations per
    # chunk, eager and graphed, bf16.
    points = []
    for ms, bs in STREAM_TIMING:
        c_len = int(SR * ms / 1000)
        for graph in (False, True):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            row = measure(cfg16, params, bs, c_len, SR, 50, graph, dev)
            row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            points.append(row)
            busy = "not measured" if row["device_busy_ms"] is None else f"{row['device_busy_ms']:.3f} ms"
            ops = "not measured" if row["ops_per_chunk"] is None else f"{row['ops_per_chunk']:.1f}"
            log(f"  stream {ms:g} ms chunk, batch {bs}, {'graphed' if graph else 'eager'}: median "
                f"{row['latency_ms']:.3f} ms per chunk (p90 {row['latency_p90_ms']:.3f}) of "
                f"{row['steps']}, RTF {row['rtf']:.4f}; set-up pushes {row['setup_ms']:.1f} ms; "
                f"device busy {busy}, device ops {ops} per chunk; peak {row['peak_mem_gb']:.2f} GB")
    for graph in (False, True):
        rt = [r["batch"] for r in points if r["chunk_ms"] == STREAM_CHUNK_MS
              and r["graph"] == graph and r["rtf"] < 1.0]
        best = max(rt) if rt else 0
        timing[f"largest_rt_batch_20ms_{'graphed' if graph else 'eager'}"] = best
        log(f"  largest batch with RTF < 1 at {STREAM_CHUNK_MS:g} ms chunks, "
            f"{'graphed' if graph else 'eager'}: {best} (of {[b for m, b in STREAM_TIMING if m == STREAM_CHUNK_MS]})")
    timing["points"] = points
    log(f"stream phase timing: {json.dumps(timing)}")
    chk.done()
    return timing


# ---- the stream chunk step's block kernel ----------------------------------

STREAM_KEYS = ("in_w", "in_prelu", "in_gamma", "in_beta", "dw_w", "dw_prelu", "dw_gamma",
               "dw_beta", "out_w")
# Relative L2 of one block's increment x' - x and of its new history, the
# kernel against stream_block_plain in bf16 (tests/test_torch_cuda.py's
# STREAM_BLOCK_TOL).
TOL_STREAM_BLOCK = 1e-2


def stream_block_phase(dev, B=256, H=512, P=3):
    """The stream chunk step's TCN-block kernel (csrc/tcn_stream_block.cu) at
    the causal config's widths against its plain version, stream_block_plain,
    in bf16: every dilation 1..128, Kc 1, 15, 16 and 300 frames (below and
    above every span), M = 1 and 4 streams, two chunks in a row (the history
    carried): the block's increment x' - x and the new history (relative
    L2), the frames carried over from the old history bit for bit, one
    launch a call. Then, per dilation at M = 1 and Kc = 16 (one 20 ms chunk),
    its device ms a launch warm and with cold L2 beside its byte bound (in_w,
    out_w, taps and affines, x in and out, the history read and written) and
    the plain version's device ms. Returns the readings and the timing row."""
    from convtasnet_torch.ops.kernels import stream_block as sb

    chk = Checks("stream block phase")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4321)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    bp = {"in_w": randn(B, H, scale=(2 / (B + H)) ** 0.5).to(bf),
          "in_prelu": torch.tensor(0.25, device=dev).to(bf),
          "in_gamma": 1 + randn(H, scale=0.1), "in_beta": randn(H, scale=0.1),
          "dw_w": randn(P, H, scale=0.5).to(bf),
          "dw_prelu": torch.tensor(0.25, device=dev).to(bf),
          "dw_gamma": 1 + randn(H, scale=0.1), "dw_beta": randn(H, scale=0.1),
          "out_w": randn(H, B, scale=(2 / (B + H)) ** 0.5).to(bf)}
    dilations = [2 ** i for i in range(8)]
    worst = {"x": 0.0, "hist": 0.0}
    readings = []
    for d in dilations:
        span = (P - 1) * d
        for Kc in (1, 15, 16, 300):
            for M in (1, 4):
                hist = randn(M, span, H).to(bf)
                want_h = hist.clone()
                for step in range(2):
                    old = hist.clone()
                    x = randn(M, Kc, B).to(bf)
                    want, want_h = sb.stream_block_plain(x, want_h, bp, d, bf)
                    before = all_counts()["tcn_stream_block"]
                    got, got_h = sb.stream_block(x, hist, bp, d, bf)
                    once = all_counts()["tcn_stream_block"] == before + 1
                    torch.cuda.synchronize()
                    ex = rel_l2(got.float() - x.float(), want.float() - x.float())
                    eh = rel_l2(got_h, want_h) if span else 0.0
                    carried = (torch.equal(got_h[:, : span - Kc], old[:, Kc:])
                               if Kc < span else True)
                    readings.append({"dilation": d, "Kc": Kc, "M": M, "chunk": step,
                                     "x_rel_l2": ex, "hist_rel_l2": eh})
                    worst["x"], worst["hist"] = max(worst["x"], ex), max(worst["hist"], eh)
                    bad = (ex > TOL_STREAM_BLOCK or eh > TOL_STREAM_BLOCK or not carried
                           or not once or got_h is not hist)
                    if bad:
                        chk(f"stream block d={d} Kc={Kc} M={M} chunk {step}: x' - x (rel L2)",
                            ex, TOL_STREAM_BLOCK)
                        chk(f"stream block d={d} Kc={Kc} M={M} chunk {step}: history (rel L2)",
                            eh, TOL_STREAM_BLOCK)
                        chk(f"stream block d={d} Kc={Kc} M={M} chunk {step}: carried frames "
                            "bit for bit, one launch, history in place",
                            float(not carried or not once or got_h is not hist), 0)
    n = len(readings)
    chk(f"stream block kernel vs plain, worst x' - x over {n} chunks (rel L2)", worst["x"],
        TOL_STREAM_BLOCK)
    chk(f"stream block kernel vs plain, worst new history over {n} chunks (rel L2)",
        worst["hist"], TOL_STREAM_BLOCK)

    # Device ms a launch at one 20 ms chunk (M = 1, Kc = 16), per dilation.
    per_d = []
    leaves = tuple(bp[k] for k in STREAM_KEYS)
    wbytes = sum(t.numel() * t.element_size() for t in leaves)
    for d in dilations:
        span = (P - 1) * d
        x, hist = randn(1, 16, B).to(bf), randn(1, span, H).to(bf)

        def call(x, hist, *lv, d=d):  # the kernel alone (no programmatic dependent launch)
            return sb.stream_block(x, hist, dict(zip(STREAM_KEYS, lv)), d, bf, pdl=False)[0]

        def plain(d=d, x=x, hist=hist):
            return sb.stream_block_plain(x, hist, bp, d, bf)

        args = (x, hist) + leaves
        nbytes = wbytes + 2 * x.numel() * 2 + 2 * hist.numel() * 2
        row = {"dilation": d, "ms": device_ms(lambda: call(*args), label=f"stream block d={d}"),
               "cold_ms": cold_timed(call, args, label=f"stream block d={d} cold").ms,
               "plain_ms": device_ms(plain, label=f"stream block plain d={d}"),
               "bytes": nbytes, "bytes_bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
               "plan": list(sb.stream_plan(1, 16, B, H, P, d))}
        per_d.append(row)
        log(f"  stream block d={d}: {row['ms']:.4f} ms/launch warm, cold {row['cold_ms']:.4f}, "
            f"bound {row['bytes_bound_ms']:.4f} by bytes ({nbytes} B), plain "
            f"{row['plain_ms']:.4f} ms; plan {row['plan']}")
    mean = {k: sum(r[k] for r in per_d) / len(per_d)
            for k in ("ms", "cold_ms", "plain_ms", "bytes_bound_ms")}
    row = {"name": "tcn_stream_block", "design": "cluster8+st.async+mma.sync+pdl",
           "shape": f"M=1, Kc=16, B={B}, H={H}, P={P}, bf16", **mean,
           "share_of_bound": mean["bytes_bound_ms"] / mean["ms"],
           "cold_share_of_bound": mean["bytes_bound_ms"] / mean["cold_ms"],
           "worst_rel_l2": worst, "per_dilation": per_d}
    log(f"  stream block, mean over the 8 dilations: {mean['ms']:.4f} ms/launch warm, cold "
        f"{mean['cold_ms']:.4f}, bound {mean['bytes_bound_ms']:.4f} by bytes, plain "
        f"{mean['plain_ms']:.4f}; worst rel L2 x' - x {worst['x']:.3e}, history "
        f"{worst['hist']:.3e} over {n} chunks")
    low = [r["dilation"] for r in per_d if r["cold_ms"] < r["bytes_bound_ms"]]
    chk(f"stream block: cold time below its byte bound at dilations {low}", float(len(low)), 0)
    chk.done()
    return row


# ---- parallel phase ---------------------------------------------------------

PAR_JOIN_S = 400


def _par_tensors(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _sgd_delta(step, params, opt, state, mix, src, lens):
    """One SGD step at lr 1: (loss, the clipped gradient per leaf as the
    parameter change, on the CPU) of `step`."""
    from convtasnet_torch.training.optim import tree_leaves

    p1, _, _, loss, _ = step(params, opt.init(params), state, mix, src, lens)
    return float(loss), [(a - b).cpu() for a, b in zip(tree_leaves(params), tree_leaves(p1))]


def _par_worker(rank, world, tmp, dev_type):
    """One of two ranks on cuda:0 over gloo: the DP hybrid train step (f32
    and bf16), the DP `auto` forward, the TP forward and train step (eager
    chain), and whether a Solver on the DP mesh keeps its steps eager;
    writes its results to tmp/par_r<rank>.pt."""
    import dataclasses

    from convtasnet_torch.config import ConvTasNetConfig, TrainConfig
    from convtasnet_torch.models import graphed
    from convtasnet_torch.models.conv_tasnet import ConvTasNet
    from convtasnet_torch.parallel import comm, distributed
    from convtasnet_torch.parallel.mesh import (gather_params, graphable, make_mesh,
                                                mesh_forward, shard_batch_fn, shard_params_fn,
                                                steps_graphable)
    from convtasnet_torch.training.optim import Optimizer, tree_leaves
    from convtasnet_torch.training.solver import Solver, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = distributed.initialize(f"file://{tmp}/par_store", world, rank, backend="gloo",
                                 device_type=dev_type)
    try:
        z = _par_tensors(os.path.join(tmp, "par_inputs.pt"))
        params = _tree_to(z["params"], dev)
        base = ConvTasNetConfig(**json.loads(z["cfg"]))
        res = {}
        mesh = make_mesh(2, 1, 1, dev)
        opt = Optimizer("sgd", lr=1.0)
        mix, lens, src = shard_batch_fn(mesh)(z["step_mix"], z["step_lens"], z["step_src"])
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, compute_dtype=dtype, use_kernels="hybrid")
            step = make_train_step(cfg, opt, 5.0, mesh)
            _sgd_delta(step, params, opt, {}, mix, src, lens)  # warm-up
            torch.cuda.synchronize()
            reset_all_counts()
            comm.reset_counts()
            loss, delta = _sgd_delta(step, params, opt, {}, mix, src, lens)
            torch.cuda.synchronize()
            res[f"dp_step_{dtype}"] = {"loss": loss, "delta": delta,
                                       "launches": all_counts(),
                                       "collectives": comm.counts()["collectives"],
                                       "bucket_bytes": step.bucket[0].nbytes,
                                       "rows": int(mix.shape[0])}
            if dtype == "bfloat16":
                ms, _ = forward_ms(lambda: step(params, opt.init(params), {}, mix, src, lens),
                                   iters=5, warm=1)
                res["dp_step_gloo_ms"] = ms
        fmix, _, _ = shard_batch_fn(mesh)(z["fwd_mix"], np.ones(8, np.int32), None)
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, compute_dtype=dtype, use_kernels="auto")
            with torch.inference_mode():
                fwd = mesh_forward(cfg, params, {}, mesh)
                assert graphable(mesh)  # tp = cp = 1: graphed, as the CLIs wrap it
                fwd = graphed.GraphedForward(fwd, tag=(cfg.kernel_form(False, dev),))
                first = fwd(fmix)  # the key's eager first call
                fwd(fmix)  # its capture
                torch.cuda.synchronize()
                reset_all_counts()
                graphed.reset_counts()
                est = fwd(fmix)  # a replay
                torch.cuda.synchronize()
            res[f"dp_fwd_{dtype}"] = {"est": est.cpu(), "eager_est": first.cpu(),
                                      "launches": all_counts(), "graph": graphed.counts()}
        tpm = make_mesh(1, 2, 1, dev)
        tmix, tlens, tsrc = (z[k].to(dev) for k in ("tp_mix", "tp_lens", "tp_src"))
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, compute_dtype=dtype, use_kernels="0")
            with torch.inference_mode():
                est = mesh_forward(cfg, params, {}, tpm)(tmix)
            res[f"tp_fwd_{dtype}"] = {"est": est.cpu()}
        cfg = dataclasses.replace(base, compute_dtype="float32", use_kernels="0")
        p0, s0, _ = shard_params_fn(tpm, 2, cfg.C)(params, {}, None)
        comm.reset_counts()
        p1, _, _, loss, _ = make_train_step(cfg, opt, 5.0, tpm)(p0, opt.init(p0), s0, tmix,
                                                                 tsrc, tlens)
        collectives = comm.counts()["collectives"]
        w0, w1 = gather_params(tpm, cfg.C, p0)[0], gather_params(tpm, cfg.C, p1)[0]
        res["tp_step_float32"] = {"loss": float(loss), "collectives": collectives,
                                  "delta": [(a - b).cpu() for a, b in
                                            zip(tree_leaves(w0), tree_leaves(w1))]}
        # gloo stages its all-reduces through the host: no graphed steps.
        model = ConvTasNet(dataclasses.replace(base, use_kernels="hybrid"), params, {},
                           device=dev)
        solver = Solver(model, TrainConfig(save_folder=os.path.join(tmp, "gloo_solver")), None,
                        None, log=lambda msg: None, mesh=mesh)
        res["gloo_steps"] = {"gate": steps_graphable(mesh),
                             "graph_counts": solver.graph_counts()}
        torch.save(res, os.path.join(tmp, f"par_r{rank}.pt"))
    finally:
        distributed.shutdown()


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _run_world2(tmp, dev):
    """Spawn the two gloo ranks; returns their results."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_par_worker, args=(r, 2, tmp, dev.type)) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.time() + PAR_JOIN_S
    for p in procs:
        p.join(max(1.0, deadline - time.time()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join(10)
    codes = [p.exitcode for p in procs]
    if alive or codes != [0, 0]:
        raise AssertionError(f"parallel phase: world-2 ranks exited {codes}"
                             f"{' (timed out)' if alive else ''}")
    return [_par_tensors(os.path.join(tmp, f"par_r{r}.pt")) for r in range(2)]


def parallel_phase(cfg, dev, tmp, hybrid_run):
    """DP and TP over torch.distributed at the paper config: two gloo ranks
    on cuda:0 (DP hybrid step, DP auto forward, TP forward and step, a DP
    Solver that keeps eager steps) against the single-process runs, then
    one NCCL rank (the train CLI through its distributed path, its steps
    graphed; the DP step bit for bit, cp_forward at n = 1, the DP step
    timed against the plain step; the graphed DP steps, _graphed_dp_steps)."""
    import dataclasses

    import torch.distributed as dist

    from convtasnet_torch.cli.train import main as train_main
    from convtasnet_torch.data.dataset import AudioDataset
    from convtasnet_torch.models.conv_tasnet import forward, init_params
    from convtasnet_torch.parallel import comm, distributed
    from convtasnet_torch.parallel.context import cp_forward
    from convtasnet_torch.parallel.mesh import make_mesh
    from convtasnet_torch.training.optim import Optimizer, tree_leaves
    from convtasnet_torch.training.solver import make_train_step

    NB = cfg.R * cfg.X
    chk = Checks("parallel phase")
    timing = {}
    params, _ = init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    batch = AudioDataset(hybrid_run["tr"], 5).load_batch(0)
    rng = np.random.default_rng(11)
    fwd_mix = rng.normal(size=(8, 4 * SR)).astype(np.float32)
    tp_src = (rng.normal(size=(2, 2, 4 * SR)) * 0.3).astype(np.float32)
    inputs = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in (
        ("step_mix", batch.mixture), ("step_lens", batch.lengths), ("step_src", batch.source),
        ("fwd_mix", fwd_mix), ("tp_mix", tp_src.sum(1)), ("tp_src", tp_src),
        ("tp_lens", np.array([4 * SR, 3 * SR], np.int32)))}
    torch.save({"params": _tree_to(params, "cpu"), "cfg": json.dumps(cfg.header_dict()),
                **inputs}, os.path.join(tmp, "par_inputs.pt"))

    # ---- world 2 over gloo, both ranks on cuda:0 --------------------------
    t0 = time.perf_counter()
    ranks = _run_world2(tmp, dev)
    timing["world2_s"] = time.perf_counter() - t0
    mix, lens, src = (inputs[k].to(dev) for k in ("step_mix", "step_lens", "step_src"))
    opt = Optimizer("sgd", lr=1.0)
    for dtype, gtol, ltol in (("float32", TOL_GRAD_F32, TOL_LOSS_F32),
                              ("bfloat16", TOL_GRAD_BF16, TOL_LOSS_BF16)):
        c = dataclasses.replace(cfg, compute_dtype=dtype, use_kernels="hybrid")
        ref_loss, ref = _sgd_delta(make_train_step(c, opt, 5.0), params, opt, {}, mix, src, lens)
        for r, res in enumerate(ranks):
            got = res[f"dp_step_{dtype}"]
            chk(f"DP step {dtype} rank {r}: rows ({got['rows']} of 6)", abs(got["rows"] - 3), 0)
            chk(f"DP step {dtype} rank {r}: loss vs one process ({got['loss']:.5f} vs "
                f"{ref_loss:.5f})", abs(got["loss"] - ref_loss) / max(abs(ref_loss), 1e-6), ltol)
            worst = max((rel_l2(a, b), i) for i, (a, b) in enumerate(zip(got["delta"], ref)))
            chk(f"DP step {dtype} rank {r}: parameter change vs one process, worst leaf "
                f"#{worst[1]} (relative L2)", worst[0], gtol)
            for k, v in per_step_launches("hybrid", NB, kf_launches(c, 3, 4 * SR)).items():
                chk(f"DP step {dtype} rank {r}: {k} launches", abs(got["launches"][k] - v), 0)
            chk(f"DP step {dtype} rank {r}: collectives per step ({got['collectives']})",
                abs(got["collectives"] - 2), 0)
    log(f"  DP step: {ranks[0]['dp_step_bfloat16']['collectives']} collectives per step, "
        f"gradient bucket {ranks[0]['dp_step_bfloat16']['bucket_bytes']} bytes")
    timing["dp_collectives_per_step"] = ranks[0]["dp_step_bfloat16"]["collectives"]
    timing["dp_bucket_bytes"] = ranks[0]["dp_step_bfloat16"]["bucket_bytes"]
    timing["world2_gloo_dp_step_bf16_ms"] = [res["dp_step_gloo_ms"] for res in ranks]
    log(f"  world-2 DP step over gloo (all-reduces staged through the host; no speed "
        f"claim): {timing['world2_gloo_dp_step_bf16_ms']} ms per step by rank")
    fmix = inputs["fwd_mix"].to(dev)
    fwd_want = auto_launches(NB)
    for dtype, tol in (("float32", TOL_E2E_F32), ("bfloat16", TOL_E2E_BF16)):
        with torch.inference_mode():
            ref, _ = forward(params, {}, dataclasses.replace(cfg, compute_dtype=dtype,
                                                             use_kernels="auto"), fmix)
        got = torch.cat([res[f"dp_fwd_{dtype}"]["est"] for res in ranks])
        chk(f"DP forward {dtype}: 4 + 4 rows vs one process (relative L2)",
            rel_l2(got, ref.cpu()), tol)
        eager = torch.cat([res[f"dp_fwd_{dtype}"]["eager_est"] for res in ranks])
        chk(f"DP forward {dtype}: eager first call, 4 + 4 rows vs one process (relative L2)",
            rel_l2(eager, ref.cpu()), tol)
        chk(f"DP forward {dtype}: replay == eager first call, bit for bit",
            float(not torch.equal(got, eager)), 0)
        for r, res in enumerate(ranks):
            for k, v in fwd_want.items():
                chk(f"DP forward {dtype} rank {r}: {k} launches",
                    abs(res[f"dp_fwd_{dtype}"]["launches"][k] - v), 0)
            g = res[f"dp_fwd_{dtype}"]["graph"]
            chk(f"DP forward {dtype} rank {r}: one graph replay, no eager call",
                abs(g["replays"] - 1) + g["eager_calls"] + g["captures"], 0)
    tmix, tlens, tsrc = (inputs[k].to(dev) for k in ("tp_mix", "tp_lens", "tp_src"))
    for dtype, tol in (("float32", TOL_E2E_F32), ("bfloat16", TOL_E2E_BF16)):
        with torch.inference_mode():
            ref, _ = forward(params, {}, dataclasses.replace(cfg, compute_dtype=dtype,
                                                             use_kernels="0"), tmix)
        for r, res in enumerate(ranks):
            chk(f"TP forward {dtype} rank {r}: vs one process, eager (relative L2)",
                rel_l2(res[f"tp_fwd_{dtype}"]["est"], ref.cpu()), tol)
    c32 = dataclasses.replace(cfg, compute_dtype="float32", use_kernels="0")
    ref_loss, ref = _sgd_delta(make_train_step(c32, opt, 5.0), params, opt, {}, tmix, tsrc,
                               tlens)
    for r, res in enumerate(ranks):
        got = res["tp_step_float32"]
        chk(f"TP step float32 rank {r}: loss vs one process",
            abs(got["loss"] - ref_loss) / max(abs(ref_loss), 1e-6), TOL_LOSS_F32)
        worst = max((rel_l2(a, b), i) for i, (a, b) in enumerate(zip(got["delta"], ref)))
        chk(f"TP step float32 rank {r}: parameter change vs one process, worst leaf "
            f"#{worst[1]} (relative L2)", worst[0], TOL_GRAD_F32)
    timing["tp_collectives_per_step"] = ranks[0]["tp_step_float32"]["collectives"]
    log(f"  TP step (tp 2): {timing['tp_collectives_per_step']} collectives per step")
    for r, res in enumerate(ranks):
        g = res["gloo_steps"]
        chk(f"gloo DP rank {r} on {dev}: Solver keeps eager steps (gate {g['gate']}, "
            f"graph_counts {g['graph_counts']})",
            float(g["gate"] or g["graph_counts"] is not None), 0)

    # ---- world 1 over NCCL -------------------------------------------------
    # The train CLI through its distributed path: torchrun's variables.
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "1",
           "RANK": "0", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        # A second epoch, so that the graphed train step replays (one
        # epoch is two steps: the eager call and the capture).
        out = train_main(hybrid_run["argv"] + ["--epochs", "2", "--save_folder",
                                               os.path.join(tmp, "exp_nccl")])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    want = hybrid_run["out"]
    log(f"  train CLI at world 1 (nccl, env init): tr_loss {out['tr_loss']}, cv_loss "
        f"{out['cv_loss']} (non-distributed: {want['tr_loss']}, {want['cv_loss']})")
    chk("train CLI world 1: steps (two epochs)", abs(out["steps"] - 2 * want["steps"]), 0)
    for k in ("tr_loss", "cv_loss"):
        chk(f"train CLI world 1: epoch 1 {k} vs the non-distributed run (relative)",
            float(np.max(np.abs(np.subtract(out[k][:1], want[k])) / np.abs(want[k]))), 1e-6)
        chk(f"train CLI world 1: epoch 2 {k} finite", float(not np.isfinite(out[k][1])), 0)
    chk("train CLI world 1: process group closed", float(dist.is_initialized()), 0)
    log(f"  train CLI world 1 graphs: {out['graphs']}")
    for name in ("train_step", "cv_step"):
        g = (out["graphs"] or {}).get(name, {})
        chk(f"train CLI world 1: {name} ran as CUDA graphs (captures and replays > 0)",
            float(not (g.get("captures", 0) > 0 and g.get("replays", 0) > 0)), 0)
    timing["world1_cli_graphs"] = out["graphs"]

    distributed.initialize(f"file://{tmp}/nccl_store", 1, 0, device_type=dev.type)
    try:
        mesh = make_mesh(1, 1, 1, dev)
        c = dataclasses.replace(cfg, use_kernels="hybrid")
        adam = Optimizer("adam", lr=1e-3)
        plain_step = make_train_step(c, adam, 5.0)
        dp_step = make_train_step(c, adam, 5.0, mesh)
        o0 = adam.init(params)
        a = plain_step(params, o0, {}, mix, src, lens)
        comm.reset_counts()
        b = dp_step(params, o0, {}, mix, src, lens)
        torch.cuda.synchronize()
        chk("world-1 nccl DP step: collectives per step", abs(comm.counts()["collectives"] - 2),
            0)
        diff = float(not (torch.equal(a[3], b[3]) and torch.equal(a[4], b[4]) and all(
            torch.equal(u, v) for u, v in zip(tree_leaves(a[0]), tree_leaves(b[0])))))
        chk("world-1 nccl DP step == plain step, bit for bit (loss, norm, parameters)", diff, 0)

        cp_mesh = dataclasses.replace(mesh, context=dist.new_group([0]))
        mix2 = tmix
        for dtype, tol in (("float32", TOL_E2E_F32), ("bfloat16", TOL_E2E_BF16)):
            cc = dataclasses.replace(cfg, compute_dtype=dtype, use_kernels="0")
            with torch.inference_mode():
                got = cp_forward(params, {}, cc, mix2, cp_mesh)
                ref, _ = forward(params, {}, cc, mix2)
            chk(f"cp_forward n=1 {dtype} vs forward (relative L2)", rel_l2(got, ref), tol)
            chk(f"cp_forward n=1 {dtype} shape", float(got.shape != ref.shape), 0)

        # The DP step against the plain step, in turns (CUDA events; the
        # device's busy share from torch.profiler's device time).
        def run(fn):
            return lambda: fn(params, o0, {}, mix, src, lens)

        order = [("plain", plain_step), ("dp", dp_step), ("dp", dp_step), ("plain", plain_step)]
        ms = {"plain": [], "dp": []}
        dev_ms = {"plain": [], "dp": []}
        for name, fn in order:
            ms[name].append(forward_ms(run(fn), iters=10, warm=2)[0])
            dev_ms[name].append(device_ms(run(fn), iters=5, warm=1))
        for name in ("plain", "dp"):
            timing[f"world1_{name}_step_bf16_ms"] = ms[name]
            timing[f"world1_{name}_step_bf16_device_ms"] = dev_ms[name]
            busy = [d / e for d, e in zip(dev_ms[name], ms[name])]
            timing[f"world1_{name}_step_bf16_busy"] = busy
            log(f"  world-1 nccl {name} step, batch 5 x 4 s, hybrid bf16: {ms[name]} ms "
                f"(CUDA events, median of 10 each), device {dev_ms[name]} ms, busy {busy}")
        timing["world1_graphed"] = _graphed_dp_steps(chk, cfg, dev, mesh, hybrid_run)
    finally:
        distributed.shutdown()
    chk.done()
    return timing


def _graphed_dp_steps(chk, cfg, dev, mesh, hybrid_run):
    """The DP `hybrid` and `whole` steps of one NCCL rank through
    GraphedStep, their all-reduces recorded in the graph (the counterpart
    of JAX's jitted DP step): TRAIN_GRAPH_STEPS steps (eager call, capture,
    replays) bit for bit against the eager DP step and the graphed plain
    step (losses, grad norms, parameters, moments), 2 collectives on every
    call and an eager step's kernel launches per replay; then, for
    `hybrid`, timed in turns: plain graphed, DP graphed, DP graphed, plain
    graphed, DP eager (CUDA events, and busy from tools/_bench.device_ms)."""
    import dataclasses

    from convtasnet_torch.data.dataset import AudioDataset
    from convtasnet_torch.models import graphed
    from convtasnet_torch.models.conv_tasnet import init_params
    from convtasnet_torch.parallel.mesh import steps_graphable

    n = TRAIN_GRAPH_STEPS
    chk("world-1 nccl: the DP mesh's steps are graphable", float(not steps_graphable(mesh)), 0)
    ds = AudioDataset(hybrid_run["tr"], 5)
    batches = [tuple(torch.from_numpy(np.asarray(a)).to(dev)
                     for a in (b.mixture, b.lengths, b.source))
               for b in (ds.load_batch(i) for i in range(len(ds)))]
    res = {}
    for form in ("hybrid", "whole"):
        c = dataclasses.replace(cfg, use_kernels=form)
        label = f"world-1 nccl DP {form}"
        params, state = init_params(torch.Generator(device=dev).manual_seed(0), c, device=dev)
        runs = {"dp_eager": _graph_step_run(c, dev, params, state, batches, n, 0, mesh=mesh)}
        reset_all_counts()
        runs["dp_graphed"] = g = _graph_step_run(c, dev, params, state, batches, n,
                                                 graphed.MAX_GRAPHS, mesh=mesh)
        counts = all_counts()
        runs["plain_graphed"] = _graph_step_run(c, dev, params, state, batches, n,
                                                graphed.MAX_GRAPHS)
        for other in ("dp_eager", "plain_graphed"):
            o = runs[other]
            chk(f"{label}: graphed == {other.replace('_', ' ')} over {n} steps, bit for bit "
                "(loss, grad norm, parameters, moments)",
                float(not (_same_bits(g, o) and g[4] == o[4])), 0)
        gs = g[0].graphed.stats()
        chk(f"{label}: 1 eager call, 1 capture, {n - 2} replays ({gs})",
            abs(gs["eager_calls"] - 1) + abs(gs["captures"] - 1) + abs(gs["replays"] - (n - 2)),
            0)
        info = next(iter(g[0].graphed.graphs().values()))
        chk(f"{label}: collectives per call {g[5]}, per replay from the capture "
            f"{info['launches'].get('collectives')}",
            max(abs(x - 2) for x in g[5]) + abs(info["launches"].get("collectives", 0) - 2), 0)
        chk(f"{label}: eager DP collectives per call {runs['dp_eager'][5]}",
            max(abs(x - 2) for x in runs["dp_eager"][5]), 0)
        per = per_step_launches(form, c.R * c.X, kf_launches(c, 5, 4 * SR))
        kernels = {k: v for k, v in info["launches"].items() if k != "collectives"}
        chk(f"{label}: kernel launches per replay {kernels} == per_step_launches",
            max(abs(kernels.get(k, 0) - per.get(k, 0)) for k in set(kernels) | set(per)), 0)
        chk(f"{label}: kernel launches of the {n} graphed calls == {n} x per_step_launches "
            f"{counts}", max(abs(v - n * per.get(k, 0)) for k, v in counts.items()), 0)
        row = {"capture_ms": info["capture_ms"], "pool_bytes": info["pool_bytes"],
               "collectives_per_call": g[5],
               **{f"{k}_peak_gb": r[2] for k, r in runs.items()}}
        if form == "hybrid":
            order = [("plain_graphed", runs["plain_graphed"][0]),
                     ("dp_graphed", g[0]), ("dp_graphed", g[0]),
                     ("plain_graphed", runs["plain_graphed"][0]),
                     ("dp_eager", runs["dp_eager"][0])]
            for side, step in order:
                for k, v in _step_timing(step, batches[0]).items():
                    row.setdefault(f"{side}_{k}", []).append(v)
        log(f"  {label}, batch 5 x 4 s bf16: {json.dumps(row)}")
        res[form] = row
        del runs, g
        torch.cuda.empty_cache()
    return res


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def forward_kernel_specs(blocks, cfg, dev, M=8, K=3199):
    """Timing specs of the forward kernels at the main path's shapes (bf16,
    batch 8 x 4 s, block 3's weights; KFW on the stacked weights), and the
    separate path that launches each. A spec's `call(*args)` is one timed
    call of `per` launches; `bytes` and `flops` are the work of one launch."""
    from convtasnet_torch.ops.kernels import tcn_block as tb

    B, H, P = cfg.B, cfg.H, cfg.P
    Kp = -(-K // tb.ROW_ALIGN) * tb.ROW_ALIGN
    dt, it, rows, nb = torch.bfloat16, 2, M * Kp, 3
    x32 = torch.randn((M, Kp, B), generator=torch.Generator(device=dev).manual_seed(7),
                      device=dev)
    x32[:, K:] = 0
    x = x32.to(dt)
    in_w = blocks["in_w"][nb].to(dt)
    a1, a2 = blocks["in_prelu"][nb], blocks["dw_prelu"][nb]
    norm = cfg.norm_type
    y1, s1 = tb.tcn_in_gemm(x, in_w, a1, norm)
    dw_args = (y1, s1, a1, blocks["in_gamma"][nb], blocks["in_beta"][nb], blocks["dw_w"][nb], a2)
    e, s2 = tb.tcn_dwconv(*dw_args, norm, 1, cfg.causal, K)
    wp, ga, gb = tb.fold_weights(blocks["out_w"][nb], blocks["dw_gamma"][nb],
                                 blocks["dw_beta"][nb], dt)
    ow = blocks["out_w"][nb].to(dt)
    out = torch.empty_like(x)

    def dw_one(fn, d, *a):
        return fn(*(a or dw_args), norm, d, cfg.causal, K)

    def dw_all(fn):
        # One launch per dilation of a repeat (the chain's mix of halos).
        return lambda *a: [dw_one(fn, 2 ** xi, *a) for xi in range(cfg.X)]

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
    # KFW on the main path's inputs: the stacked out_w, dw_gamma, dw_beta
    fold_in = (blocks["out_w"], blocks["dw_gamma"], blocks["dw_beta"])
    fold_n = blocks["out_w"].numel()
    NB = fold_in[0].shape[0]
    specs = {
        "tcn_in_gemm": dict(
            replaces=WHOLE_TCN,
            call=lambda x_, w_, a_, o_: tb.tcn_in_gemm(x_, w_, a_, norm, o_),
            args=(x, in_w, a1, y1),
            plain=lambda: tb.in_gemm_plain(x, in_w, a1, norm),
            library=lambda: torch.matmul(x.view(rows, B), in_w),
            bytes=(rows * B + B * H + rows * H) * it + s1.numel() * 4,
            flops=gemm_flops, per=1),
        "tcn_dwconv": dict(
            replaces=WHOLE_TCN, source=SOURCE_DW,
            call=dw_all(tb.tcn_dwconv), args=dw_args, plain=dw_all(tb.dwconv_plain),
            library=conv_all,
            per_d=dict(kernel=lambda d, *a: dw_one(tb.tcn_dwconv, d, *a), library=conv_one,
                       plan=lambda d: tb.dw_plan(P, d, H, it),
                       dilations=[2 ** xi for xi in range(cfg.X)]),
            bytes=(2 * rows * H * it + s1.numel() * 4 + s2.numel() * 4 + (P + 2) * H * 4),
            flops=rows * H * (2.0 * P + 12), per=cfg.X),
        "tcn_out_gemm_fold": dict(
            replaces=WHOLE_TCN,
            call=lambda e_, s_, x_, w_, ga_, gb_, o_: tb.tcn_out_gemm(
                e_, s_, x_, w_, ga_, gb_, norm, K, True, o_),
            args=(e, s2, x, wp, ga, gb, out),
            plain=lambda: tb.out_gemm_plain(e, s2, x, wp, ga, gb, norm, K, True),
            library=lambda: torch.matmul(e.view(rows, H), wp),
            bytes=(rows * H + 2 * rows * B + H * B) * it + s2.numel() * 4,
            flops=gemm_flops, per=1),
        "tcn_out_gemm_unfold": dict(
            replaces=WHOLE_BLOCK,
            call=lambda e_, s_, x_, w_, ga_, gb_, o_: tb.tcn_out_gemm(
                e_, s_, x_, w_, ga_, gb_, norm, K, False, o_),
            args=(e, s2, x, ow, blocks["dw_gamma"][nb], blocks["dw_beta"][nb], out),
            plain=lambda: tb.out_gemm_plain(e, s2, x, ow, blocks["dw_gamma"][nb],
                                            blocks["dw_beta"][nb], norm, K, False),
            library=lambda: torch.matmul(e.view(rows, H), ow),
            bytes=(rows * H + 2 * rows * B + H * B) * it + s2.numel() * 4,
            flops=gemm_flops, per=1),
        # the bound: the f32 out_w read once, wp written once in bf16, g2 / b2
        # read and g2w / b2w written; a multiply for wp and two multiply-adds
        # per element (f32). The library call is fold_weights itself (the
        # calls KFW replaced), timed in turns with the kernel.
        "tcn_fold_weights": dict(
            replaces=WHOLE_TCN, source=SOURCE_KFW,
            call=lambda o_, g_, b_: tb.tcn_fold_weights(o_, g_, b_, dt), args=fold_in,
            plain=lambda: tb.fold_weights(*fold_in, dt),
            library=lambda: tb.fold_weights(*fold_in, dt), turns=True,
            shape=f"NB={NB}, H={H}, B={B} (stacked weights)",
            bytes=fold_n * (4 + it) + 2 * NB * (H + B) * 4, flops=5.0 * fold_n, per=1,
            dtype=torch.float32),
    }
    path_of = {"tcn_in_gemm": "auto", "tcn_dwconv": "auto",
               "tcn_out_gemm_fold": "auto", "tcn_out_gemm_unfold": "block",
               "tcn_fold_weights": "auto"}
    return specs, path_of


def time_kernels(specs, shape, full=True):
    """Each spec's device ms per launch, warm (`ms`: back-to-back launches
    on the same inputs) and with cold L2 (`cold_ms`: launches cycling over
    copies of the inputs and the write targets past twice the 50 MB L2,
    tools/_bench.cold_timed), both from profiles whose records are counted
    (tools/_bench.timed; the depthwise kernels cold one launch at a time,
    cycling the dilations), beside its bound: the larger of its bytes at the
    HBM rate and its operations at the peak of their type. With `full`,
    also its plain version's and library call's device ms, its CUDA-event
    ms and host us per call, K2 / K2 save / KB2 per dilation, KW's Stage
    A. Returns {name: row}."""
    from convtasnet_torch.tools._bench import cold_copies, tree_tensors

    rows = {}
    for name, s in specs.items():
        per = s["per"]
        t_bytes = s["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = s["flops"] / PEAK_FLOPS[s.get("dtype", torch.bfloat16)] * 1e3
        bound = max(t_bytes, t_ops)

        def kernel(s=s):
            return s["call"](*s["args"])

        n = cold_copies(sum(a.numel() * a.element_size() for a in tree_tensors(s["args"])))
        if "per_d" in s:
            # cold: one launch a step, at the next dilation, on the next copy
            dils = itertools.cycle(s["per_d"]["dilations"])
            cold = cold_timed(lambda *a: s["per_d"]["kernel"](next(dils), *a), s["args"],
                              iters=len(s["per_d"]["dilations"]) * n, label=f"{name} cold").ms
        else:
            cold = cold_timed(s["call"], s["args"], label=f"{name} cold").ms / per
        t = {"ms": device_ms(kernel, label=name) / per, "cold_ms": cold, "cold_copies": n,
             "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bytes_bound_ms": t_bytes}
        if full:
            t.update({"plain_ms": device_ms(s["plain"], label=f"{name} plain") / per,
                      "library_ms": (device_ms(s["library"], label=f"{name} library") / per
                                     if s["library"] else None),
                      "event_ms": cuda_ms(kernel) / per, "host_us": host_us(kernel) / per})
            if s.get("turns"):
                # library, kernel, kernel, library: both on the same card state
                turns = [device_ms(f, label=f"{name} turns") for f in (
                    s["library"], kernel, kernel, s["library"])]
                t["turns_ms"] = turns
                t["ms"], t["library_ms"] = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
                log(f"  {name} in turns (library, kernel, kernel, library): {turns} ms")
            if "stage_a" in s:
                # the same splits with one partial per CTA (no cluster sums)
                t["stage_a_ms"] = device_ms(s["stage_a"], label=f"{name} stage A")
                log(f"  {name}: Stage A {t['stage_a_ms']:.4f} ms, Stage B {t['ms']:.4f} ms "
                    "per tcn_wgrad call (its partials; KF sums them)")
            if "per_d" in s:
                t["per_dilation"] = per_dilation_times(name, s, s.get("shape", shape), t_bytes)
        t["share_of_bound"] = bound / t["ms"]
        t["cold_share_of_bound"] = bound / t["cold_ms"]
        rows[name] = t
        lib = t.get("library_ms")
        more = ("" if not full else
                f", plain {t['plain_ms']:.4f}, library "
                f"{'n/a' if lib is None else f'{lib:.4f}'}; event {t['event_ms']:.4f} ms, "
                f"host {t['host_us']:.1f} us per call")
        log(f"  {name} ({DESIGN[name]}): {t['ms']:.4f} ms/launch warm ({t['share_of_bound']:.0%} "
            f"of the bound), cold {t['cold_ms']:.4f} ({t['cold_share_of_bound']:.0%}; "
            f"{t['cold_copies']} input copies), bound {bound:.4f} by {t['bound_by']}{more} at "
            f"{s.get('shape', shape)}, bf16")
    return rows


def per_dilation_times(name, s, shape, t_bytes):
    """Device ms per launch of the kernel and of the cuDNN call at each
    dilation of the chain (the mean hides the worst), with the tile."""
    rows_ = []
    pd = s["per_d"]
    for d in pd["dilations"]:
        row = {"dilation": d, "tile": list(pd["plan"](d)[:3]),
               "ms": device_ms(lambda: pd["kernel"](d), label=f"{name} d={d}"),
               "library_ms": device_ms(lambda: pd["library"](d), label=f"{name} cuDNN d={d}")}
        if "chpart_bytes" in pd:
            row["chpart_bytes"] = pd["chpart_bytes"](d)
        rows_.append(row)
        extra = f", chpart {row['chpart_bytes']} B" if "chpart_bytes" in row else ""
        log(f"    {name} d={d}: {row['ms']:.4f} ms (cuDNN {row['library_ms']:.4f}, bound "
            f"{t_bytes:.4f} by bytes; tile rows x channels x lanes {row['tile']}{extra}) "
            f"at {shape}")
    return rows_


def check_cold(kernels):
    """An impossible reading fails the run: a kernel whose cold-L2 time is
    below the least time its bytes take at the HBM rate. (A warm time below
    it is legal: the inputs can sit in the 50 MB L2.)"""
    low = [f"{k['name']} {k['cold_ms']:.4f} ms < {k['bytes_bound_ms']:.4f}" for k in kernels
           if k["cold_ms"] < k["bytes_bound_ms"]]
    if low:
        raise AssertionError("cold-L2 times below their byte bounds: " + "; ".join(low))


def train_kernel_specs(blocks, cfg, dev, M=5, K=3199):
    """Timing specs of the training kernels at the main path's shapes (bf16,
    batch 5 x 4 s; KF on a group of NB blocks' slots, the main path's one
    launch per step), as forward_kernel_specs."""
    from convtasnet_torch.ops.kernels import tcn_block as tb, tcn_block_bwd as tbb
    from convtasnet_torch.ops.kernels.whole_tcn_hybrid import finish_plan

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
    db, chpart, gs1, da2part = tbb.tcn_bwd_dwconv(y1, c, dz, s1, s2, gs2, a1, g1, b1, w, a2, g2,
                                                  norm, 1, cfg.causal, K)
    _, dy1, da1part = tbb.tcn_bwd_dx(db, y1, in_wt, g, s1, gs1, a1, g1, norm, K)
    z = (s2, a2, g2, b2, norm)
    # KF: the main path's group, every block's slot holding this block's
    # partials (scaled), into rows 0 ... NB - 1 of the stacked gradients
    kf_parts = (tbb.tcn_wgrad(c, g, K, z), tbb.tcn_wgrad(x, dy1, K), chpart, colpart,
                da1part, da2part)
    stacked = [blocks[k] for k in ("in_w", "in_prelu", "in_gamma", "in_beta", "dw_w",
                                   "dw_prelu", "dw_gamma", "dw_beta", "out_w")]
    NB = stacked[0].shape[0]
    G = finish_plan(M, Kp, B, H, P, tuple(2 ** (i % cfg.X) for i in range(NB)), dt, False,
                    x.device.index)[0]
    kf_slots_, kf_n = kf_slots(kf_parts, G, dev)
    kf_counts = [kf_n] * G
    kf_grads = tbb.alloc_grads(stacked)
    kf_bytes = 4 * (G * sum(t.numel() for t in kf_parts)
                    + sum(t[:G].numel() for t in kf_grads))
    kf_read = G * sum(t.numel() for t in kf_parts)
    log(f"KF: a group of {G} of {NB} blocks per launch at M={M} ({rows} rows): "
        f"{kf_bytes / 1e6:.1f} MB moved, partials per block {tuple(kf_n)}")
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
        def run(*a):
            return [fn(2 ** xi, *a, **kw) for xi in range(cfg.X)]
        return run

    dws_args = (y1, s1, a1, g1, b1, w, a2)

    def dws(d, *a, plain=False):
        f = tb.dwconv_plain if plain else tb.tcn_dwconv
        return f(*(a or dws_args), norm, d, cfg.causal, K, save=True)

    kb2_args = (y1, c, dz, s1, s2, gs2, a1, g1, b1, w, a2, g2)

    def kb2(d, *a, plain=False):
        f = tbb.bwd_dwconv_plain if plain else tbb.tcn_bwd_dwconv
        return f(*(a or kb2_args), norm, d, cfg.causal, K)

    def kb2_chpart(d):
        return M * tbb._kb2_plan(P, d, H, y1.dtype, M, Kp, dev.index).bands * (P + 2) * H * 4

    return {
        "tcn_dwconv_save": dict(
            source=SOURCE_DW, replaces=WHOLE_TCN, call=per_dilation(dws), args=dws_args,
            plain=per_dilation(dws, plain=True), library=per_dilation(conv), per=cfg.X,
            per_d=dict(kernel=dws, library=conv, plan=lambda d: tb.dw_plan(P, d, H, it),
                       dilations=[2 ** xi for xi in range(cfg.X)]),
            bytes=3 * rows * H * it + (s1.numel() + s2.numel()) * 4 + (P + 2) * H * 4,
            flops=rows * H * (2.0 * P + 12)),
        "tcn_bwd_dz": dict(
            source=SOURCE_BWD, replaces=BWD_BLOCK,
            call=lambda *a: tbb.tcn_bwd_dz(*a, norm, K), args=(g, out_wt, c, s2, a2, g2),
            plain=lambda: tbb.bwd_dz_plain(g, out_wt, c, s2, a2, g2, norm, K),
            library=lambda: torch.matmul(g.view(rows, B), out_wt),
            bytes=(rows * B + B * H + 2 * rows * H) * it
            + (s2.numel() + colpart.numel() + gs2.numel()) * 4 + 2 * H * 4,
            flops=gemm, per=1),
        "tcn_wgrad_out": dict(
            source=SOURCE_KW, replaces=BWD_BLOCK,
            call=lambda c_, g_, s_: tbb.tcn_wgrad(c_, g_, K, (s_, a2, g2, b2, norm)),
            args=(c, g, s2),
            plain=lambda: tbb.wgrad_plain(c, g, K, z),
            stage_a=lambda: tbb.tcn_wgrad(c, g, K, z, plan=(plan_z.splits, 1)),
            library=lambda: torch.matmul(c.view(rows, H).t(), g.view(rows, B)),
            bytes=rows * (B + H) * it + H * B * 4, flops=gemm, per=1),
        "tcn_bwd_dwconv": dict(
            source=SOURCE_DW, replaces=BWD_BLOCK, call=per_dilation(kb2), args=kb2_args,
            plain=per_dilation(kb2, plain=True), library=per_dilation(conv, transpose=True),
            per=cfg.X, shape=f"M={M}, K_pad={Kp} ({rows} rows), B={B}, H={H}",
            # the bound is the work's bytes; the f32 channel partials the
            # tile writes (and block_bwd sums back) are logged beside it
            per_d=dict(kernel=kb2, library=lambda d: conv(d, transpose=True),
                       plan=lambda d: tbb._kb2_plan(P, d, H, y1.dtype, M, Kp, dev.index),
                       chpart_bytes=kb2_chpart, dilations=[2 ** xi for xi in range(cfg.X)]),
            bytes=4 * rows * H * it + (s1.numel() + s2.numel() + gs2.numel()) * 4
            + (2 * P + 4) * H * 4, flops=rows * H * (4.0 * P + 30)),
        "tcn_bwd_dx": dict(
            source=SOURCE_BWD, replaces=BWD_BLOCK,
            call=lambda *a: tbb.tcn_bwd_dx(*a, norm, K), args=(db, y1, in_wt, g, s1, gs1, a1, g1),
            plain=lambda: tbb.bwd_dx_plain(db, y1, in_wt, g, s1, gs1, a1, g1, norm, K),
            library=lambda: torch.matmul(dy1.view(rows, H), in_wt),
            bytes=(3 * rows * H + 2 * rows * B + H * B) * it + (s1.numel() + gs1.numel()) * 4,
            flops=gemm, per=1),
        "tcn_wgrad_in": dict(
            source=SOURCE_KW, replaces=BWD_BLOCK,
            call=lambda x_, d_: tbb.tcn_wgrad(x_, d_, K), args=(x, dy1),
            plain=lambda: tbb.wgrad_plain(x, dy1, K),
            stage_a=lambda: tbb.tcn_wgrad(x, dy1, K, plan=(plan_in.splits, 1)),
            library=lambda: torch.matmul(x.view(rows, B).t(), dy1.view(rows, H)),
            bytes=rows * (B + H) * it + B * H * 4, flops=gemm, per=1),
        # the bound: each partial read once, each gradient written once; one
        # f32 add per partial element. The library call: the six .sums per
        # slot KF replaces, one call over the group's slots each, without
        # the writes into the rows.
        "tcn_bwd_finish": dict(
            source=SOURCE_KF, replaces=BWD_BLOCK,
            call=lambda sl, gr: tbb.tcn_bwd_finish(sl, kf_counts, gr, 0),
            args=(kf_slots_, kf_grads),
            plain=lambda: tbb.bwd_finish_plain(kf_slots_, kf_counts, kf_grads, 0),
            library=lambda: [t.sum(1) for t in kf_slots_],
            shape=f"a group of {G} blocks' slots, M={M}, K_pad={Kp}, B={B}, H={H}",
            bytes=kf_bytes, flops=float(kf_read), per=1, dtype=torch.float32),
    }


def backward_timing(stacked, cfg, dev, M=5, K=3199):
    """ms of the backward of the training ops at the main path's shapes
    (bf16, gLN, dilation 1 for the per-block ones), beside their plain
    versions: row 3 and the whole form's chain over all NB blocks, rows 4
    and 5 for one block."""
    from convtasnet_torch.ops.kernels import tcn_block as tb, tcn_block_bwd as tbb
    from convtasnet_torch.ops.kernels.whole_block_hybrid import hybrid_bwd_math
    from convtasnet_torch.ops.kernels.whole_block_vjp import recompute_bwd
    from convtasnet_torch.ops.kernels.whole_tcn_hybrid import chain_bwd, chain_save, whole_tcn_bwd

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
        "bwd_chain_whole": lambda: chain_bwd(g, x_res, None, None, stacked, norm, False,
                                             [2 ** (i % cfg.X) for i in range(len(x_res))], K),
        "bwd_block_whole": lambda: recompute_bwd(g, x, *one, norm, 1, False, K),
        "bwd_block_whole_plain": lambda: recompute_bwd(g, x, *one, norm, 1, False, K,
                                                       plain=True),
        "bwd_block_hybrid_torch": lambda: hybrid_bwd_math(x, y1, c, g, in_w, *one[1:8],
                                                          one[8].to(dt), norm, 1, False, K),
    }
    out = {f"{k}_ms": cuda_ms(fn, iters=5, warm=1) for k, fn in runs.items()}
    for k, v in out.items():
        log(f"  {k}: {v:.3f} ms at M={M}, K_pad={Kp}, bf16")
    return out


# Train-graph phase: the train step as a CUDA graph (training/solver.
# GraphedStep) against the same steps with graphed.MAX_GRAPHS = 0 (every
# call eager), per training form; BN takes the eager chain (the kernels
# have no BN mode). (label, --use_kernels, remat, norm_type).
TRAIN_GRAPH_FORMS = (("hybrid", "hybrid", False, "gLN"), ("whole", "whole", False, "gLN"),
                     ("0", "0", False, "gLN"), ("0+block", "0", "block", "gLN"),
                     ("0+dots", "0", "dots", "gLN"), ("hybrid BN", "hybrid", False, "BN"))
TRAIN_GRAPH_STEPS = 10
# After set_lr halves the rate between two replays, the next replayed Adam
# step's parameter change over the same step at the full rate: 0.5, up to
# the f32 rounding of p - lr * u (|lr * u| ~ 1e-3 of |p| ~ 0.1: a few
# 1e-6 relative).
TOL_LR_RATIO = 1e-3


def _graph_step_run(cfg, dev, params, state, batches, n, cap, lr_at=None, mesh=None):
    """n Adam steps (clip 5) through a GraphedStep from copies of the
    seeded trees, cycling over `batches`, with graphed.MAX_GRAPHS = cap (0:
    every call eager); with lr_at, the rate is halved the solver's way
    (set_lr) before that call; with `mesh`, the step is that mesh rank's.
    Returns (step, losses, peak GB above what was held, parameters before
    the last call, grad norms, collectives per call)."""
    from convtasnet_torch.models import graphed
    from convtasnet_torch.parallel import comm
    from convtasnet_torch.training.optim import Optimizer, set_lr, tree_leaves, tree_map
    from convtasnet_torch.training.solver import GraphedStep, make_train_step

    p = tree_map(lambda t: t.clone(), params)
    s = tree_map(lambda t: t.clone(), state)
    opt = Optimizer("adam", lr=1e-3)
    o = opt.init(p)
    step = GraphedStep(make_train_step(cfg, opt, 5.0, mesh), p, o, s,
                       tag=(cfg.kernel_form(True, dev),))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    saved, graphed.MAX_GRAPHS = graphed.MAX_GRAPHS, cap
    losses, norms, collectives, before = [], [], [], None
    try:
        for i in range(n):
            if i == lr_at:
                o = set_lr(o, float(o.lr) / 2.0)
            if i == n - 1:
                before = [t.clone() for t in tree_leaves(p)]
            mix, lens, src = batches[i % len(batches)]
            ran = comm.counts()["collectives"]
            p, o, s, loss, norm = step(p, o, s, mix, src, lens)
            collectives.append(comm.counts()["collectives"] - ran)
            losses.append(loss)
            norms.append(norm)
        torch.cuda.synchronize()
    finally:
        graphed.MAX_GRAPHS = saved
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    return (step, [float(x) for x in losses], peak, before, [float(x) for x in norms],
            collectives)


def _step_trees(step):
    from convtasnet_torch.training.optim import tree_leaves

    o = step.opt_state
    return (tree_leaves(step.params) + tree_leaves(o.mu) + tree_leaves(o.nu)
            + tree_leaves(step.state))


def _same_bits(a, b):
    return a[1] == b[1] and all(torch.equal(x, y) for x, y in zip(_step_trees(a[0]),
                                                                    _step_trees(b[0])))


def _graph_vs_eager(chk, what, g, e, eager_bits):
    """A graphed run against an eager one: losses per step (TOL_LOSS_BF16,
    relative), every parameter, moment and state leaf (TOL_GRAD_BF16,
    relative L2), and bit for bit where two eager runs are."""
    bits = _same_bits(g, e)
    chk(f"{what}: loss per step, graphed vs eager (relative)",
        max(abs(x - y) / max(abs(y), 1e-6) for x, y in zip(g[1], e[1])), TOL_LOSS_BF16)
    worst = max((rel_l2(x, y), i) for i, (x, y) in enumerate(zip(_step_trees(g[0]),
                                                                 _step_trees(e[0]))))
    chk(f"{what}: parameter / moment / state leaves, graphed vs eager, worst #{worst[1]} "
        "(relative L2)", worst[0], TOL_GRAD_BF16)
    if eager_bits:
        chk(f"{what}: graphed == eager bit for bit (two eager runs are)", float(not bits), 0)
    return bits


def _step_timing(step, batch, busy=True, iters=5):
    """Event ms (median of `iters`) and, with `busy`, device busy ms
    (torch.profiler) and idle share of further calls of `step` on one
    batch."""
    mix, lens, src = batch

    def one():
        step(step.params, step.opt_state, step.state, mix, src, lens)

    ms = forward_ms(one, iters=iters, warm=1)[0]
    if not busy:
        return {"ms": ms}
    b = device_ms(one, iters=3, warm=0)
    return {"ms": ms, "busy_ms": b, "idle_share": max(0.0, 1.0 - b / ms)}


# A depth below the paper config's, at which the graphed hybrid and whole
# steps are profiled again: their library reduce and copy launches per step
# must not grow with the number of blocks.
SMALL_R = 2


def _library_launches(step, batch, iters=3, tries=3):
    """Device busy ms and the at::native reduce-kernel and copy launches per
    call of `step` (replays of its CUDA graph), from torch.profiler."""
    mix, lens, src = batch
    prof = timed(lambda: step(step.params, step.opt_state, step.state, mix, src, lens),
                 iters=iters, warm=0, tries=tries, label="_library_launches")
    if prof.blind:
        raise AssertionError("torch.profiler's records fell short: " + "; ".join(prof.why))
    reduce = copy = 0
    for k, (n, _) in prof.records.items():
        if "at::native" in k and "reduce_kernel" in k:
            reduce += n
        elif "at::native" in k and "copy" in k.lower():
            copy += n
    return {"busy_ms": prof.ms, "reduce_launches": reduce / iters,
            "copy_launches": copy / iters}


def _library_by_depth(chk, label, c, dev, batches, step):
    """The library launches of the graphed step at the paper depth and at
    R = SMALL_R, which must not exceed it: the per-block loops of the
    kernel forms launch no library op."""
    import dataclasses

    from convtasnet_torch.models import graphed
    from convtasnet_torch.models.conv_tasnet import init_params

    NB = c.R * c.X
    big = _library_launches(step, batches[0])
    cs = dataclasses.replace(c, R=SMALL_R)
    params, state = init_params(torch.Generator(device=dev).manual_seed(0), cs, device=dev)
    small = _library_launches(_graph_step_run(cs, dev, params, state, batches, 3,
                                              graphed.MAX_GRAPHS)[0], batches[0])
    for k in ("reduce_launches", "copy_launches"):
        chk(f"{label}: graphed step's at::native {k} at NB={NB} ({big[k]}) <= at NB="
            f"{SMALL_R * c.X} ({small[k]})", max(0.0, big[k] - small[k]), 0.0)
    log(f"  {label} graphed, per step: device busy {big['busy_ms']} ms, at::native reduce "
        f"{big['reduce_launches']}, copy {big['copy_launches']} launches at NB={NB}; at NB="
        f"{SMALL_R * c.X}: busy {small['busy_ms']} ms, reduce {small['reduce_launches']}, copy "
        f"{small['copy_launches']}")
    return {f"nb{NB}": big, f"nb{SMALL_R * c.X}": small}


def _train_graph_form(chk, label, c, dev, batches, NB, in_turns=False, busy=True,
                      library=False):
    """One training form: two eager runs and a graphed one, checked, then
    timed: eager, graphed (in_turns: then graphed, eager); device busy
    with `busy`; with `library`, the graphed step's library launches by
    depth (_library_by_depth)."""
    from convtasnet_torch.models import graphed
    from convtasnet_torch.models.conv_tasnet import init_params

    n = TRAIN_GRAPH_STEPS
    params, state = init_params(torch.Generator(device=dev).manual_seed(0), c, device=dev)
    e = _graph_step_run(c, dev, params, state, batches, n, 0)
    eager_bits = _same_bits(e, _graph_step_run(c, dev, params, state, batches, n, 0))
    reset_all_counts()
    g = _graph_step_run(c, dev, params, state, batches, n, graphed.MAX_GRAPHS)
    counts = all_counts()
    bits = _graph_vs_eager(chk, label, g, e, eager_bits)
    gs = g[0].graphed.stats()
    chk(f"{label}: opt_state.step == {n}", abs(int(g[0].opt_state.step) - n), 0)
    chk(f"{label}: 1 eager call, 1 capture, {n - 2} replays",
        abs(gs["eager_calls"] - 1) + abs(gs["captures"] - 1) + abs(gs["replays"] - (n - 2)), 0)
    per = per_step_launches(c.use_kernels if c.kernel_form(True, dev) != "eager" else "0", NB,
                            kf_launches(c, batches[0][0].shape[0], batches[0][0].shape[-1]))
    chk(f"{label}: launches == per_step_launches x {n} {counts}",
        max(abs(v - n * per.get(k, 0)) for k, v in counts.items()), 0)
    info = next(iter(g[0].graphed.graphs().values()))
    row = {"eager_bit_equal_to_eager": eager_bits, "graphed_bit_equal_to_eager": bits,
           "capture_ms": info["capture_ms"], "pool_bytes": info["pool_bytes"],
           "eager_peak_gb": e[2], "graphed_peak_gb": g[2]}
    order = [("eager", e[0]), ("graphed", g[0])]
    if in_turns:
        order += order[::-1]
    for side, step in order:
        for k, v in _step_timing(step, batches[0], busy).items():
            row.setdefault(f"{side}_{k}", []).append(v)
    times = {side: f"{row[side + '_ms']} ms" + (f" (busy {row[side + '_busy_ms']}, idle "
                                                 f"{row[side + '_idle_share']})" if busy else "")
             for side in ("eager", "graphed")}
    log(f"  {label}: eager {times['eager']}, graphed {times['graphed']}; capture "
        f"{row['capture_ms']:.1f} ms, pool {row['pool_bytes'] / 1e9:.3f} GB, peak eager "
        f"{row['eager_peak_gb']:.3f} / graphed {row['graphed_peak_gb']:.3f} GB; bit-equal "
        f"{bits} (eager twice {eager_bits})")
    if library:
        row["graphed_library_launches"] = _library_by_depth(chk, label, c, dev, batches, g[0])
    return row


def train_graph_phase(cfg, dev, hybrid_run, tmp):
    """The train step and the CV step as CUDA graphs (training/solver.
    GraphedStep): (a) TRAIN_GRAPH_STEPS steps graphed against eager per
    training form, bit for bit where two eager runs are, with opt_state.step,
    launches, capture ms, pool bytes, peak memory and step ms (events,
    device busy, idle share); (b) set_lr between replays; (c) the train CLI
    two epochs graphed against eager, then graphed: --continue_from
    epoch1.ckpt against the graphed two-epoch run, and a resume from a
    latest.ckpt cut mid-epoch (batch 2, 5 steps per epoch, cut at step 3)
    against the uncut run, histories and parameters; (d) the scaled
    config's hybrid step at batch
    2 x 8 s. Returns (results, the kernel launches of the graphed
    two-epoch CLI run: the main path's training launches, replays
    included)."""
    import dataclasses

    from convtasnet_torch.cli.train import main as train_main
    from convtasnet_torch.data.dataset import AudioDataset
    from convtasnet_torch.models import graphed
    from convtasnet_torch.models.conv_tasnet import init_params
    from convtasnet_torch.tools import bench_scaled_config as bsc
    from convtasnet_torch.tools._bench import device_batch
    from convtasnet_torch.training.checkpoint import load_checkpoint
    from convtasnet_torch.training.optim import tree_leaves

    chk = Checks("train-graph phase")
    NB = cfg.R * cfg.X
    n = TRAIN_GRAPH_STEPS
    ds = AudioDataset(hybrid_run["tr"], 5)
    batches = [tuple(torch.from_numpy(np.asarray(a)).to(dev)
                     for a in (b.mixture, b.lengths, b.source))
               for b in (ds.load_batch(i) for i in range(len(ds)))]
    res = {"steps": {}}
    log(f" (a) {n} steps graphed vs eager (MAX_GRAPHS 0), bf16, batch 5 x 4 s, "
        f"{len(batches)} batches in turn:")
    for label, form, remat, norm in TRAIN_GRAPH_FORMS:
        c = dataclasses.replace(cfg, use_kernels=form, remat=remat, norm_type=norm)
        # Device busy where the step's host cost is the question: the
        # main path and the remat modes.
        res["steps"][label] = _train_graph_form(chk, label, c, dev, batches, NB,
                                                in_turns=label == "hybrid",
                                                busy=label in ("hybrid", "0+block", "0+dots"),
                                                library=label in ("hybrid", "whole"))
        torch.cuda.empty_cache()

    log(" (b) set_lr between replays (hybrid):")
    c = dataclasses.replace(cfg, use_kernels="hybrid")
    params, state = init_params(torch.Generator(device=dev).manual_seed(0), c, device=dev)
    runs = {name: _graph_step_run(c, dev, params, state, batches, 4, cap, lr_at)
            for name, cap, lr_at in (("graphed", graphed.MAX_GRAPHS, 3), ("eager", 0, 3),
                                     ("full rate", graphed.MAX_GRAPHS, None))}

    def delta(run):
        return [a - b for a, b in zip(tree_leaves(run[0].params), run[3])]

    dg, de, df = delta(runs["graphed"]), delta(runs["eager"]), delta(runs["full rate"])
    gs = runs["graphed"][0].graphed.stats()
    chk("set_lr: the halved step was a replay", float(gs["replays"] != 2), 0)
    bits = res["steps"]["hybrid"]["eager_bit_equal_to_eager"]
    chk("set_lr: replayed step's change vs eager's at the halved rate (relative L2)",
        max(rel_l2(a, b) for a, b in zip(dg, de)), 0.0 if bits else TOL_GRAD_BF16)
    ratio = float(torch.cat([d.flatten() for d in dg]).norm()
                  / torch.cat([d.flatten() for d in df]).norm())
    chk(f"set_lr: change at the halved rate / at the full rate ({ratio:.6f}) - 0.5",
        abs(ratio - 0.5), TOL_LR_RATIO)
    res["set_lr_ratio"] = ratio
    del runs, dg, de, df
    torch.cuda.empty_cache()

    log(" (c) train CLI --use_kernels hybrid, graphed vs eager (MAX_GRAPHS 0):")
    argv = hybrid_run["argv"]  # batch 5 (2 steps per epoch), --save_every_steps 1
    folder = os.path.join(tmp, "graph_cli")
    cli = {}

    def cli_run(name, cap, *extra):
        saved, graphed.MAX_GRAPHS = graphed.MAX_GRAPHS, cap
        reset_all_counts()
        try:
            out = train_main(argv + [*extra, "--save_folder", os.path.join(folder, name)])
        finally:
            graphed.MAX_GRAPHS = saved
        torch.cuda.synchronize()
        cli[name] = (out, all_counts())
        log(f"  {name}: {out['steps']} steps, tr_loss {out['tr_loss']}, cv_loss "
            f"{out['cv_loss']}; graphs {out['graphs']}")
        ck = load_checkpoint(os.path.join(folder, name, "final.ckpt"), dev)
        chk(f"CLI {name}: final.ckpt loads with optimizer state",
            float(not ck["header"]["has_opt"]), 0)
        return out

    cap = graphed.MAX_GRAPHS
    cli_run("eager", 0, "--epochs", "2")
    cli_run("graphed", cap, "--epochs", "2")
    cli_run("continued", cap, "--epochs", "2", "--continue_from",
            os.path.join(folder, "graphed", "epoch1.ckpt"))
    # A mid-epoch cut: at batch 2 an epoch has 5 steps, and latest.ckpt is
    # last written at step 3 of epoch 2.
    cli_run("batch2", cap, "--epochs", "2", "--batch_size", "2", "--save_every_steps", "3")
    latest = os.path.join(folder, "batch2", "latest.ckpt")
    chk("CLI batch2: latest.ckpt cut at step 3",
        abs(load_checkpoint(latest)["header"]["extra"]["step_in_epoch"] - 3), 0)
    cli_run("resumed", cap, "--epochs", "2", "--batch_size", "2", "--continue_from", latest)
    per = per_step_launches("hybrid", NB, kf_launches(cfg, 5, 4 * SR))
    cv = auto_launches(NB)
    for name in ("eager", "graphed"):
        out, counts = cli[name]
        chk(f"CLI {name}: launches of the two-epoch run vs its counters {counts}",
            max(abs(v - out["steps"] * per.get(k, 0) - cv_forwards(out, 8) * cv.get(k, 0))
                for k, v in counts.items()), 0)
    (g, _), (e, _) = cli["graphed"], cli["eager"]
    ts = g["graphs"]["train_step"]
    chk("CLI graphed: train step 1 key, 1 capture, the rest replays",
        abs(ts["keys"] - 1) + abs(ts["captures"] - 1) + abs(ts["replays"] - (g["steps"] - 2)), 0)
    chk("CLI graphed: CV step 1 key, 1 capture",
        abs(g["graphs"]["cv_step"]["keys"] - 1) + abs(g["graphs"]["cv_step"]["captures"] - 1), 0)
    chk("CLI eager: every step eager",
        abs(e["graphs"]["train_step"]["eager_calls"] - e["steps"]), 0)
    chk("CLI resumed: steps 4 and 5 of epoch 2", abs(cli["resumed"][0]["steps"] - 2), 0)

    def rel(a, b):
        return float(np.max(np.abs(np.subtract(a, b)) / np.abs(b)))

    pairs = (("graphed", "eager"), ("continued", "graphed"), ("resumed", "batch2"))
    for a, b in pairs:
        for k in ("tr_loss", "cv_loss"):
            chk(f"CLI {a} vs {b}: {k} (relative)", rel(cli[a][0][k], cli[b][0][k]),
                TOL_LOSS_BF16)
    want = load_checkpoint(os.path.join(folder, "batch2", "epoch2.ckpt"), dev)["params"]
    got = load_checkpoint(os.path.join(folder, "resumed", "epoch2.ckpt"), dev)["params"]
    pairs_p = list(zip(tree_leaves(got), tree_leaves(want)))
    chk("CLI resumed vs batch2: parameters after epoch 2, worst leaf (relative L2)",
        max(rel_l2(a, b) for a, b in pairs_p), TOL_GRAD_BF16)
    res["cli_bit_equal"] = {f"{a}_vs_{b}": all(cli[a][0][k] == cli[b][0][k]
                                                for k in ("tr_loss", "cv_loss"))
                            for a, b in pairs}
    res["cli_bit_equal"]["resumed_vs_batch2_params"] = all(torch.equal(a, b)
                                                           for a, b in pairs_p)
    res["cli_graphs"] = g["graphs"]
    log(f"  CLI histories (and resumed parameters) bit for bit: {res['cli_bit_equal']}")

    log(" (d) scaled config, hybrid, batch 2 x 8 s, graphed vs eager:")
    scfg = bsc.scaled_cfg(**bsc.TIERS["hybrid"])
    sparams, sstate = init_params(torch.Generator(device=dev).manual_seed(0), scfg, device=dev)
    sbatch = [device_batch(0, 2, scfg.C, int(SCALED_SEG_S * bsc.SR), bsc.SR, dev)]
    e = _graph_step_run(scfg, dev, sparams, sstate, sbatch, 4, 0)
    eager_bits = _same_bits(e, _graph_step_run(scfg, dev, sparams, sstate, sbatch, 4, 0))
    reset_all_counts()
    g = _graph_step_run(scfg, dev, sparams, sstate, sbatch, 4, graphed.MAX_GRAPHS)
    counts = all_counts()
    per = per_step_launches("hybrid", scfg.R * scfg.X,
                            kf_launches(scfg, 2, int(SCALED_SEG_S * bsc.SR)))
    chk(f"scaled: launches == per_step_launches x 4 {counts}",
        max(abs(v - 4 * per.get(k, 0)) for k, v in counts.items()), 0)
    bits = _graph_vs_eager(chk, "scaled hybrid batch 2 x 8 s", g, e, eager_bits)
    info = next(iter(g[0].graphed.graphs().values()))
    row = {"eager_bit_equal_to_eager": eager_bits, "graphed_bit_equal_to_eager": bits,
           "capture_ms": info["capture_ms"],
           "pool_bytes": info["pool_bytes"], "eager_peak_gb": e[2], "graphed_peak_gb": g[2]}
    for side, step in (("eager", e[0]), ("graphed", g[0]), ("graphed", g[0]), ("eager", e[0])):
        for k, v in _step_timing(step, sbatch[0], iters=5).items():
            row.setdefault(f"{side}_{k}", []).append(v)
    res["scaled_hybrid_batch2"] = row
    log(f"  scaled hybrid: {json.dumps(row)}")
    del e, g, sparams, sstate
    torch.cuda.empty_cache()
    log(f"train-graph phase: {json.dumps(res)}")
    chk.done()
    return res, cli["graphed"][1]


REMAT_MODES = ("none", "repeat", "block", "dots")
SCALED_SEG_S = 8.0      # the scaled tool's default segment at 16 kHz
SCALED_STEPS = 3        # timed steps per tier (after the tool's 2 warm-up steps)
SCALED_INFER_ITERS = 23  # bench_infer: 3 warm-up + 20 timed forwards


def _grad_checks(chk, what, loss, grads, ref_loss, ref, ltol, gtol):
    """Loss and per-leaf gradients against a reference, as the train phase
    holds them; returns whether both are equal bit for bit."""
    chk(f"{what}: loss ({loss:.5f} vs {ref_loss:.5f})",
        abs(loss - ref_loss) / max(abs(ref_loss), 1e-6), ltol)
    worst = max((rel_l2(a, b), i) for i, (a, b) in enumerate(zip(grads, ref)))
    chk(f"{what}: gradients, worst leaf #{worst[1]} (relative L2)", worst[0], gtol)
    return loss == ref_loss and all(torch.equal(a, b) for a, b in zip(grads, ref))


def remat_phase(cfg, dev, chk):
    """(a) the eager train step (bf16, batch 5 x 4 s, paper config) per
    remat mode: loss and gradients against remat none, bit equality, step
    ms and the peak memory of forward + backward above what was held."""
    import dataclasses

    from convtasnet_torch.models.conv_tasnet import init_params
    from convtasnet_torch.tools._bench import device_batch
    from convtasnet_torch.training.optim import Optimizer
    from convtasnet_torch.training.solver import make_train_step

    params, state = init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    mix, lens, src = device_batch(0, 5, cfg.C, 4 * SR, SR, dev)
    out, ref = {}, None
    for mode in REMAT_MODES:
        c = dataclasses.replace(cfg, use_kernels="0", remat=mode)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_all_counts()
        loss, grads = step_grads(params, state, c, mix, src, lens)
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        chk(f"remat {mode}: kernel launches (eager chain)", float(sum(all_counts().values())), 0)
        if ref is None:
            ref, bits = (loss, grads), True
        else:
            bits = _grad_checks(chk, f"remat {mode} vs none, bf16", loss, grads, *ref,
                                TOL_LOSS_BF16, TOL_GRAD_BF16)
        opt = Optimizer("adam", lr=1e-3)
        step = make_train_step(c, opt, 5.0)
        opt_state = opt.init(params)
        ms, n = forward_ms(lambda: step(params, opt_state, state, mix, src, lens), iters=5,
                           warm=1)
        out[mode] = {"step_ms": ms, "peak_gb": peak_gb, "bit_equal_to_none": bits,
                     "loss": loss}
        log(f"  remat {mode}: train step batch 5 x 4 s bf16 median {ms:.3f} ms of {n}, "
            f"forward + backward peak {peak_gb:.3f} GB above {held / 1e9:.3f} GB held, "
            f"loss {loss:.6f}, bit-equal to none: {bits}")
        del grads
    peaks = [out[m]["peak_gb"] for m in ("none", "dots", "block")]
    chk(f"remat peak memory none > dots > block ({peaks})",
        float(not peaks[0] > peaks[1] > peaks[2]), 0)
    return out


def visualize_phase(cfg, dev, chk, hybrid_run, tmp):
    """(b) the train CLI with --visualize 1 for one epoch (the main path,
    --use_kernels hybrid): it writes loss.png or logs "visualize failed",
    and finishes with a checkpoint either way."""
    from convtasnet_torch.cli.train import main as train_main
    from convtasnet_torch.training.checkpoint import load_checkpoint

    NB = cfg.R * cfg.X
    folder = os.path.join(tmp, "exp_visualize")
    argv = hybrid_run["argv"] + ["--visualize", "1", "--save_folder", folder]
    reset_all_counts()
    out = train_main(argv)
    torch.cuda.synchronize()
    counts = all_counts()
    per = per_step_launches("hybrid", NB, kf_launches(cfg, 5, 4 * SR))
    cv = auto_launches(NB)
    n_cv = 4  # the train phase's cv utterances, one forward each
    chk(f"visualize run: launches of every kernel vs its counter {counts}",
        max(abs(v - out["steps"] * per.get(k, 0) - cv_forwards(out, n_cv) * cv.get(k, 0))
            for k, v in counts.items()), 0)
    with open(os.path.join(folder, "train.log")) as f:
        failed = [line.strip() for line in f if "visualize failed" in line]
    png = {n: os.path.exists(os.path.join(folder, n)) for n in ("loss.png", "loss_iter.png")}
    ck = load_checkpoint(os.path.join(folder, "final.ckpt"), dev)
    chk("visualize run: losses finite",
        float(not np.all(np.isfinite(out["tr_loss"] + out["cv_loss"]))), 0)
    chk("visualize run: loss.png written or the failure logged",
        float(not (png["loss.png"] or failed)), 0)
    chk("visualize run: final.ckpt has optimizer state", float(not ck["header"]["has_opt"]), 0)
    log(f"  train --visualize 1: {out['steps']} steps, tr_loss {out['tr_loss']}, "
        f"rendered {png}, logged failures {failed[:2]}")
    return {"rendered": png, "failures": failed[:2]}


def scaled_phase(dev, chk):
    """(c) the scaled config (BASELINE.json configs[4]: H=1024, X=10, R=6,
    L=32, 16 kHz) through tools/bench_scaled_config: every training tier at
    batch 2 and 8 x 8 s (ok / oom, step ms, peak GB), with the kernel
    launches of whole and hybrid against their counters (60 blocks,
    dilations up to 512); the hybrid and whole step's loss and gradients
    against the eager step at batch 2 (bf16); the forward at batch 1 and 2.
    Returns (rows, launches summed over the phase's runs)."""
    from convtasnet_torch.models.conv_tasnet import init_params
    from convtasnet_torch.tools import bench_scaled_config as bsc
    from convtasnet_torch.tools._bench import device_batch

    base = bsc.scaled_cfg()
    NB = base.R * base.X  # 60
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    rows = []
    for batch in (2, 8):
        for tier in bsc.TIERS:
            torch.cuda.synchronize()
            reset_all_counts()
            row = bsc.bench_train(tier, batch, SCALED_SEG_S, SCALED_STEPS, dev,
                                  graph=False)  # graphed: the train-graph phase
            torch.cuda.synchronize()
            counts = all_counts()
            add(counts)
            rows.append(row)
            state = (f"{row['step_ms']:.2f} ms/step, {row['audio_sps']:.1f} audio-s/s"
                     if row["ok"] else f"OOM ({row['error'][:120]})")
            log(f"  scaled train {tier} batch {batch}: form {row['form']}, {state}, "
                f"peak {row['peak_gb']:.2f} GB ({row['held_gb']:.2f} held before), "
                f"launches {counts}")
            if not row["ok"]:
                chk(f"scaled {tier} batch {batch}: failure is an out-of-memory error",
                    float(not row["oom"]), 0)
                continue
            chk(f"scaled {tier} batch {batch}: loss finite", float(not np.isfinite(row["loss"])), 0)
            form = {"hybrid": "hybrid", "whole": "whole"}.get(tier)
            per = (per_step_launches(form, NB, kf_launches(base, batch,
                                                           int(SCALED_SEG_S * bsc.SR)))
                   if form else {})
            if form:
                chk(f"scaled {tier} batch {batch}: form {row['form']}",
                    float(row["form"] != {"hybrid": "whole_tcn_train",
                                          "whole": "whole_block_train"}[tier]), 0)
            chk(f"scaled {tier} batch {batch}: launches of every kernel vs its counter",
                max(abs(v - row["steps_run"] * per.get(k, 0)) for k, v in counts.items()), 0)
    for tier in ("hybrid", "whole"):
        chk(f"scaled {tier}: fits at batch 8", float(not next(
            r for r in rows if r["tier"] == tier and r["batch"] == 8)["ok"]), 0)

    # The kernels against eager autograd at H=1024 and span 1024: one step's
    # loss and gradients at batch 2 x 8 s, bf16.
    params, state = init_params(torch.Generator(device=dev).manual_seed(0), base, device=dev)
    mix, lens, src = device_batch(0, 2, base.C, int(SCALED_SEG_S * bsc.SR), bsc.SR, dev)
    torch.cuda.empty_cache()
    ref_loss, ref = step_grads(params, state, bsc.scaled_cfg(**bsc.TIERS["eager_noremat"]),
                               mix, src, lens)
    grads_check = {}
    for tier in ("hybrid", "whole"):
        reset_all_counts()
        loss, grads = step_grads(params, state, bsc.scaled_cfg(**bsc.TIERS[tier]), mix, src,
                                 lens)
        torch.cuda.synchronize()
        counts = all_counts()
        add(counts)
        per = per_step_launches(tier, NB, kf_launches(base, 2, int(SCALED_SEG_S * bsc.SR)))
        chk(f"scaled step {tier}: launches of every kernel vs its counter {counts}",
            max(abs(v - per.get(k, 0)) for k, v in counts.items()), 0)
        _grad_checks(chk, f"scaled step {tier} vs eager, bf16, batch 2 x 8 s", loss, grads,
                     ref_loss, ref, TOL_LOSS_BF16, TOL_GRAD_BF16)
        grads_check[tier] = {"loss": loss, "eager_loss": ref_loss,
                             "worst_leaf_rel_l2": max(rel_l2(a, b) for a, b in zip(grads, ref))}
        del grads
    del ref, params, state
    torch.cuda.empty_cache()

    for batch in (1, 2):
        reset_all_counts()
        row = bsc.bench_infer(batch, SCALED_SEG_S, dev, graph=False)  # graphed: graph phase
        torch.cuda.synchronize()
        counts = all_counts()
        add(counts)
        rows.append(row)
        log(f"  scaled infer batch {batch}: form {row['kernel_tier']}, {row['latency_ms']:.3f} ms "
            f"({row['audio_sps']:.1f} audio-s/s), matmul floor {row['matmul_floor_ms']:.3f} ms "
            f"({row['matmul_floor_frac']:.3f} of it), peak {row['peak_gb']:.2f} GB")
        chk(f"scaled infer batch {batch}: form", float(row["kernel_tier"] != "whole_tcn"), 0)
        want = auto_launches(NB)
        chk(f"scaled infer batch {batch}: launches of every kernel vs its counter {counts}",
            max(abs(v - SCALED_INFER_ITERS * want.get(k, 0)) for k, v in counts.items()), 0)
    torch.cuda.empty_cache()
    return {"rows": rows, "grads": grads_check}, total


def options_phase(cfg, dev, hybrid_run, tmp):
    """The training options and the scaled config: (a) remat modes, (b)
    --visualize, (c) the scaled config's tiers. Returns (results, the
    kernel launches of the scaled config's runs)."""
    chk = Checks("options phase")
    torch.cuda.empty_cache()
    log(" (a) remat modes, eager train step at the paper config:")
    res = {"remat": remat_phase(cfg, dev, chk)}
    log(" (b) train --visualize 1:")
    res["visualize"] = visualize_phase(cfg, dev, chk, hybrid_run, tmp)
    log(" (c) the scaled config (H=1024, X=10, R=6, 16 kHz):")
    res["scaled"], scaled_launches = scaled_phase(dev, chk)
    chk.done()
    return res, scaled_launches


def timing_only(cfg, blocks, dev) -> int:
    """--timing: the twelve kernels' warm and cold-L2 device times alone (a
    fresh process on the card, so that two runs can be compared), one JSON
    line of rows."""
    from convtasnet_torch.ops.kernels import tcn_block as tb

    K = 3199
    Kp = -(-K // tb.ROW_ALIGN) * tb.ROW_ALIGN
    rows = {}
    fwd, _ = forward_kernel_specs(blocks, cfg, dev, M=8, K=K)
    rows.update(time_kernels(fwd, f"M=8, K_pad={Kp}, B={cfg.B}, H={cfg.H}", full=False))
    rows.update(time_kernels(train_specs(blocks, cfg, dev, K),
                             f"M=5, K_pad={Kp}, B={cfg.B}, H={cfg.H}", full=False))
    kernels = [{"name": k, **v} for k, v in rows.items()]
    log(card_line())
    log(json.dumps({"kernel_times": kernels, "profiler_blind": PROFILER_BLIND,
                    "device": torch.cuda.get_device_name(0)}))
    check_cold(kernels)
    if PROFILER_BLIND:
        raise AssertionError(f"torch.profiler fell short for {PROFILER_BLIND}")
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Chip smoke test of convtasnet_torch")
    ap.add_argument("--timing", action="store_true",
                    help="only build and time the kernels, warm and cold (no other phase)")
    ap.add_argument("--stream", action="store_true",
                    help="only the streaming phases: the stream phase and the stream block "
                         "kernel's (no other)")
    ap.add_argument("--kb2", action="store_true",
                    help="only KB2 at the train cells' shapes against its plain version, and "
                         "its warm and cold times there (no other phase)")
    ap.add_argument("--skip", action="store_true",
                    help="only the skip phase: the skip modes' kernels at the taslp widths "
                         "(no other)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    from convtasnet_torch.config import ConvTasNetConfig
    from convtasnet_torch.data.wavio import read_wav, write_wav
    from convtasnet_torch.models import graphed
    from convtasnet_torch.models.conv_tasnet import forward, init_params
    from convtasnet_torch.ops.kernels import _build, tcn_block as tb
    from convtasnet_torch.ops.kernels.whole_block import whole_block
    from convtasnet_torch.ops.kernels.whole_tcn import (PLAIN_STAGES, alloc_scratch,
                                                        tcn_chain, whole_tcn,
                                                        whole_tcn_reference)
    from convtasnet_torch.training.checkpoint import save_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # This process captures CUDA graphs and profiles hundreds of times:
    # CUPTI stays attached from its first profile on.
    graphed.keep_cupti()
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- build ----------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all(["tcn_block", "tcn_stream_block"] if args.stream
                               else ["tcn_block", "tcn_block_bwd"] if args.skip
                               else ["tcn_block", "tcn_block_bwd", "tcn_stream_block"])
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")
    if args.stream:
        log("stream phase:")
        with tempfile.TemporaryDirectory() as tmp:
            timing = stream_phase(ConvTasNetConfig(norm_type="cLN", causal=True), dev, tmp)
        log("stream block phase:")
        timing["stream_kernel"] = stream_block_phase(dev)
        log(card_line())
        log(json.dumps({"stream": timing, "profiler_blind": PROFILER_BLIND}))
        log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                               "kind": torch.cuda.get_device_name(0)}}))
        return 0
    if args.skip:
        skip_res, skip_kernels = skip_phase(dev)
        log(card_line())
        log(json.dumps({"skip": skip_res, "skip_kernels": skip_kernels,
                        "profiler_blind": PROFILER_BLIND}))
        if PROFILER_BLIND:
            raise AssertionError(f"torch.profiler fell short for {PROFILER_BLIND}")
        log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                               "kind": torch.cuda.get_device_name(0)}}))
        return 0
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
    if args.timing:
        return timing_only(cfg, blocks, dev)
    if args.kb2:
        kb2_cell_phase(blocks, cfg, dev)
        spec = {"tcn_bwd_dwconv": train_kernel_specs(blocks, cfg, dev, M=8, K=3199)[
            "tcn_bwd_dwconv"]}
        row = time_kernels(spec, "")["tcn_bwd_dwconv"]
        log(card_line())
        log(json.dumps({"kb2": row, "profiler_blind": PROFILER_BLIND}))
        check_cold([{"name": "tcn_bwd_dwconv", **row}])
        if PROFILER_BLIND:
            raise AssertionError(f"torch.profiler fell short for {PROFILER_BLIND}")
        log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                               "kind": torch.cuda.get_device_name(0)}}))
        return 0

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
                want, _ = whole_tcn_reference(x, *stacked, norm, causal, cfg.X, valid_k=K)
                got, _ = whole_tcn(x, *stacked, norm, causal, cfg.X, valid_k=K)
                ctol = TOL_F32 if dt == torch.float32 else TOL_CHAIN_BF16
                chk(f"whole_tcn chain {tag} {norm} causal={causal}", rel_l2(got, want), ctol)
                wantb, _ = tcn_chain(x, *stacked, norm, causal,
                                     [2 ** (i % cfg.X) for i in range(NB)], K, False,
                                     PLAIN_STAGES)
                gotb = x.clone()
                scratch = alloc_scratch(M, Kp, H, dt, dev)
                for i in range(NB):
                    gotb, _ = whole_block(gotb, *[t[i] for t in stacked], norm,
                                          2 ** (i % cfg.X), causal, valid_k=K,
                                          scratch=scratch)
                chk(f"whole_block chain {tag} {norm} causal={causal}", rel_l2(gotb, wantb), ctol)
                chk(f"chains {tag} {norm} causal={causal} pad rows zero",
                    float(got[:, K:].abs().max() + gotb[:, K:].abs().max()), 0.0)
    torch.cuda.synchronize()
    chk.done()

    gemm_width_phase(dev)
    span_limit_phase(dev)
    errs["tcn_fold_weights"] = fold_phase(dev)

    # ---- training kernel phase ---------------------------------------------
    train_errs = train_kernel_phase(blocks, stacked, cfg, dev)
    kb2_cell_phase(blocks, cfg, dev)
    hybrid_chain = hybrid_chain_phase(stacked, cfg, dev)
    skip_res, skip_kernels = skip_phase(dev)
    torch.cuda.empty_cache()

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
            want = {"auto": auto_launches(NB),
                    "block": dict(tcn_in_gemm=NB, tcn_dwconv=NB, tcn_out_gemm_unfold=NB),
                    "0": {}}[form]
            for k, v in counts.items():
                chk(f"{form}: {k} launches == {want.get(k, 0)} per forward",
                    abs(v - want.get(k, 0) * n_forwards), 0)
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
        eval_timing, eval_sets = evaluate_phase(cfg, dev, ckpt, tmp)

        # ---- graph phase: the forwards as CUDA graphs (models/graphed.py) ----
        log("graph phase:")
        t0 = time.perf_counter()
        graph_timing = graph_phase(cfg, dev, params, state, ckpt, eval_sets, tmp)
        graph_timing["phase_s"] = time.perf_counter() - t0

        # ---- stream phase: the stream CLI and StreamingSeparator ------------
        log("stream phase:")
        t0 = time.perf_counter()
        stream_timing = stream_phase(ConvTasNetConfig(norm_type="cLN", causal=True), dev, tmp)
        stream_timing["phase_s"] = time.perf_counter() - t0
        log("stream block phase:")
        stream_timing["stream_kernel"] = stream_block_phase(dev)

    # ---- train phase: the train CLI and one step of each form ---------------
    log("train phase:")
    # Kept to the end: the parallel phase trains on the same dataset.
    train_tmp = tempfile.TemporaryDirectory()
    train_timing, hybrid_run = train_phase(cfg, dev, train_tmp.name)

    # ---- train-graph phase: the train and CV steps as CUDA graphs ----------
    log("train-graph phase:")
    t0 = time.perf_counter()
    # The main path's training launches: its graphed two-epoch CLI run.
    train_graph, train_counts = train_graph_phase(cfg, dev, hybrid_run, train_tmp.name)
    train_graph["phase_s"] = time.perf_counter() - t0

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

    fwd_specs, path_of = forward_kernel_specs(blocks, cfg, dev, M=M, K=K)
    kernels = []
    for name, row in time_kernels(fwd_specs, f"M={M}, K_pad={Kp}, B={B}, H={H}").items():
        kernels.append({
            "name": name, "route": "cuda", "source": fwd_specs[name].get("source", SOURCE),
            "design": DESIGN[name], "replaces": fwd_specs[name]["replaces"],
            "launches": path_counts[path_of[name]][name],
            "path": f"separate --use_kernels {path_of[name]}",
            "max_abs_err": errs[name], **row,
        })
    M5 = 5
    tspecs = train_specs(blocks, cfg, dev, K)
    for name, row in time_kernels(tspecs, f"M={M5}, K_pad={Kp} ({M5 * Kp} rows), B={B}, "
                                          f"H={H}").items():
        kernels.append({
            "name": name, "route": "cuda", "source": tspecs[name]["source"],
            "design": DESIGN[name], "replaces": tspecs[name]["replaces"],
            "launches": train_counts[name],
            "path": "train --use_kernels hybrid --epochs 2, steps as CUDA graphs",
            "max_abs_err": train_errs[name], **row,
        })
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on its path")
    check_cold(kernels)

    train_timing.update(backward_timing(stacked, cfg, dev, M=M5, K=K))

    # ---- options phase: remat, --visualize, the scaled config ---------------
    log("options phase:")
    t0 = time.perf_counter()
    opt_res, scaled_launches = options_phase(cfg, dev, hybrid_run, train_tmp.name)
    opt_res["phase_s"] = time.perf_counter() - t0
    for k in kernels:
        k["scaled_launches"] = scaled_launches.get(k["name"], 0)
        if k["scaled_launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on the scaled config's path")

    # ---- parallel phase: DP / TP over torch.distributed ---------------------
    # Last, so that no kernel time above depends on it: one H100 run had
    # torch.profiler record no device time after this phase, which neither
    # tools/check_profiler.py nor a rerun in that order reproduced
    # (PERF.md section 7).
    log("parallel phase:")
    t0 = time.perf_counter()
    with train_tmp:
        par_timing = parallel_phase(cfg, dev, train_tmp.name, hybrid_run)
    par_timing["phase_s"] = time.perf_counter() - t0
    log(json.dumps({"build_s": build_s, "latency": latency, "train": train_timing,
                    "hybrid_chain": hybrid_chain, "skip": skip_res,
                    "train_graph": train_graph, "evaluate": eval_timing, "graph": graph_timing,
                    "stream": stream_timing, "options": opt_res, "parallel": par_timing,
                    "profiler_blind": PROFILER_BLIND}))
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"skip_kernels": skip_kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
