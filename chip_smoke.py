"""Chip smoke test of the PyTorch/CUDA port (convtasnet_torch) on one GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit);
2. builds the kernels from convtasnet_torch/csrc with nvcc (timed);
3. kernel phase: holds every kernel form against its plain PyTorch version
   at the paper widths (B=256, H=512, P=3) and the main path's shapes
   (batch 8, K=3199 frames, padded to 3200), for every dilation 1..128,
   gLN and cLN, causal and non-causal, in f32 and in bf16, then the
   32-block chains of both forms;
4. slice phase: writes seeded paper-config weights with the port's
   save_checkpoint and synthetic 8 kHz mixtures with its wavio, then runs
   `convtasnet_torch.cli.separate` on cuda with --batch_size 8 and
   --use_kernels auto (the main path), block and 0; checks the wavs, the
   launch counts (NB per forward for every kernel of the form) and the
   agreement of the kernel forms with the eager run;
5. times the forward at batch 8 and batch 1 (4 s at 8 kHz) and each kernel
   per launch, beside its plain version, one PyTorch call where there is
   one, and its roofline bound;
6. prints the card again, a {"kernels": [...]} line and, last,
   {"ok": true, "device": {...}}.

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

# H100 SXM data-sheet peaks (dense), for the roofline bound of each kernel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Stated tolerances (max |kernel - plain| / max |plain|, or relative L2).
TOL_F32 = 1e-4          # single kernels and chains in f32
TOL_BF16 = 1.6e-2       # single kernels in bf16: a few bf16 ulps
TOL_CHAIN_BF16 = 1e-2   # 32-block chain in bf16, relative L2
TOL_E2E_BF16 = 5e-2     # separated wavs, kernel forms vs eager, relative L2
TOL_E2E_F32 = 1e-3      # f32 forward, kernel forms vs eager, relative L2

SR = 8000
SOURCE = "convtasnet_torch/csrc/tcn_block.cu"
WHOLE_TCN = "convtasnet_tpu/ops/pallas/whole_tcn.py:55"
WHOLE_BLOCK = "convtasnet_tpu/ops/pallas/fused_whole_block.py:57"


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
    reports = _build.build_all(["tcn_block"])
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")

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

    def dw_all(fn):
        # One launch per dilation of a repeat (the chain's mix of halos).
        def run():
            for xi in range(cfg.X):
                fn(y1, s1, a1, blocks["in_gamma"][nb], blocks["in_beta"][nb],
                   blocks["dw_w"][nb], a2, norm, 2 ** xi, cfg.causal, K)
        return run

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
            replaces=WHOLE_TCN,
            kernel=dw_all(tb.tcn_dwconv), plain=dw_all(tb.dwconv_plain), library=None,
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
    kernels = []
    for name, s in specs.items():
        ms = cuda_ms(s["kernel"]) / s["per"]
        plain_ms = cuda_ms(s["plain"]) / s["per"]
        lib_ms = cuda_ms(s["library"]) if s["library"] else None
        t_bytes = s["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = s["flops"] / PEAK_FLOPS[dt] * 1e3
        bound = max(t_bytes, t_ops)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": s["replaces"],
            "launches": path_counts[path_of[name]][name],
            "path": f"separate --use_kernels {path_of[name]}",
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        })
        log(f"  {name}: {ms:.4f} ms/launch (plain {plain_ms:.4f}, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'}, bound {bound:.4f} "
            f"by {kernels[-1]['bound_by']}) at M={M}, K_pad={Kp}, B={B}, H={H}, bf16")
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on its path")

    log(json.dumps({"build_s": build_s, "latency": latency}))
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
