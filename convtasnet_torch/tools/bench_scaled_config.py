"""The scaled config (BASELINE.json configs[4]) on one card: which training
tiers fit its memory, and at what step time; and the forward's latency.

    python -m convtasnet_torch.tools.bench_scaled_config train [--batch 2] \\
        [--seg_sec 8] [--tiers eager_noremat,eager_dots,whole,hybrid] [--steps 10] \\
        [--graph 0|1]
    python -m convtasnet_torch.tools.bench_scaled_config infer [--batch 1] [--graph 0|1]

The config: N=256, L=32, B=256, H=1024, P=3, X=10, R=6, C=2, gLN,
non-causal, bf16, on 16 kHz audio (8 s = K 7,999 frames). It sits on the
kernels' launch limits (H = GEMM_MAX_H, and the span (P-1) * 2^(X-1) =
BWD_MAX_SPAN; ops/kernels/limits.py), so `whole` and `hybrid` run every
training kernel there.

train: per tier, one seeded model, Adam, `make_train_step` on a
data/synthetic batch; 2 warm-up steps, then `steps` steps timed with CUDA
events. Tiers: eager_noremat (--use_kernels 0), eager_dots (0 with remat
"dots"), whole (the per-block recompute op) and hybrid (the whole-TCN
training op, or its per-block form behind the memory gate). An
out-of-memory error gives a row with ok false and oom true, and the memory
is freed before the next tier. `peak_gb` is torch.cuda.max_memory_allocated
over the tier, `held_gb` what the process held before it (in a bigger run,
such as chip_smoke.py's, the peak includes it), `steps_run` the steps it
launched (warm-up included). With --graph 1 (the default, as the train CLI
runs on one card) the step is training/solver.GraphedStep, captured in the
warm-up, so every timed step is a replay; its row carries `graphed`,
`capture_ms` and `pool_bytes` (`peak_gb` then covers the capture, whose
activations the graph's pool keeps). --graph 0 times the eager step.

infer: the forward (--use_kernels auto) at --batch, under inference mode,
timed with CUDA events over 20 calls (with --graph 1, the default, as the
CLIs run it: replays of its CUDA graph, models/graphed.GraphedForward,
captured in the warm-up; --graph 0 the eager forward); `kernel_tier` is the form
cfg.kernel_form(False, device) picks, `matmul_floor_ms` the time of its
contractions at the H100's bf16 peak (`floor_peak`) and
`matmul_floor_frac` that floor over the measured latency.

One JSON line per measurement; each names its device. --device cpu (with
--tiny, a small f32 config) runs the same code on the CPU, where the times
are the CPU's and no device memory or floor share is reported.
"""

from __future__ import annotations

import argparse
import gc
import json

import torch

from ..config import ConvTasNetConfig
from ..models.conv_tasnet import chain_form, forward, init_params, resolve_device
from ..models.graphed import GraphedForward, graph_row
from ..training.optim import Optimizer
from ..training.solver import GraphedStep, make_train_step
from ._bench import (H100_BF16_FLOPS, H100_PEAK_NAME, TINY, device_batch, device_name,
                     forward_matmul_flops, timed_ms)

SR = 16000
SCALED = dict(N=256, L=32, B=256, H=1024, P=3, X=10, R=6, C=2, norm_type="gLN",
              causal=False, compute_dtype="bfloat16")
TIERS = {
    "eager_noremat": dict(use_kernels="0", remat=False),
    "eager_dots": dict(use_kernels="0", remat="dots"),
    "whole": dict(use_kernels="whole", remat=False),
    "hybrid": dict(use_kernels="hybrid", remat=False),
}
WARM = 2


def scaled_cfg(tiny: bool = False, **kw) -> ConvTasNetConfig:
    return ConvTasNetConfig(**{**SCALED, **(TINY if tiny else {}), **kw})


def _describe(cfg: ConvTasNetConfig) -> str:
    return (f"N={cfg.N},L={cfg.L},B={cfg.B},H={cfg.H},P={cfg.P},X={cfg.X},R={cfg.R},"
            f"{cfg.norm_type},{'bf16' if cfg.compute_dtype == 'bfloat16' else 'f32'}")


def _train_steps(cfg, batch, T, steps, dev, graph=True):
    """(ms per step, last loss, graph_row of the step) of `steps` timed
    steps after WARM."""
    params, state = init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    opt = Optimizer("adam", lr=1e-3)
    step = make_train_step(cfg, opt, 5.0)
    mix, lens, src = device_batch(0, batch, cfg.C, T, SR, dev)
    carry = [params, opt.init(params), state, None]
    if graph:
        step = GraphedStep(step, *carry[:3], tag=(cfg.kernel_form(True, dev),))

    def one():
        carry[0], carry[1], carry[2], carry[3], _ = step(carry[0], carry[1], carry[2],
                                                         mix, src, lens)

    ms = timed_ms(one, steps, WARM, dev)
    return ms, float(carry[3]), graph_row(step.graphed if graph else None)


def bench_train(tier: str, batch: int, seg_sec: float, steps: int, dev: torch.device,
                tiny: bool = False, graph: bool = True) -> dict:
    cfg = scaled_cfg(tiny, **TIERS[tier])
    T = int(seg_sec * SR)
    out = {"metric": "scaled_config_train", "tier": tier, "batch": batch, "seg_sec": seg_sec,
           "sr": SR, "config": _describe(cfg), "use_kernels": cfg.use_kernels,
           "remat": cfg.remat, "form": chain_form(cfg, True, batch, cfg.num_frames(T), dev),
           "device": device_name(dev)}
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    out["held_gb"] = torch.cuda.memory_allocated(dev) / 1e9 if on_card else None
    try:
        ms, loss, row = _train_steps(cfg, batch, T, steps, dev, graph)
    except torch.OutOfMemoryError as e:
        out.update(ok=False, oom=True, steps_run=None, error=str(e)[:300], **graph_row(None))
    else:
        out.update(ok=True, oom=False, step_ms=ms, audio_sps=batch * seg_sec / (ms / 1e3),
                   loss=loss, steps_run=WARM + steps, **row)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
    gc.collect()  # the failed tier's tensors, before the next tier allocates
    if on_card:
        torch.cuda.empty_cache()
    return out


def bench_infer(batch: int, seg_sec: float, dev: torch.device, tiny: bool = False,
                iters: int = 20, graph: bool = True) -> dict:
    cfg = scaled_cfg(tiny, use_kernels="auto")
    T = int(seg_sec * SR)
    params, state = init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    mix = device_batch(1, batch, cfg.C, T, SR, dev)[0]
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    def fwd(m):
        return forward(params, state, cfg, m)[0]

    fn = GraphedForward(fwd, tag=(cfg.kernel_form(False, dev),)) if graph else fwd
    with torch.inference_mode():
        ms = timed_ms(lambda: fn(mix), iters, 3, dev)
    floor_ms = forward_matmul_flops(cfg, batch, T) / H100_BF16_FLOPS * 1e3
    return {"metric": "scaled_config_infer", "batch": batch, "seg_sec": seg_sec, "sr": SR,
            "config": _describe(cfg), "kernel_tier": cfg.kernel_form(False, dev),
            "latency_ms": ms, "audio_sps": batch * seg_sec / (ms / 1e3),
            "matmul_floor_ms": floor_ms, "floor_peak": H100_PEAK_NAME,
            "matmul_floor_frac": floor_ms / ms if on_card else None,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None,
            **graph_row(fn if graph else None), "device": device_name(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser("The scaled config (H=1024, X=10, R=6) on one device")
    ap.add_argument("mode", choices=["train", "infer"])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seg_sec", type=float, default=8.0)
    ap.add_argument("--tiers", type=str, default=",".join(TIERS))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--graph", type=int, default=1, choices=(0, 1),
                    help="1 times replays of the step's or the forward's CUDA graph, 0 the "
                         "eager step or forward")
    ap.add_argument("--tiny", action="store_true", help="a small f32 config (CPU tests)")
    ap.add_argument("--device", default="cuda", type=str,
                    help="torch device (default cuda; fails without a GPU unless cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = []
    if args.mode == "train":
        for tier in args.tiers.split(","):
            rows.append(bench_train(tier, args.batch, args.seg_sec, args.steps, dev, args.tiny,
                                    bool(args.graph)))
            print(json.dumps(rows[-1]), flush=True)
    else:
        rows.append(bench_infer(args.batch, args.seg_sec, dev, args.tiny,
                                graph=bool(args.graph)))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
