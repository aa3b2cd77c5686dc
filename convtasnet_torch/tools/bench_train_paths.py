"""Train-step time of the port's training forms at the paper config.

    python -m convtasnet_torch.tools.bench_train_paths [path ...] [--batch 5] \\
        [--steps 40] [--graph 0|1] [--device cuda] [--tiny]

A path is a --use_kernels training form, with a remat mode after "+":
`0` (the eager chain), `hybrid` (the whole-TCN training op), `whole`
(the per-block recompute op), and e.g. `0+dots`, `0+block`, `0+repeat`.
The kernel forms ignore remat (`hybrid+block` runs as `hybrid`). Default:
0 hybrid.

Seeded paper-config weights (N=256, L=20, B=256, H=512, P=3, X=8, R=4,
gLN, bf16; --tiny: a small f32 config), one data/synthetic batch of 4 s
at 8 kHz, Adam. Per path one JSON line: `fwd_ms`, the training forward
and loss without backward, then `step_ms`, the whole make_train_step
(forward, loss, backward, clip, update), each the mean of `steps` calls
after 2 warm-up calls, timed with CUDA events on a card (the host clock on
the CPU); `peak_gb` is torch.cuda.max_memory_allocated over the path.
With --graph 1 (the default, as the train CLI runs on one card) the step
is training/solver.GraphedStep: the first warm-up call runs eagerly, the
second captures the CUDA graph, and every timed step is a replay; the row
carries `graphed`, `capture_ms` and `pool_bytes` (models/graphed.graph_row).
--graph 0 times the eager step. On the CPU both run eagerly.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..config import ConvTasNetConfig
from ..models.conv_tasnet import chain_form, forward, init_params, resolve_device
from ..models.graphed import graph_row
from ..ops.loss import cal_loss
from ..training.optim import Optimizer
from ..training.solver import GraphedStep, make_train_step
from ._bench import TINY, device_batch, device_name, timed_ms

SECONDS, SR = 4.0, 8000


def parse_path(path: str) -> dict:
    """`form[+remat]` -> ConvTasNetConfig keywords."""
    use_kernels, _, remat = path.partition("+")
    return {"use_kernels": use_kernels, "remat": remat or False}


def bench_path(path: str, batch: int, steps: int, dev: torch.device, tiny: bool = False,
               graph: bool = True) -> dict:
    cfg = ConvTasNetConfig(**(TINY if tiny else {}), **parse_path(path))
    T = int(SECONDS * SR)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    params, state = init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    mix, lens, src = device_batch(0, batch, cfg.C, T, SR, dev)

    @torch.no_grad()
    def fwd_loss():
        return cal_loss(src, forward(params, state, cfg, mix, train=True)[0], lens)[0]

    fwd_ms = timed_ms(fwd_loss, steps, 2, dev)
    opt = Optimizer("adam", lr=1e-3)
    step = make_train_step(cfg, opt, 5.0)
    carry = [params, opt.init(params), state]
    if graph:
        step = GraphedStep(step, *carry, tag=(cfg.kernel_form(True, dev),))

    def one():
        carry[0], carry[1], carry[2], _, _ = step(*carry, mix, src, lens)

    step_ms = timed_ms(one, steps, 2, dev)
    return {"path": path, "use_kernels": cfg.use_kernels, "remat": cfg.remat,
            "form": chain_form(cfg, True, batch, cfg.num_frames(T), dev), "batch": batch,
            "step_ms": step_ms, "fwd_ms": fwd_ms, "audio_sps": batch * SECONDS / (step_ms / 1e3),
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None,
            "steps": steps, **graph_row(step.graphed if graph else None),
            "device": device_name(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser("Train-step time per training form")
    ap.add_argument("paths", nargs="*", default=["0", "hybrid"])
    ap.add_argument("--batch", type=int, default=5)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--graph", type=int, default=1, choices=(0, 1),
                    help="1: time replays of the step's CUDA graph; 0: the eager step")
    ap.add_argument("--tiny", action="store_true", help="a small f32 config (CPU tests)")
    ap.add_argument("--device", default="cuda", type=str,
                    help="torch device (default cuda; fails without a GPU unless cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = []
    for path in args.paths or ["0", "hybrid"]:
        rows.append(bench_path(path, args.batch, args.steps, dev, args.tiny, bool(args.graph)))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
