"""Forward time of the port's inference forms at the paper config.

    python -m convtasnet_torch.tools.bench_infer_paths [path ...] [--batch 8] \\
        [--steps 50] [--graph 0|1] [--device cuda] [--tiny]

A path is a --use_kernels value: `auto` (the whole-TCN form: per block
the three Hopper kernels, norm2 folded into out_w), `block` (the
whole-block form, norm2 unfolded) or `0` (the eager chain). Default: all
three.

Seeded paper-config weights (--tiny: a small f32 config), a random batch
of 4 s at 8 kHz, the forward under inference mode. Per path one JSON
line: `fwd_ms`, the mean of `steps` back-to-back forwards after 3 warm-up
forwards, timed with CUDA events on a card (the host clock on the CPU),
and the form cfg.kernel_form picked. With --graph 1 (the default, as the
separate and evaluate CLIs run) the forward goes through
models/graphed.GraphedForward: the warm-up's first call runs eagerly, the
second captures the CUDA graph, and every timed call is a replay; the row
then carries `capture_ms` and `pool_bytes`. --graph 0 times the eager
forward. On the CPU both run eagerly.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..config import ConvTasNetConfig
from ..models.conv_tasnet import forward, init_params, resolve_device
from ..models.graphed import GraphedForward, graph_row
from ._bench import TINY, device_batch, device_name, timed_ms

SECONDS, SR = 4.0, 8000
PATHS = ["auto", "block", "0"]


def bench_path(path: str, batch: int, steps: int, dev: torch.device, tiny: bool = False,
               graph: bool = True) -> dict:
    cfg = ConvTasNetConfig(**(TINY if tiny else {}), use_kernels=path)
    params, state = init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    mix = device_batch(1, batch, cfg.C, int(SECONDS * SR), SR, dev)[0]
    form = cfg.kernel_form(False, dev)

    def fwd(m):
        return forward(params, state, cfg, m)[0]

    fn = GraphedForward(fwd, tag=(form,)) if graph else fwd
    with torch.inference_mode():
        ms = timed_ms(lambda: fn(mix), steps, 3, dev)
    return {"path": path, "form": form, "batch": batch, "fwd_ms": ms,
            "audio_sps": batch * SECONDS / (ms / 1e3), "steps": steps,
            **graph_row(fn if graph else None), "device": device_name(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser("Forward time per inference form")
    ap.add_argument("paths", nargs="*", default=PATHS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--graph", type=int, default=1, choices=(0, 1),
                    help="1: time replays of the forward's CUDA graph; 0: the eager forward")
    ap.add_argument("--tiny", action="store_true", help="a small f32 config (CPU tests)")
    ap.add_argument("--device", default="cuda", type=str,
                    help="torch device (default cuda; fails without a GPU unless cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = []
    for path in args.paths or PATHS:
        rows.append(bench_path(path, args.batch, args.steps, dev, args.tiny, bool(args.graph)))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
