"""Where the time of one separation forward, or one train step, goes on
one CUDA device.

    python -m convtasnet_torch.tools.profile_forward --batch 8 --use_kernels auto [--graph 0|1]
    python -m convtasnet_torch.tools.profile_forward --train --batch 5 --use_kernels hybrid \\
        [--graph 0|1]

Seeded paper-config weights, random mixtures (and, with --train, random
sources) of 4 s at 8 kHz; --train profiles make_train_step (forward, uPIT
loss, backward, clip, Adam update). Prints one JSON line: the host-clock
time per call (synchronised), the host's enqueue time per call of
back-to-back calls (no synchronisation), the CUDA-event time, the device time by
kernel from torch.profiler over 10 calls (records counted: tools/_bench.timed),
the device's idle share, 1 - (device time per call) / (CUDA-event time per
call), and the peak of allocated device memory. With --out the same JSON is
also written to a file.

The forward runs as the separate and evaluate CLIs run it, through
models/graphed.GraphedForward, and the train step as the train CLI runs
it on one card, through training/solver.GraphedStep (--graph 1, the
default): the first warm-up call is eager, the second captures the CUDA
graph, and every call timed or profiled after it is a replay (`replays`
counts them; `eager_calls` must be 0). --graph 0 profiles the eager
forward or step.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import numpy as np
import torch

from ..config import USE_KERNELS_CHOICES, ConvTasNetConfig
from ..models import graphed
from ..models.conv_tasnet import forward, init_params, resolve_device
from ..training.optim import Optimizer
from ..training.solver import GraphedStep, make_train_step
from ._bench import timed


SECONDS, ITERS = 4.0, 10


def profile(batch: int, use_kernels: str, train: bool = False, graph: bool = True) -> dict:
    dev = resolve_device("cuda")
    cfg = dataclasses.replace(ConvTasNetConfig(), use_kernels=use_kernels)
    params, state = init_params(torch.Generator(device=dev).manual_seed(1234),
                                cfg, device=dev)
    rng = np.random.default_rng(0)
    T = int(SECONDS * 8000)
    src = torch.from_numpy(rng.normal(size=(batch, cfg.C, T)).astype(np.float32)).to(dev)
    mix = src.sum(1)
    if train:
        opt = Optimizer("adam")
        opt_state = opt.init(params)
        step = make_train_step(cfg, opt, 5.0)
        carry = [params, opt_state, state]
        run = GraphedStep(step, *carry, tag=(cfg.kernel_form(True, dev),)) if graph else step
        lens = torch.full((batch,), T, dtype=torch.int32, device=dev)

        def fwd():
            carry[0], carry[1], carry[2], loss, _ = run(*carry, mix, src, lens)
            return loss
    else:
        def eager(m):
            return forward(params, state, cfg, m)[0]

        run = graphed.GraphedForward(eager, tag=(cfg.kernel_form(False, dev),)) if graph \
            else eager

        def fwd():
            return run(mix)

    torch.cuda.reset_peak_memory_stats(dev)
    with contextlib.nullcontext() if train else torch.inference_mode():
        for _ in range(3):
            fwd()
        torch.cuda.synchronize()
        graphed.reset_counts()
        host = []
        for _ in range(ITERS):
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fwd()
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / ITERS
        end.record()
        end.synchronize()
        event_ms = start.elapsed_time(end) / ITERS

        # Its records counted (tools/_bench.timed): one call's records,
        # times ITERS, or the profile is taken again.
        prof = timed(fwd, iters=ITERS, warm=0, cpu=True, label="profile_forward")
    by_name = {}
    for key, (n, us) in (prof.records or {}).items():
        if us > 0:
            by_name[key] = {"device_ms_per_call": us / 1e3 / ITERS,
                            "launches_per_call": n / ITERS}
    calls = graphed.counts()
    busy_ms = prof.ms
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1]["device_ms_per_call"]))
    return {
        "device": torch.cuda.get_device_name(dev),
        "work": "train_step" if train else "forward",
        "batch": batch, "seconds": SECONDS, "use_kernels": use_kernels,
        "compute_dtype": cfg.compute_dtype, "iters": ITERS,
        "graph": graph, "replays": calls["replays"],
        "eager_calls": calls["eager_calls"],
        **(graphed.graph_row(run.graphed if train else run) if graph else {}),
        "host_ms_median": float(np.median(host)), "event_ms": event_ms,
        # device memory at its peak over the warm-up (a graph's capture too)
        # and the timed calls
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        # host time to enqueue one call back to back, no synchronisation: the
        # host's share; where it exceeds device busy, the host sets event_ms
        "enqueue_ms_per_call": enqueue_ms,
        "device_busy_ms_per_call": busy_ms,
        # CUDA event time, and no by_kernel, when no profile was complete
        "profiler_blind": prof.blind, "profile_retries": prof.why,
        # Against the unprofiled CUDA-event time: the profiler slows the
        # host, not the kernels.
        "device_idle_share": max(0.0, 1.0 - busy_ms / event_ms),
        "by_kernel": top,
    }


def main(argv=None):
    p = argparse.ArgumentParser("Profile one separation forward or train step on the GPU")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--use_kernels", default="auto", choices=USE_KERNELS_CHOICES)
    p.add_argument("--train", action="store_true", help="profile one train step")
    p.add_argument("--graph", type=int, default=1, choices=(0, 1),
                   help="1: profile replays of the forward's or the step's CUDA graph; 0: "
                        "the eager forward or step")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    res = profile(args.batch, args.use_kernels, args.train, bool(args.graph))
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
