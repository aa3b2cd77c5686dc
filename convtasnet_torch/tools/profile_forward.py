"""Where the time of one separation forward goes, on one CUDA device.

    python -m convtasnet_torch.tools.profile_forward --batch 8 --use_kernels auto

Seeded paper-config weights, random mixtures of 4 s at 8 kHz. Prints one
JSON line: the host-clock forward time (synchronised), the CUDA-event time,
the device time by kernel from torch.profiler over 10 forwards, and the
device's idle share: 1 - (device time per forward) / (CUDA-event time per
forward). With --out the same JSON is also written to a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..config import ConvTasNetConfig
from ..models.conv_tasnet import forward, init_params, resolve_device


SECONDS, ITERS = 4.0, 10


def profile(batch: int, use_kernels: str) -> dict:
    dev = resolve_device("cuda")
    cfg = dataclasses.replace(ConvTasNetConfig(), use_kernels=use_kernels)
    params, state = init_params(torch.Generator(device=dev).manual_seed(1234),
                                cfg, device=dev)
    mix = torch.from_numpy(np.random.default_rng(0).normal(
        size=(batch, int(SECONDS * 8000))).astype(np.float32)).to(dev)

    def fwd():
        return forward(params, state, cfg, mix)[0]

    with torch.inference_mode():
        for _ in range(3):
            fwd()
        torch.cuda.synchronize()
        host = []
        for _ in range(ITERS):
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(ITERS):
            fwd()
        end.record()
        end.synchronize()
        event_ms = start.elapsed_time(end) / ITERS

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                fwd()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for evt in prof.key_averages():
        # Kernels (and copies) only: an operator's CPU entry, and its range
        # projected onto the device timeline (a user annotation such as
        # "aten::mm"), repeat the time of the kernels it launched.
        us = float(evt.self_device_time_total)
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not evt.is_user_annotation and us > 0):
            by_name[evt.key] = {"device_ms_per_forward": us / 1e3 / ITERS,
                                "calls_per_forward": evt.count / ITERS}
    busy_ms = sum(v["device_ms_per_forward"] for v in by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1]["device_ms_per_forward"]))
    return {
        "device": torch.cuda.get_device_name(dev),
        "batch": batch, "seconds": SECONDS, "use_kernels": use_kernels,
        "compute_dtype": cfg.compute_dtype, "iters": ITERS,
        "host_ms_median": float(np.median(host)), "event_ms": event_ms,
        "profiled_window_ms_per_forward": window_ms / ITERS,
        "device_busy_ms_per_forward": busy_ms,
        # Against the unprofiled CUDA-event time: the profiler slows the
        # host, not the kernels.
        "device_idle_share": max(0.0, 1.0 - busy_ms / event_ms),
        "by_kernel": top,
    }


def main(argv=None):
    p = argparse.ArgumentParser("Profile one separation forward on the GPU")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--use_kernels", default="auto", choices=("auto", "block", "0"))
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    res = profile(args.batch, args.use_kernels)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
