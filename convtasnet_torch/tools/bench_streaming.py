"""Latency of the streaming chunk step (models/streaming.py) per chunk.

    python -m convtasnet_torch.tools.bench_streaming [--chunks_ms 10 20 40] \\
        [--batch 1 16] [--graph 1] [--device cuda] [--steps 100] [--tiny]

Seeded weights at the causal paper config (N=256, L=20, B=256, H=512,
P=3, X=8, R=4, C=2, cLN, causal, relu, bf16; --tiny: a small f32 config).
For each (chunk, batch) point a StreamingSeparator is made (CUDA graphs on
a card with --graph 1, the eager step with --graph 0), its first SETUP
pushes (the first-chunk and steady steps' eager first calls, and the
steady step's capture: models/graphed's rule) are timed as `setup_ms`,
then after warm-up `steps` chunks are pushed from the host,
each fetched back to the host before the next, as a live consumer sees
them. One JSON row per point: the median `latency_ms` per chunk, `rtf`
(latency / chunk duration; < 1 is real time), `streams_per_card_rt`
(batch if rtf < 1, else 0: sweep --batch to find the card's capacity),
and on a card the device busy ms and device operations per chunk from
torch.profiler over 10 chunks. Rows name their device: a CPU row times
the CPU.
"""

from __future__ import annotations

import argparse
import itertools
import json
import time

import numpy as np
import torch

from ..config import ConvTasNetConfig
from ..models.conv_tasnet import init_params, resolve_device
from ..models.streaming import StreamingSeparator
from ._bench import timed

CAUSAL_PAPER = dict(N=256, L=20, B=256, H=512, P=3, X=8, R=4, C=2, norm_type="cLN",
                    causal=True)
TINY = dict(N=32, L=16, B=32, H=64, P=3, X=3, R=2, C=2, norm_type="cLN", causal=True,
            compute_dtype="float32")
SETUP = 3       # pushes until the steady step replays
WARM = 3        # steady chunks pushed after the set-up pushes, untimed
PROFILED = 10   # chunks under torch.profiler for device busy and operations


def host_chunks(batch: int, chunk_len: int, n: int, seed: int = 0):
    """n contiguous host chunks [batch, chunk_len] of seeded noise."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((batch, chunk_len)).astype(np.float32))
            for _ in range(n)]


def chunk_ms(sep: StreamingSeparator, chunks) -> list:
    """Wall ms of each push, its output fetched to the host inside the timing."""
    times = []
    for c in chunks:
        t0 = time.perf_counter()
        sep.push(c).cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def profile_chunks(sep: StreamingSeparator, chunks):
    """(device busy ms, device operations) per chunk from torch.profiler
    over pushes with a fetch each, its records counted (tools/_bench.timed);
    (None, None) when no profile was complete. Busy is the records' device
    time summed: the stream block kernels launch as programmatic dependents,
    each started while the one before runs, so their waits count and busy
    reads above the chunk's span of device time where they run."""
    it = itertools.cycle(chunks)
    n = len(chunks)
    prof = timed(lambda: sep.push(next(it)).cpu(), iters=n, warm=0,
                 label="bench_streaming.profile_chunks")
    if prof.blind:
        return None, None
    return prof.ms, sum(c for c, _ in prof.records.values()) / n


def measure(cfg: ConvTasNetConfig, params, batch: int, chunk_len: int, sample_rate: int,
            steps: int, graph: bool, device) -> dict:
    """One point of the sweep (see the module docstring)."""
    dev = torch.device(device)
    sep = StreamingSeparator(cfg, params, batch=batch, device=dev, graph=graph)
    on_card = dev.type == "cuda"
    chunks = host_chunks(batch, chunk_len, SETUP + WARM + steps + (PROFILED if on_card else 0))
    setup = chunk_ms(sep, chunks[:SETUP])
    chunk_ms(sep, chunks[SETUP:SETUP + WARM])
    times = chunk_ms(sep, chunks[SETUP + WARM:SETUP + WARM + steps])
    busy, ops = profile_chunks(sep, chunks[SETUP + WARM + steps:]) if on_card else (None, None)
    lat = float(np.median(times))
    rtf = lat / (1e3 * chunk_len / sample_rate)
    return {"chunk_ms": 1e3 * chunk_len / sample_rate, "batch": batch,
            "graph": sep.graphed, "latency_ms": lat,
            "latency_p90_ms": float(np.percentile(times, 90)), "rtf": rtf,
            "streams_per_card_rt": batch if rtf < 1.0 else 0,
            "setup_ms": sum(setup), "device_busy_ms": busy, "ops_per_chunk": ops,
            "steps": steps,
            "device": torch.cuda.get_device_name(dev) if on_card else "cpu"}


def main(argv=None):
    p = argparse.ArgumentParser("Per-chunk latency of the streaming step")
    p.add_argument("--chunks_ms", type=float, nargs="+", default=[10, 20, 40])
    p.add_argument("--batch", type=int, nargs="+", default=[1])
    p.add_argument("--sample_rate", type=int, default=8000)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--graph", type=int, default=1, choices=(0, 1),
                   help="1: CUDA graphs of the chunk step on a card; 0: the eager step")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device (default cuda; fails without a GPU unless cpu)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ConvTasNetConfig(**(TINY if args.tiny else CAUSAL_PAPER))
    params, _ = init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    rows = []
    for ms in args.chunks_ms:
        chunk_len = int(args.sample_rate * ms / 1000)
        chunk_len -= chunk_len % cfg.stride
        if chunk_len < cfg.L:
            continue
        for batch in args.batch:
            row = measure(cfg, params, batch, chunk_len, args.sample_rate, args.steps,
                          bool(args.graph), dev)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
