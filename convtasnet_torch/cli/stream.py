"""Stream CLI: chunked real-time-style separation with a causal model.

Counterpart of convtasnet_tpu/cli/stream.py. The mixture is fed in
fixed-duration chunks through a stateful chunk step (carried frame tail,
per-block dilation rings, overlap-add tail; models/streaming.py), run
through the graph layer's CUDA graphs on the card (models/graphed.py),
and the concatenated chunk outputs reproduce the offline forward. Files
are grouped `--batch` at a time into concurrent streams, zero-padded to
the group's chunk count.

Writes `<base>.wav` and `<base>_s{c}.wav` per speaker like the separate
CLI, and reports the wall-clock real-time factor (RTF): each chunk's
output is fetched to the host before the next is pushed, so the measured
time is what a live consumer would see. Runs on CUDA unless --device cpu
is given.

    python -m convtasnet_torch.cli.stream --model_path causal.ckpt \\
        --mix_dir mixtures/ --out_dir out/ --chunk_ms 20 --batch 4
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.wavio import read_wav, write_wav
from ..models import graphed
from ..models.conv_tasnet import resolve_device
from ..models.streaming import StreamingSeparator
from ..training.checkpoint import load_model
from .common import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "Streaming (chunked) separation with a causal Conv-TasNet")
    p.add_argument("--model_path", type=str, required=True,
                   help="checkpoint of a causal cLN model")
    p.add_argument("--mix_dir", type=str, default=None,
                   help="directory of mixture wavs")
    p.add_argument("--wav", type=str, action="append", default=[],
                   help="a mixture wav (repeatable); combined with mix_dir")
    p.add_argument("--out_dir", type=str, default="exp/result")
    p.add_argument("--sample_rate", default=8000, type=int)
    p.add_argument("--chunk_ms", default=20.0, type=float,
                   help="chunk duration = algorithmic latency; rounded up "
                        "to an encoder-stride multiple, with a floor of one "
                        "encoder frame (L samples) so a chunk can be framed")
    p.add_argument("--batch", default=1, type=int,
                   help="concurrent streams per chunk step (serving): files "
                        "are grouped and streamed together through one "
                        "stateful separator; each file's output is that of "
                        "its own stream over the group's padded length")
    add_device_flag(p)
    return p


def chunk_samples(chunk_ms: float, sample_rate: int, L: int, S: int) -> int:
    """Samples per chunk: chunk_ms at sample_rate, at least one encoder frame
    (L samples: the first chunk is framed with no carried tail), rounded up
    to a stride multiple (stream_step's requirement)."""
    n = max(int(round(chunk_ms / 1000.0 * sample_rate)), L)
    return -(-n // S) * S


def stream_files(args) -> int:
    paths = list(args.wav)
    if args.mix_dir:
        paths += sorted(
            os.path.join(args.mix_dir, f)
            for f in os.listdir(args.mix_dir) if f.endswith(".wav"))
    if not paths:
        raise SystemExit("Must provide --mix_dir and/or --wav")

    device = resolve_device(args.device)
    cfg, params, _state = load_model(args.model_path, device)
    if not cfg.causal or cfg.norm_type != "cLN":
        raise SystemExit(
            f"streaming requires a causal cLN model; this checkpoint is "
            f"causal={cfg.causal}, norm_type={cfg.norm_type} "
            f"(train with --causal 1 --norm_type cLN)")

    chunk_len = chunk_samples(args.chunk_ms, args.sample_rate, cfg.L, cfg.stride)
    os.makedirs(args.out_dir, exist_ok=True)

    B = max(1, args.batch)
    sep = StreamingSeparator(cfg, params, batch=B, device=device)
    written = 0
    for g in range(0, len(paths), B):
        group = paths[g: g + B]
        mixes = [read_wav(p, sample_rate=args.sample_rate)[0] for p in group]
        Ts = [m.shape[0] for m in mixes]
        n_chunks = max(max(-(-t // chunk_len), 1) for t in Ts)
        # One padded block for the whole group; a final group smaller than
        # B feeds zero rows (independent streams whose outputs are never
        # written).
        padded = np.zeros((B, n_chunks * chunk_len), np.float32)
        for b, m in enumerate(mixes):
            padded[b, : Ts[b]] = m

        # Fresh streams per group; the captured chunk steps are reused.
        sep.reset()

        outs = []
        before = graphed.counts()
        t0 = time.perf_counter()
        for k in range(n_chunks):
            out = sep.push(torch.from_numpy(padded[:, k * chunk_len:(k + 1) * chunk_len]))
            outs.append(out.cpu().numpy())  # real fetch: live-consumer timing
        outs.append(sep.flush().cpu().numpy())
        dt = time.perf_counter() - t0
        setup = {k: graphed.counts()[k] - before[k] for k in ("eager_calls", "captures")}

        ests = np.concatenate(outs, axis=-1)  # [B, C, >= max T]
        for b, path in enumerate(group):
            T = Ts[b]
            est = ests[b]
            if est.shape[-1] < T:
                est = np.pad(est, ((0, 0), (0, T - est.shape[-1])))
            base = os.path.basename(path)
            if base.endswith(".wav"):
                base = base[:-4]
            out_base = os.path.join(args.out_dir, base)
            write_wav(out_base + ".wav", mixes[b], args.sample_rate)
            for c in range(cfg.C):
                write_wav(f"{out_base}_s{c + 1}.wav", est[c, :T], args.sample_rate)
            written += 1

        audio_sec = max(Ts) / args.sample_rate
        names = os.path.basename(group[0]) + (
            f" (+{len(group) - 1})" if len(group) > 1 else "")
        print(f"{names}: {len(group)} stream(s), {audio_sec:.2f} s in "
              f"{dt:.3f} s wall | "
              f"chunk {1000 * chunk_len / args.sample_rate:.1f} ms | "
              f"{1000 * dt / n_chunks:.2f} ms/chunk | RTF {dt / audio_sec:.3f}"
              + (f" (includes {setup['eager_calls']} eager first call(s) and "
                 f"{setup['captures']} CUDA graph capture(s))"
                 if sep.graphed and any(setup.values()) else ""))
    return written


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(args)
    return stream_files(args)


if __name__ == "__main__":
    main()
