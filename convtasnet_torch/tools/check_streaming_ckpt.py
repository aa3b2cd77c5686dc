"""Streamed against offline separation on a checkpoint.

    python -m convtasnet_torch.tools.check_streaming_ckpt --model_path <ckpt> \\
        --mix_json <tt/mix.json> [--chunk_ms 20] [--n 2] [--device cuda]

Counterpart of root tools/check_streaming_ckpt.py. Streams the first --n
mixtures of a manifest, one at a time, through the stateful chunked
separator (CUDA graphs on a card) and compares each with the offline
forward (the checkpoint's dispatch: the kernels on a card) on the same
chunk-padded signal. Prints one JSON line with the largest
|streamed - offline| over the mixtures, absolute and relative to the
mixture's largest offline sample. --compute_dtype float32 separates the
two paths' accumulation-order drift in bf16 from a streaming-state bug.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..cli.stream import chunk_samples
from ..data.wavio import read_wav
from ..models.conv_tasnet import forward, resolve_device
from ..models.streaming import StreamingSeparator
from ..training.checkpoint import load_model


def main(argv=None):
    ap = argparse.ArgumentParser("Streamed vs offline separation on a checkpoint")
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--mix_json", required=True)
    ap.add_argument("--chunk_ms", type=float, default=20.0)
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--compute_dtype", default=None,
                    help="override the checkpoint's compute dtype (e.g. float32)")
    ap.add_argument("--device", default="cuda", type=str,
                    help="torch device (default cuda; fails without a GPU unless cpu)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, params, state = load_model(args.model_path, device)
    if args.compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
    with open(args.mix_json) as f:
        entries = json.load(f)[: args.n]

    # chunk_ms -> samples at the wavs' own rate; all entries must share it.
    _, sr0 = read_wav(entries[0][0])
    chunk_len = chunk_samples(args.chunk_ms, sr0, cfg.L, cfg.stride)
    sep = StreamingSeparator(cfg, params, batch=1, device=device)
    worst_abs = worst_rel = 0.0
    for path, _ in entries:
        y, sr = read_wav(path)
        if sr != sr0:
            raise SystemExit(f"mixed sample rates in {args.mix_json}: {sr} vs {sr0}")
        T = len(y)
        n_chunks = max(-(-T // chunk_len), 1)
        padded = np.zeros((1, n_chunks * chunk_len), np.float32)
        padded[0, :T] = y
        sep.reset()
        outs = [sep.push(torch.from_numpy(padded[:, k * chunk_len:(k + 1) * chunk_len]))
                for k in range(n_chunks)]
        outs.append(sep.flush())
        streamed = torch.cat(outs, dim=-1)[0].cpu().numpy()
        with torch.no_grad():
            offline, _ = forward(params, state, cfg, torch.from_numpy(padded).to(device))
        off = offline[0].cpu().numpy()[:, : streamed.shape[1]]
        err = float(np.max(np.abs(streamed - off)))
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / (float(np.max(np.abs(off))) + 1e-9))
    row = {"metric": "streamed_vs_offline_max_rel_err", "value": worst_rel,
           "max_abs_err": worst_abs, "chunk_ms": args.chunk_ms, "sample_rate": sr0,
           "n": len(entries), "compute_dtype": cfg.compute_dtype,
           "model_path": args.model_path, "device": str(device)}
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
