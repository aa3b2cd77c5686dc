"""Separate CLI: run inference on mixture wavs and write per-speaker wavs.

Counterpart of convtasnet_tpu/cli/separate.py (the reference's
separate.py:35-79): loads a checkpoint, builds an EvalDataset from
--mix_dir or --mix_json, forwards each padded batch, trims the padding and
writes `<base>.wav` (the mixture) plus `<base>_s{c}.wav` per speaker as
PCM_16. Runs on CUDA unless --device cpu is given.

Parsed but not ported yet (a non-default value raises): --dp / --tp / --cp,
--multihost / --coordinator_address / --num_processes / --process_id.

    python -m convtasnet_torch.cli.separate --model_path final.ckpt \\
        --mix_dir mixtures/ --out_dir out/ --batch_size 8
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from ..data.dataset import DataLoader, EvalDataset
from ..data.wavio import write_wav
from ..models.conv_tasnet import forward, resolve_device
from ..training.checkpoint import load_model
from .common import add_device_flag, add_later_flags, add_use_kernels_flag, check_later_flags

# Flags of the JAX CLI that wait for a later slice, with their defaults.
LATER_FLAGS = {"dp": 1, "tp": 1, "cp": 1, "multihost": 0, "coordinator_address": None,
               "num_processes": None, "process_id": None}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Separate speech with a trained model")
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--mix_dir", type=str, default=None)
    p.add_argument("--mix_json", type=str, default=None)
    p.add_argument("--out_dir", type=str, default="exp/result")
    p.add_argument("--sample_rate", default=8000, type=int)
    p.add_argument("--batch_size", default=1, type=int)
    add_use_kernels_flag(p)
    add_device_flag(p)
    p.add_argument("--pad_to_multiple", default=1, type=int,
                   help="pad mixtures to a sample multiple to bound the "
                        "number of distinct shapes")
    add_later_flags(p, LATER_FLAGS)
    return p


def separate(args) -> int:
    check_later_flags(args, LATER_FLAGS)
    if args.mix_dir is None and args.mix_json is None:
        raise SystemExit("Must provide mix_dir or mix_json! When providing "
                         "mix_dir, mix_json is ignored.")
    device = resolve_device(args.device)
    cfg, params, state = load_model(args.model_path, device)
    # The kernel path is a run-time choice, not a model property.
    cfg = dataclasses.replace(cfg, use_kernels=args.use_kernels)

    dataset = EvalDataset(args.mix_dir, args.mix_json,
                          batch_size=args.batch_size,
                          sample_rate=args.sample_rate,
                          pad_to_multiple=args.pad_to_multiple)
    loader = DataLoader(dataset, num_workers=2)
    os.makedirs(args.out_dir, exist_ok=True)

    @torch.inference_mode()
    def infer(mixture: np.ndarray):
        """Enqueue one forward; returns (host tensor, event to wait on)."""
        mix = torch.from_numpy(mixture).to(device, non_blocking=True)
        est, _ = forward(params, state, cfg, mix, train=False)
        if device.type != "cuda":
            return est, None
        host = torch.empty(est.shape, dtype=est.dtype, pin_memory=True)
        host.copy_(est, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def batches_with_async_infer():
        # One-deep pipeline: the next batch's forward is enqueued on the
        # card before this batch's result is waited for, so it runs while
        # the host encodes and writes this batch's wavs. The copy to host
        # is ordered before the next forward on the stream, so waiting on
        # its event does not wait for that forward.
        pending = None
        for batch in loader:
            fut = infer(batch.mixture)
            if pending is not None:
                yield _ready(pending)
            pending = (batch, fut)
        if pending is not None:
            yield _ready(pending)

    written = 0
    for batch, est in batches_with_async_infer():  # est: [B, C, T]
        for b, filename in enumerate(batch.filenames):
            n = int(batch.lengths[b])
            base = os.path.basename(filename)
            if base.endswith(".wav"):
                base = base[:-4]
            out_base = os.path.join(args.out_dir, base)
            write_wav(out_base + ".wav", batch.mixture[b, :n], args.sample_rate)
            for c in range(cfg.C):
                write_wav(f"{out_base}_s{c + 1}.wav", est[b, c, :n], args.sample_rate)
            written += 1
    return written


def _ready(pending):
    batch, (host, done) = pending
    if done is not None:
        done.synchronize()
    return batch, host.numpy()


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(args)
    return separate(args)


if __name__ == "__main__":
    main()
