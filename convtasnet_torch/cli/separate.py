"""Separate CLI: run inference on mixture wavs and write per-speaker wavs.

Counterpart of convtasnet_tpu/cli/separate.py (the reference's
separate.py:35-79): loads a checkpoint, builds an EvalDataset from
--mix_dir or --mix_json, forwards each padded batch, trims the padding and
writes `<base>.wav` (the mixture) plus `<base>_s{c}.wav` per speaker as
PCM_16. Runs on CUDA unless --device cpu is given. On a card the forward
of each padded batch shape is captured once as a CUDA graph and replayed
(models/graphed.py; one card, or DP with tp = cp = 1), as the JAX CLI
jits it; --pad_to_multiple bounds the number of shapes.

Several cards (one process each, launched with torchrun or the
--multihost rendezvous flags; cli/common.py): with tp = cp = 1 every rank
takes a stride slice of the batch list, runs the single-card forward and
writes only its own wavs (the JAX CLI's multihost layout); with --tp or
--cp the ranks of a TP / CP group run the same batch together (the eager
chain) and the group's first rank writes.

    python -m convtasnet_torch.cli.separate --model_path final.ckpt \\
        --mix_dir mixtures/ --out_dir out/ --batch_size 8
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..data.dataset import DataLoader, EvalDataset
from ..data.manifest import preprocess_one_dir
from ..data.wavio import write_wav
from ..models.graphed import GraphedForward
from ..parallel.distributed import shutdown
from ..parallel.mesh import graphable, mesh_forward
from ..training.checkpoint import load_model
from .common import (add_device_flag, add_parallel_flags, add_use_kernels_flag,
                     resolve_mesh_kernels, setup_parallel)


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
    add_parallel_flags(p, dp_default=1)
    return p


def separate(args) -> int:
    """Separate every mixture; returns the number this rank wrote."""
    if args.mix_dir is None and args.mix_json is None:
        raise SystemExit("Must provide mix_dir or mix_json! When providing "
                         "mix_dir, mix_json is ignored.")
    dp = 0 if (args.dp, args.tp, args.cp) == (1, 1, 1) else args.dp
    device, mesh, joined = setup_parallel(args, dp)
    try:
        return _separate(args, device, mesh)
    finally:
        if joined:
            shutdown()


def _separate(args, device, mesh) -> int:
    cfg, params, state = load_model(args.model_path, device)
    # The kernel path is a run-time choice, not a model property.
    cfg = dataclasses.replace(cfg, use_kernels=args.use_kernels)
    mix_dir, mix_json = args.mix_dir, args.mix_json
    writes = True
    if mesh is not None:
        cfg = resolve_mesh_kernels(cfg, mesh.tp, mesh.cp)
        writes = mesh.model_rank == 0 and mesh.context_rank == 0
        if mix_dir is not None:
            # One rank writes the manifest; the others wait for it.
            if dist.get_rank() == 0:
                preprocess_one_dir(mix_dir, mix_dir, "mix", args.sample_rate)
            dist.barrier()
            mix_dir, mix_json = None, os.path.join(mix_dir, "mix.json")
    fwd = mesh_forward(cfg, params, state, mesh)
    if graphable(mesh):  # one CUDA graph per key; TP / CP stay eager
        fwd = GraphedForward(fwd, tag=(cfg.kernel_form(False, device),))

    dataset = EvalDataset(mix_dir, mix_json,
                          batch_size=args.batch_size,
                          sample_rate=args.sample_rate,
                          pad_to_multiple=args.pad_to_multiple)
    if mesh is not None:
        # Data ranks take disjoint batches (the manifest order is shared);
        # the ranks of a TP / CP group take the same ones.
        dataset.batches = dataset.batches[mesh.data_rank::mesh.dp]
    loader = DataLoader(dataset, num_workers=2)
    os.makedirs(args.out_dir, exist_ok=True)

    @torch.inference_mode()
    def infer(mixture: np.ndarray):
        """Enqueue one forward; returns (host tensor, event to wait on)."""
        mix = torch.from_numpy(mixture).to(device, non_blocking=True)
        est = fwd(mix)
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
        for b, filename in enumerate(batch.filenames if writes else ()):
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
