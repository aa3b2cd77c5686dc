"""Evaluate CLI: SI-SNRi (and optional SDRi) over a manifest directory.

Counterpart of convtasnet_tpu/cli/evaluate.py, which follows the
reference's evaluation loop (evaluate.py:35-87): full-utterance batches,
forward, the uPIT loss for the PIT-reordered estimates, per-utterance
SI-SNRi against the mixture baseline and SDRi against the duplicated
mixture anchor, then dataset averages. Runs on CUDA unless --device cpu is
given.

    python -m convtasnet_torch.cli.evaluate --model_path final.ckpt \\
        --data_dir data/json/tt --cal_sdr 1

One enqueue per batch runs the forward, cal_loss and, with the device
SDR backend, the batched BSS-Eval (ops/metrics_device.py, f64), then
copies the results to pinned host memory behind an event; the host works
out SI-SNRi (and host SDRi) of batch i while batch i + 1 runs.
--sdr_backend auto is the device backend on CUDA and the host one
(ops/metrics.py, f64 numpy) on the CPU; neither falls back to the other.

Parsed but not ported yet (a non-default value raises): --dp / --tp / --cp,
--multihost / --coordinator_address / --num_processes / --process_id.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, List, Optional

import torch

from ..data.dataset import AudioDataset, DataLoader
from ..models.conv_tasnet import forward, resolve_device
from ..ops.loss import cal_loss
from ..ops.metrics import sdr_improvement, si_snr_improvement
from ..ops.metrics_device import sdr_improvement_batch
from ..training.checkpoint import load_model
from .common import add_device_flag, add_later_flags, add_use_kernels_flag, check_later_flags

# Flags of the JAX CLI that wait for a later slice, with their defaults.
LATER_FLAGS = {"dp": 1, "tp": 1, "cp": 1, "multihost": 0, "coordinator_address": None,
               "num_processes": None, "process_id": None}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Evaluate separation performance")
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--data_dir", type=str, required=True,
                   help="directory including mix.json, s1.json, s2.json")
    p.add_argument("--cal_sdr", type=int, default=0,
                   help="also compute SDRi (BSS-Eval v3)")
    p.add_argument("--sdr_backend", default="auto", choices=["auto", "host", "device"],
                   help="where BSS-Eval runs: 'device' = batched torch in f64 on "
                        "--device, in the forward's enqueue (ops/metrics_device.py); "
                        "'host' = the f64 numpy implementation (ops/metrics.py); "
                        "'auto' = device on CUDA, host on the CPU")
    p.add_argument("--sample_rate", default=8000, type=int)
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--cv_maxlen", default=1e9, type=float)
    add_use_kernels_flag(p)
    add_device_flag(p)
    p.add_argument("--pad_to_multiple", default=1, type=int,
                   help="pad utterances to a sample multiple to bound the number of "
                        "distinct shapes (lengths stay exact; only gLN statistics see "
                        "the padding, as with batch-max padding)")
    add_later_flags(p, LATER_FLAGS)
    return p


def evaluate(args, log: Callable[[str], None] = print,
             utterances: Optional[List[dict]] = None) -> dict:
    """Run the evaluation; returns {"si_snri", "count"[, "sdri"]}. When
    `utterances` is a list, each utterance's trimmed "mixture", "source",
    reordered "estimate", "si_snri" (and "sdri") are appended to it."""
    check_later_flags(args, LATER_FLAGS)
    device = resolve_device(args.device)
    cfg, params, state = load_model(args.model_path, device)
    # The kernel path is a run-time choice, not a model property.
    cfg = dataclasses.replace(cfg, use_kernels=args.use_kernels)
    use_device_sdr = bool(args.cal_sdr) and (
        args.sdr_backend == "device"
        or (args.sdr_backend == "auto" and device.type == "cuda"))

    dataset = AudioDataset(args.data_dir, args.batch_size, sample_rate=args.sample_rate,
                           segment=-1, cv_maxlen=args.cv_maxlen, num_speakers=cfg.C,
                           pad_to_multiple=args.pad_to_multiple)
    loader = DataLoader(dataset, num_workers=2)

    @torch.inference_mode()
    def infer(batch):
        """Enqueue one batch; returns (host tensors, event to wait on)."""
        mix, src, lens = (torch.from_numpy(a).to(device, non_blocking=True)
                          for a in (batch.mixture, batch.source, batch.lengths))
        est, _ = forward(params, state, cfg, mix, train=False)
        _, _, _, reordered = cal_loss(src, est, lens)
        outs = [reordered]
        if use_device_sdr:
            outs.append(sdr_improvement_batch(src, reordered, mix, lens))
        if device.type != "cuda":
            return outs, None
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs]
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def batches_with_async_infer():
        # One-deep pipeline: batch i + 1 is enqueued before batch i's
        # results are waited for. The copies to the host are ordered
        # before the next batch on the stream, so waiting on their event
        # does not wait for that batch.
        pending = None
        for batch in loader:
            fut = infer(batch)
            if pending is not None:
                yield _ready(pending)
            pending = (batch, fut)
        if pending is not None:
            yield _ready(pending)

    total_sisnri = total_sdri = 0.0
    count = 0
    for batch, outs in batches_with_async_infer():
        reordered = outs[0]
        for b in range(batch.mixture.shape[0]):
            n = int(batch.lengths[b])
            mix = batch.mixture[b, :n]
            src = batch.source[b, :, :n]
            est = reordered[b, :, :n]
            count += 1
            log(f"Utt {count}")
            utt = {"mixture": mix, "source": src, "estimate": est}
            if args.cal_sdr:
                sdri = float(outs[1][b]) if use_device_sdr else sdr_improvement(src, est, mix)
                total_sdri += sdri
                utt["sdri"] = sdri
                log(f"\tSDRi={sdri:.2f}")
            sisnri = si_snr_improvement(src, est, mix)
            log(f"\tSI-SNRi={sisnri:.2f}")
            total_sisnri += sisnri
            utt["si_snri"] = sisnri
            if utterances is not None:
                utterances.append(utt)

    result = {"si_snri": total_sisnri / max(count, 1), "count": count}
    if args.cal_sdr:
        result["sdri"] = total_sdri / max(count, 1)
        log(f"Average SDR improvement: {result['sdri']:.2f}")
    log(f"Average SISNR improvement: {result['si_snri']:.2f}")
    return result


def _ready(pending):
    batch, (host, done) = pending
    if done is not None:
        done.synchronize()
    return batch, [h.numpy() for h in host]


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(args)
    return evaluate(args)


if __name__ == "__main__":
    main()
