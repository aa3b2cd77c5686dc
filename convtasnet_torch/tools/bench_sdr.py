"""BSS-Eval SDRi per utterance: the host's f64 numpy path against the
batched torch path on the device.

    python -m convtasnet_torch.tools.bench_sdr [--utts 40] [--batch 8] [--sec 4.0] \\
        [--host_utts 8] [--device cuda]

The host path is ops/metrics.sdr_improvement (f64 numpy, one utterance at
a time, timed over --host_utts utterances); the device path is
ops/metrics_device.sdr_improvement_batch (f64) over all --utts, once one
utterance at a time (batch 1) and once --batch at a time, after a warm-up
pass each. Device times end with the SDRi values on the host. Inputs are
data/synthetic mixtures of 2 sources with estimates = sources + 0.1 noise
(seed 0). Prints one JSON line: seconds per utterance of each path, the
speedups over the host, and the largest |device - host| SDRi in dB.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..data.synthetic import synthetic_batch
from ..models.conv_tasnet import resolve_device
from ..ops.metrics import sdr_improvement
from ..ops.metrics_device import sdr_improvement_batch
from ._bench import device_name


def device_pass(src, est, mix, lens, batch: int) -> tuple:
    """(SDRi of every utterance on the host, seconds) of one device pass."""
    if src.is_cuda:
        torch.cuda.synchronize(src.device)
    t0 = time.perf_counter()
    out = [sdr_improvement_batch(src[lo:lo + batch], est[lo:lo + batch], mix[lo:lo + batch],
                                 lens[lo:lo + batch], filt_len=512)
           for lo in range(0, src.shape[0], batch)]
    vals = torch.cat(out).cpu().numpy()
    return vals, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser("Host vs device BSS-Eval SDRi")
    ap.add_argument("--utts", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--sec", type=float, default=4.0)
    ap.add_argument("--sr", type=int, default=8000)
    ap.add_argument("--host_utts", type=int, default=8,
                    help="utterances the host path is timed over (it is slow)")
    ap.add_argument("--device", default="cuda", type=str,
                    help="torch device (default cuda; fails without a GPU unless cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    T = int(args.sec * args.sr)
    rng = np.random.default_rng(0)
    mix, lens, src = synthetic_batch(rng, args.utts, 2, T, args.sr)
    est = (src + 0.1 * rng.standard_normal(src.shape)).astype(np.float32)

    t0 = time.perf_counter()
    host = [sdr_improvement(src[i], est[i], mix[i], filt_len=512)
            for i in range(args.host_utts)]
    host_s = (time.perf_counter() - t0) / args.host_utts

    src_d, est_d, mix_d, lens_d = (torch.from_numpy(a).to(dev) for a in (src, est, mix, lens))
    dev_s = {}
    for b in (1, args.batch):
        device_pass(src_d, est_d, mix_d, lens_d, b)  # warm-up
        vals, secs = device_pass(src_d, est_d, mix_d, lens_d, b)
        dev_s[b] = secs / args.utts
    row = {"metric": "bss_eval_sdri_throughput", "device": device_name(dev),
           "utt_sec": args.sec, "host_s_per_utt": host_s,
           "device_s_per_utt_batch1": dev_s[1], "device_s_per_utt": dev_s[args.batch],
           "speedup_batch1": host_s / dev_s[1], "speedup": host_s / dev_s[args.batch],
           "max_abs_sdri_diff_db": float(np.max(np.abs(vals[:args.host_utts] - np.array(host)))),
           "utts": args.utts, "batch": args.batch}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
