"""Shared CLI helpers: the kernel-path and device flags."""

from __future__ import annotations

import argparse

from ..config import USE_KERNELS_CHOICES


def add_use_kernels_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--use_kernels", default="auto", type=str.lower,
        choices=USE_KERNELS_CHOICES,
        help="TCN chain path: auto (whole-TCN form: the Hopper kernels with "
             "norm2 folded into out_w; default), block (whole-block form: "
             "the same kernels, norm2 unfolded), 0 (eager op-by-op chain). "
             "BN models always run the eager chain; on the CPU every kernel "
             "takes its plain PyTorch version")


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device to run on (default cuda; the run fails "
                        "rather than fall back when no GPU is present)")

