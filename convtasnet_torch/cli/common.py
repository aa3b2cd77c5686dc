"""Shared CLI helpers: the kernel-path and device flags."""

from __future__ import annotations

import argparse

from ..config import USE_KERNELS_CHOICES


def add_use_kernels_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--use_kernels", default="auto", type=str.lower,
        choices=USE_KERNELS_CHOICES,
        help="TCN chain path. Inference: auto, hybrid and whole run the "
             "whole-TCN form (the Hopper kernels with norm2 folded into out_w; "
             "auto is the default), block the whole-block form (norm2 "
             "unfolded), 0 the eager op-by-op chain. Training: auto, block and "
             "0 differentiate the eager chain, hybrid runs the whole-TCN "
             "training op (residual-saving forward, backward kernels), whole "
             "the per-block recompute op. BN models always run the eager "
             "chain; on the CPU every kernel takes its plain PyTorch version")


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device to run on (default cuda; the run fails "
                        "rather than fall back when no GPU is present)")


# Type of each JAX CLI flag that waits for a later slice of the port.
_LATER_TYPES = {"remat": str, "scan_unroll": int, "dp": int, "tp": int, "cp": int,
                "multihost": int, "coordinator_address": str, "num_processes": int,
                "process_id": int, "visualize": int}


def add_later_flags(p: argparse.ArgumentParser, defaults: dict) -> None:
    """Parse the JAX CLI's flags that wait for a later slice of the port
    (parallelism, multihost, remat, visualize), each with that CLI's
    default; check_later_flags raises on any other value."""
    for flag, default in defaults.items():
        p.add_argument(f"--{flag}", default=default, type=_LATER_TYPES[flag],
                       help="not ported yet: only the default is accepted")


def check_later_flags(args: argparse.Namespace, defaults: dict) -> None:
    for flag, default in defaults.items():
        if getattr(args, flag) != default:
            raise SystemExit(f"--{flag} {getattr(args, flag)}: waits for a later slice of "
                             "the port (ROADMAP.md)")
