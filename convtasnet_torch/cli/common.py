"""Shared CLI helpers: the kernel-path, device and parallelism flags."""

from __future__ import annotations

import argparse
import dataclasses
import warnings
from typing import Optional, Tuple

import torch

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


def add_parallel_flags(p: argparse.ArgumentParser, dp_default: int) -> None:
    """The JAX CLIs' mesh and multihost flags. The port runs one process
    per card: launch dp*tp*cp processes with torchrun, or pass the
    JAX-style rendezvous (--multihost 1 --coordinator_address host:port
    --num_processes N --process_id i, or their environment variables)."""
    p.add_argument("--dp", default=dp_default, type=int,
                   help="data-parallel size (0 = world / (tp * cp))")
    p.add_argument("--tp", default=1, type=int, help="tensor-parallel size")
    p.add_argument("--cp", default=1, type=int,
                   help="context-parallel size: cut the frame axis over the ranks "
                        "(gLN / cLN only)")
    p.add_argument("--multihost", default=0, type=int,
                   help="join the process group from --coordinator_address / "
                        "--num_processes / --process_id (or COORDINATOR_ADDRESS / "
                        "NUM_PROCESSES / PROCESS_ID); torchrun's variables are read "
                        "without it")
    p.add_argument("--coordinator_address", default=None, type=str,
                   help="host:port of rank 0 (or an init_method URL such as file://...)")
    p.add_argument("--num_processes", default=None, type=int)
    p.add_argument("--process_id", default=None, type=int)


def setup_parallel(args: argparse.Namespace, dp: Optional[int] = None
                   ) -> Tuple[torch.device, object, bool]:
    """(device, mesh or None, whether this call initialised the process
    group). A run joins a process group when --multihost or
    --coordinator_address is given or a launcher set the environment;
    parallel flags without one raise (one process per card)."""
    from ..models.conv_tasnet import resolve_device
    from ..parallel import distributed
    from ..parallel.mesh import make_mesh, mesh_shape

    dp = args.dp if dp is None else dp
    multihost = bool(args.multihost) or args.coordinator_address is not None
    if not (multihost or distributed.launched()):
        mesh_shape(dp, args.tp, args.cp, 1)  # raises with the torchrun line
        return resolve_device(args.device), None, False
    device = distributed.initialize(args.coordinator_address, args.num_processes,
                                    args.process_id, device_type=torch.device(args.device).type)
    return device, make_mesh(dp, args.tp, args.cp, device), True


def resolve_mesh_kernels(cfg, tp: int, cp: int):
    """The kernels under TP or CP: the eager chain, with a warning (the
    counterpart of convtasnet_tpu/cli/common.py resolve_mesh_pallas). The
    kernels hold whole weights and the whole frame axis of a row; under DP
    each rank runs them on its own rows."""
    if (tp > 1 or cp > 1) and str(cfg.use_kernels).lower() not in ("0", "false"):
        which = "--tp" if tp > 1 else "--cp"
        warnings.warn(f"--use_kernels does not compose with {which} (the kernels hold whole "
                      "weights and a row's whole frame axis); running the eager chain",
                      stacklevel=2)
        return dataclasses.replace(cfg, use_kernels="0")
    return cfg

