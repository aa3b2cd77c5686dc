"""Train CLI: the flags of convtasnet_tpu/cli/train.py (the reference's
train.py:15-98), with --use_kernels in place of --use_pallas and --device.

    python -m convtasnet_torch.cli.train --train_dir data/json/tr \\
        --valid_dir data/json/cv --batch_size 5 --use_kernels hybrid

--use_kernels picks the TCN chain of training (config.py): 0 / auto / block
train the eager chain under autograd, hybrid the whole-TCN training op
(backward kernels of csrc/tcn_block_bwd.cu), whole the per-block
recompute op; the CV forward runs the inference kernels under any of them
but 0. Runs on CUDA unless --device cpu is given.

Parsed but not ported yet (a non-default value raises): --remat,
--scan_unroll, --dp / --tp / --cp, --multihost / --coordinator_address /
--num_processes / --process_id, --visualize.
"""

from __future__ import annotations

import argparse

import torch

from ..config import ConvTasNetConfig, TrainConfig
from ..data.dataset import AudioDataset, DataLoader
from ..models.conv_tasnet import ConvTasNet, resolve_device
from ..training.solver import Solver
from .common import add_device_flag, add_later_flags, add_use_kernels_flag, check_later_flags

# Flags of the JAX CLI that wait for a later slice, with their defaults.
LATER_FLAGS = {"remat": "0", "scan_unroll": 1, "dp": 0, "tp": 1, "cp": 1,
               "multihost": 0, "coordinator_address": None, "num_processes": None,
               "process_id": None, "visualize": 0}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Conv-TasNet with Permutation Invariant Training (PyTorch)")
    # Task
    p.add_argument("--train_dir", type=str, required=True)
    p.add_argument("--valid_dir", type=str, required=True)
    p.add_argument("--sample_rate", default=8000, type=int)
    p.add_argument("--segment", default=4.0, type=float)
    p.add_argument("--cv_maxlen", default=8.0, type=float)
    p.add_argument("--cv_batch_size", default=0, type=int,
                   help="utterances per CV batch; 0 = 1, like the reference")
    # Network
    p.add_argument("--N", default=256, type=int)
    p.add_argument("--L", default=20, type=int)
    p.add_argument("--B", default=256, type=int)
    p.add_argument("--H", default=512, type=int)
    p.add_argument("--P", default=3, type=int)
    p.add_argument("--X", default=8, type=int)
    p.add_argument("--R", default=4, type=int)
    p.add_argument("--C", default=2, type=int)
    p.add_argument("--norm_type", default="gLN", choices=["gLN", "cLN", "BN"])
    p.add_argument("--causal", type=int, default=0)
    p.add_argument("--mask_nonlinear", default="relu", choices=["relu", "softmax"])
    # Training
    p.add_argument("--epochs", default=30, type=int)
    p.add_argument("--half_lr", default=0, type=int)
    p.add_argument("--early_stop", default=0, type=int)
    p.add_argument("--max_norm", default=5.0, type=float)
    # Minibatch
    p.add_argument("--shuffle", default=0, type=int)
    p.add_argument("--batch_size", default=128, type=int)
    p.add_argument("--num_workers", default=4, type=int)
    # Optimizer
    p.add_argument("--optimizer", default="adam", choices=["sgd", "adam"])
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--momentum", default=0.0, type=float)
    p.add_argument("--l2", default=0.0, type=float)
    # Save / load
    p.add_argument("--save_folder", default="exp/temp")
    p.add_argument("--checkpoint", default=0, type=int)
    p.add_argument("--continue_from", default="")
    p.add_argument("--save_every_steps", default=0, type=int,
                   help="preemption-safe latest.ckpt every N steps")
    p.add_argument("--model_path", default="final.ckpt")
    # Logging
    p.add_argument("--print_freq", default=10, type=int)
    p.add_argument("--seed", default=0, type=int)
    # Device and kernels
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    add_use_kernels_flag(p)
    add_device_flag(p)
    p.add_argument("--pad_to_multiple", default=1, type=int,
                   help="pad CV batches to a sample multiple")
    add_later_flags(p, LATER_FLAGS)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(args)
    check_later_flags(args, LATER_FLAGS)
    device = resolve_device(args.device)
    model_cfg = ConvTasNetConfig(
        N=args.N, L=args.L, B=args.B, H=args.H, P=args.P, X=args.X, R=args.R, C=args.C,
        norm_type=args.norm_type, causal=bool(args.causal),
        mask_nonlinear=args.mask_nonlinear, compute_dtype=args.compute_dtype,
        use_kernels=args.use_kernels)
    train_cfg = TrainConfig(
        epochs=args.epochs, half_lr=bool(args.half_lr), early_stop=bool(args.early_stop),
        max_norm=args.max_norm, batch_size=args.batch_size, optimizer=args.optimizer,
        lr=args.lr, momentum=args.momentum, l2=args.l2, sample_rate=args.sample_rate,
        segment=args.segment, cv_maxlen=args.cv_maxlen, shuffle=bool(args.shuffle),
        save_folder=args.save_folder, checkpoint=bool(args.checkpoint),
        continue_from=args.continue_from, save_every_steps=args.save_every_steps,
        model_path=args.model_path, print_freq=args.print_freq, seed=args.seed)

    tr_dataset = AudioDataset(args.train_dir, args.batch_size, sample_rate=args.sample_rate,
                              segment=args.segment, num_speakers=args.C)
    cv_dataset = AudioDataset(args.valid_dir, batch_size=max(1, args.cv_batch_size),
                              sample_rate=args.sample_rate, segment=-1,
                              cv_maxlen=args.cv_maxlen, num_speakers=args.C,
                              pad_to_multiple=args.pad_to_multiple)
    tr_loader = DataLoader(tr_dataset, shuffle=bool(args.shuffle),
                           num_workers=args.num_workers, seed=args.seed)
    cv_loader = DataLoader(cv_dataset, num_workers=max(1, args.num_workers // 2))

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = ConvTasNet(model_cfg, device=device, generator=gen)
    return Solver(model, train_cfg, tr_loader, cv_loader).train()


if __name__ == "__main__":
    main()
