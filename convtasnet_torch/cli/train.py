"""Train CLI: the flags of convtasnet_tpu/cli/train.py (the reference's
train.py:15-98), with --use_kernels in place of --use_pallas and --device.

    python -m convtasnet_torch.cli.train --train_dir data/json/tr \\
        --valid_dir data/json/cv --batch_size 5 --use_kernels hybrid

--use_kernels picks the TCN chain of training (config.py): 0 / auto / block
train the eager chain under autograd, hybrid the whole-TCN training op
(backward kernels of csrc/tcn_block_bwd.cu), whole the per-block
recompute op; the CV forward runs the inference kernels under any of them
but 0. Runs on CUDA unless --device cpu is given.

Several cards (one process each; parallel/mesh.py):

    torchrun --nproc_per_node 4 -m convtasnet_torch.cli.train --dp 4 ...
    torchrun --nproc_per_node 4 -m convtasnet_torch.cli.train --dp 2 --tp 2 ...

or the JAX CLI's rendezvous flags (--multihost 1 --coordinator_address
host:port --num_processes N --process_id i). Under DP each rank trains its
rows with the --use_kernels form; under TP or CP the chain is eager, as in
the JAX package.

On one card the train step and the CV step run as CUDA graphs, one per
batch shape (training/solver.GraphedStep), with the parameters,
optimizer state and BN state updated in place. Under --dp on cards (NCCL,
tp = cp = 1) every rank runs them as graphs too, with the step's
all-reduces recorded inside; under --tp / --cp, and on gloo (--device
cpu), both run eagerly. The run ends with each wrapper's counts in the
log.

--remat {0,none,1,repeat,block,dots} rematerialises the eager chain in
backward (config.py; the kernel forms ignore it, as the JAX Pallas tiers
do), --scan_unroll is accepted for the JAX CLI's sake and changes nothing,
--visualize 1 re-renders <save_folder>/loss.png each epoch and
loss_iter.png from every iteration's loss (utils/visualize.py).
"""

from __future__ import annotations

import argparse

import torch

from ..config import ConvTasNetConfig, TrainConfig
from ..data.dataset import AudioDataset, DataLoader
from ..models.conv_tasnet import ConvTasNet
from ..parallel.distributed import shutdown
from ..training.solver import Solver
from .common import (add_device_flag, add_parallel_flags, add_use_kernels_flag,
                     resolve_mesh_kernels, setup_parallel)


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
    p.add_argument("--mask_nonlinear", default="relu", choices=["relu", "softmax", "sigmoid"])
    # The paper's final version (arXiv:1809.07454v3), first-version defaults
    p.add_argument("--Sc", default=0, type=int,
                   help="skip-connection channels per block; 0 = no skip path")
    p.add_argument("--encoder_relu", default=1, type=int, help="0 = a linear encoder")
    p.add_argument("--input_norm", default="cLN", choices=["cLN", "gLN"])
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
    p.add_argument("--visualize", default=0, type=int,
                   help="re-render <save_folder>/loss.png each epoch (visdom analogue)")
    # Device and kernels
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--remat", default="0", type=str,
                   choices=["0", "none", "1", "repeat", "block", "dots"],
                   help="backprop rematerialisation of the eager chain: 1 / repeat per "
                        "repeat, block per block, dots per block keeping the matmul outputs")
    p.add_argument("--scan_unroll", default=1, type=int,
                   help="the JAX CLI's unroll of the scan over the R repeats (no effect)")
    add_use_kernels_flag(p)
    add_device_flag(p)
    p.add_argument("--pad_to_multiple", default=1, type=int,
                   help="pad CV batches to a sample multiple")
    add_parallel_flags(p, dp_default=0)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(args)
    device, mesh, joined = setup_parallel(args)
    try:
        return _train(args, device, mesh)
    finally:
        if joined:
            shutdown()


def _train(args, device, mesh):
    model_cfg = ConvTasNetConfig(
        N=args.N, L=args.L, B=args.B, H=args.H, P=args.P, X=args.X, R=args.R, C=args.C,
        norm_type=args.norm_type, causal=bool(args.causal),
        mask_nonlinear=args.mask_nonlinear, compute_dtype=args.compute_dtype,
        Sc=args.Sc, encoder_relu=bool(args.encoder_relu), input_norm=args.input_norm,
        use_kernels=args.use_kernels,
        remat={"0": False, "none": False, "1": "repeat"}.get(args.remat, args.remat),
        scan_unroll=args.scan_unroll)
    train_cfg = TrainConfig(
        epochs=args.epochs, half_lr=bool(args.half_lr), early_stop=bool(args.early_stop),
        max_norm=args.max_norm, batch_size=args.batch_size, optimizer=args.optimizer,
        lr=args.lr, momentum=args.momentum, l2=args.l2, sample_rate=args.sample_rate,
        segment=args.segment, cv_maxlen=args.cv_maxlen, shuffle=bool(args.shuffle),
        save_folder=args.save_folder, checkpoint=bool(args.checkpoint),
        continue_from=args.continue_from, save_every_steps=args.save_every_steps,
        model_path=args.model_path, print_freq=args.print_freq, seed=args.seed,
        visualize=bool(args.visualize), dp=mesh.dp if mesh else 1, tp=args.tp, cp=args.cp)
    if mesh is not None:
        model_cfg = resolve_mesh_kernels(model_cfg, mesh.tp, mesh.cp)

    tr_dataset = AudioDataset(args.train_dir, args.batch_size, sample_rate=args.sample_rate,
                              segment=args.segment, num_speakers=args.C)
    cv_bs = args.cv_batch_size
    if cv_bs <= 0:  # one utterance per data rank (the JAX CLI's rule)
        cv_bs = mesh.dp if mesh is not None and mesh.cp == 1 else 1
    cv_dataset = AudioDataset(args.valid_dir, batch_size=cv_bs,
                              sample_rate=args.sample_rate, segment=-1,
                              cv_maxlen=args.cv_maxlen, num_speakers=args.C,
                              pad_to_multiple=args.pad_to_multiple)
    tr_loader = DataLoader(tr_dataset, shuffle=bool(args.shuffle),
                           num_workers=args.num_workers, seed=args.seed)
    cv_loader = DataLoader(cv_dataset, num_workers=max(1, args.num_workers // 2))

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = ConvTasNet(model_cfg, device=device, generator=gen)
    solver = Solver(model, train_cfg, tr_loader, cv_loader, mesh=mesh)
    out = solver.train()
    for name, c in (out["graphs"] or {}).items():
        solver.log(f"{name} graphs: {c['captures']} captures, {c['replays']} replays, "
                   f"{c['eager_calls']} eager calls, {c['keys']} keys, "
                   f"{c['pool_bytes']} pool bytes")
    return out


if __name__ == "__main__":
    main()
