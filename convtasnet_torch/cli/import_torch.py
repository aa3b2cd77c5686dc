"""Import a reference PyTorch checkpoint (.pth.tar) into a port checkpoint.

Counterpart of convtasnet_tpu/cli/import_torch.py. The reference serializes
models as a pickle package of hyperparameters + state_dict + optimizer
state + epoch + loss history (the reference's conv_tasnet.py:78-94). This
CLI converts such a package into a .ckpt (training/checkpoint.py; the
format loads in either package) that evaluate / separate and
--continue_from consume directly:

    python -m convtasnet_torch.cli.import_torch --torch_path final.pth.tar \\
        --out final.ckpt

The optimizer state is not converted (a fine-tune restarts the optimizer);
epoch and the tr / cv loss history are carried over. The package is
unpickled: import only files from a trusted source.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Convert a reference .pth.tar to a .ckpt")
    p.add_argument("--torch_path", type=str, required=True,
                   help="reference package (ConvTasNet.serialize output)")
    p.add_argument("--out", type=str, required=True, help="output .ckpt path")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   help="compute dtype recorded in the imported config "
                        "(params are stored f32 either way)")
    return p


def import_torch(args, log=print) -> str:
    from ..compat.torch_convert import import_package, load_torch_package
    from ..training.checkpoint import save_checkpoint
    from ..training.optim import tree_leaves

    package = load_torch_package(args.torch_path)
    cfg, params, state = import_package(package, compute_dtype=args.compute_dtype)

    def _hist(x, epoch):
        if x is None:
            return None
        x = list(map(float, getattr(x, "tolist", lambda: x)()))
        return x[:epoch] if epoch else x

    epoch = int(package.get("epoch", 0))
    save_checkpoint(args.out, cfg, params, state, epoch=epoch,
                    tr_loss=_hist(package.get("tr_loss"), epoch),
                    cv_loss=_hist(package.get("cv_loss"), epoch),
                    extra={"imported_from": args.torch_path})
    n = sum(t.numel() for t in tree_leaves(params))
    log(f"Imported {args.torch_path} -> {args.out} "
        f"({n / 1e6:.2f}M params, epoch {epoch}, "
        f"N={cfg.N} L={cfg.L} B={cfg.B} H={cfg.H} P={cfg.P} X={cfg.X} "
        f"R={cfg.R} C={cfg.C} {cfg.norm_type}"
        f"{' causal' if cfg.causal else ''} {cfg.mask_nonlinear})")
    return args.out


def main(argv=None):
    args = build_parser().parse_args(argv)
    return import_torch(args)


if __name__ == "__main__":
    main()
