"""The WSJ0-2mix recipe of the PyTorch port: the reference's
egs/wsj0/run.sh stages 0-4 (run.sh:77-175) as a config-driven Python
launcher, calling the port's CLIs (the counterpart of the JAX package's
recipes/wsj0/run.py).

    python -m convtasnet_torch.recipes.wsj0.run --stage 1 --stop_stage 4 \
        [--config overrides.json] [--device cuda]

Stages:
  0: corpus preparation — sphere->wav via the native SPHERE/shorten
     decoder (native/sphio.cpp through data/sphio.py, the sph2pipe
     analogue) and mixture creation (data/mixtures.py, the MERL-scripts
     analogue); pass --sphere_root to enable (see docs/data.md)
  1: manifest generation (preprocess)
  2: training
  3: evaluation (SI-SNRi, optional SDRi)
  4: separation (write per-speaker wavs)

Flag system: every CLI flag of the underlying tools is forwardable, plus
`--config file.json` merges a JSON dict of overrides (the Kaldi
parse_options.sh --config analogue, utils/parse_options.sh:33-41). The
experiment directory encodes the full hyperparameter set like
run.sh:102-106. --use_kernels replaces the JAX recipe's --use_pallas
(default auto: training on the eager chain with remat "dots", the CV and
evaluation forwards on the inference kernels, as --use_pallas 1 does),
and --device picks where every stage runs (default cuda; cpu runs the
kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import os

from ...config import USE_KERNELS_CHOICES


def build_parser():
    p = argparse.ArgumentParser("wsj0-2mix recipe")
    p.add_argument("--stage", type=int, default=1)
    p.add_argument("--stop_stage", type=int, default=4)
    p.add_argument("--config", type=str, default=None,
                   help="JSON file of overrides for any flag below")
    # Data
    p.add_argument("--wav_root", type=str, default="data/wsj0-mix/2speakers/wav8k/min",
                   help="prepared wav tree with tr/cv/tt x mix/s1/s2")
    p.add_argument("--json_root", type=str, default="data/json")
    p.add_argument("--sample_rate", type=int, default=8000)
    # Model (paper config defaults, run.sh:28-41)
    for flag, default in [("N", 256), ("L", 20), ("B", 256), ("H", 512),
                          ("P", 3), ("X", 8), ("R", 4), ("C", 2)]:
        p.add_argument(f"--{flag}", type=int, default=default)
    p.add_argument("--norm_type", default="gLN")
    p.add_argument("--causal", type=int, default=0)
    p.add_argument("--mask_nonlinear", default="relu")
    # Training (run.sh:42-56)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--half_lr", type=int, default=1)
    p.add_argument("--early_stop", type=int, default=1)
    p.add_argument("--max_norm", type=float, default=5.0)
    p.add_argument("--shuffle", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--optimizer", default="adam")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--l2", type=float, default=0.0)
    p.add_argument("--segment", type=float, default=4.0)
    p.add_argument("--cv_maxlen", type=float, default=8.0)
    p.add_argument("--checkpoint", type=int, default=1)
    p.add_argument("--continue_from", default="")
    p.add_argument("--save_every_steps", type=int, default=0,
                   help="mid-epoch latest.ckpt cadence (preemption-safe "
                        "resume; 0 = per-epoch only)")
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--visualize", type=int, default=1)
    # Device and kernels
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--remat", type=str, default="dots",
                   choices=["0", "none", "1", "repeat", "block", "dots"])
    p.add_argument("--scan_unroll", type=int, default=0,
                   help="0 = fully unroll the R-repeat scan")
    p.add_argument("--use_kernels", default="auto", type=str.lower, choices=USE_KERNELS_CHOICES)
    p.add_argument("--device", default="cuda",
                   help="torch device of every stage (default cuda; cpu to run without a GPU)")
    p.add_argument("--dp", type=int, default=0)
    p.add_argument("--pad_to_multiple", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    # Eval / separate
    p.add_argument("--cal_sdr", type=int, default=1)
    p.add_argument("--exp_root", default="exp")
    # Stage 0: corpus prep (sphere->wav via native/sphio.cpp, the sph2pipe
    # analogue; mixture creation via data/mixtures.py, the MERL analogue)
    p.add_argument("--sphere_root", default="auto",
                   help="raw WSJ0 corpus root with .wv1/.sph files; 'auto' "
                        "(default) probes $WSJ0_ROOT and <repo>/data/wsj0 "
                        "(detect_sphere_root); '' disables stage 0")
    p.add_argument("--spk_wav_root", default="data/wsj0_wav",
                   help="output tree for converted single-speaker wavs")
    p.add_argument("--create_mixtures", type=int, default=1)
    p.add_argument("--n_mix_tr", type=int, default=20000)
    p.add_argument("--n_mix_cv", type=int, default=5000)
    p.add_argument("--n_mix_tt", type=int, default=3000)
    p.add_argument("--mix_mode", default="min", choices=["min", "max"])
    p.add_argument("--mix_seed", type=int, default=0)
    return p


_WSJ0_SPLITS = ("si_tr_s", "si_dt_05", "si_et_05")


def detect_sphere_root(explicit: str = "auto") -> str:
    """Resolve the raw-WSJ0 corpus root.

    'auto' probes $WSJ0_ROOT and <repo>/data/wsj0 and returns the first
    directory holding the LDC split layout (si_tr_s / si_dt_05 /
    si_et_05, the reference's egs/wsj0/local/data_prepare.sh:16-33), at
    its top or one level down; '' when the corpus is absent, which skips
    stage 0. The repo candidate is anchored to the checkout, not the
    working directory."""
    if explicit != "auto":
        return explicit
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    for root in (os.environ.get("WSJ0_ROOT", ""), os.path.join(repo_root, "data", "wsj0")):
        if not root:
            continue
        for base in (root, os.path.join(root, "wsj0")):  # LDC discs nest it under wsj0/
            if any(os.path.isdir(os.path.join(base, s)) for s in _WSJ0_SPLITS):
                print(f"detect_sphere_root: using WSJ0 corpus at {base}")
                return base
    return ""


def exp_dir(a) -> str:
    """Hyperparameter-encoding experiment dir (run.sh:102-106 style)."""
    name = (
        f"train_r{a.sample_rate}_N{a.N}_L{a.L}_B{a.B}_H{a.H}_P{a.P}_X{a.X}"
        f"_R{a.R}_C{a.C}_{a.norm_type}_causal{a.causal}_{a.mask_nonlinear}"
        f"_epoch{a.epochs}_{a.optimizer}_lr{a.lr}_l2{a.l2}_bs{a.batch_size}"
    )
    return os.path.join(a.exp_root, name)


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.config:
        with open(args.config) as f:
            overrides = json.load(f)
        parser.set_defaults(**overrides)
        args = parser.parse_args(argv)

    save = exp_dir(args)
    os.makedirs(save, exist_ok=True)
    print(f"exp dir: {save}")

    if args.stage <= 0 <= args.stop_stage:
        sphere_root = detect_sphere_root(args.sphere_root)
        if not sphere_root:
            print("Stage 0: skipped (no WSJ0 corpus found — set $WSJ0_ROOT "
                  "or pass --sphere_root <wsj0>; see docs/data.md). The "
                  "recipe continues from the prepared wav tree if present.")
        else:
            args.sphere_root = sphere_root
            from ...data.mixtures import (
                create_mixtures, random_pair_list_from_files)
            from ...data.sphio import convert_sphere_dir
            # WSJ0 split dirs -> recipe splits (local/data_prepare.sh:16-33).
            splits = [("si_tr_s", "tr"), ("si_dt_05", "cv"), ("si_et_05", "tt")]
            found = [s for s, _ in splits
                     if os.path.isdir(os.path.join(args.sphere_root, s))]
            if found:
                for sub, split in splits:
                    src = os.path.join(args.sphere_root, sub)
                    if not os.path.isdir(src):
                        continue
                    dst = os.path.join(args.spk_wav_root, split)
                    n = len(convert_sphere_dir(src, dst,
                                               n_threads=args.num_workers))
                    print(f"Stage 0: {sub} -> {dst}: {n} wavs")
            else:
                dst = os.path.join(args.spk_wav_root, "tr")
                n = len(convert_sphere_dir(args.sphere_root, dst,
                                           n_threads=args.num_workers))
                print(f"Stage 0: {args.sphere_root} -> {dst}: {n} wavs "
                      "(no si_* split dirs found; all into tr)")
            if args.create_mixtures:
                counts = {"tr": args.n_mix_tr, "cv": args.n_mix_cv,
                          "tt": args.n_mix_tt}
                for split, n_mix in counts.items():
                    spk = os.path.join(args.spk_wav_root, split)
                    wavs = [os.path.join(r, f)
                            for r, _, fs in os.walk(spk)
                            for f in fs if f.endswith(".wav")]
                    if not wavs:
                        continue
                    # Distinct-speaker pairing + SNR draw, fully seeded.
                    pairs = random_pair_list_from_files(
                        wavs, min(n_mix, len(wavs) ** 2), C=args.C,
                        seed=args.mix_seed)
                    out = os.path.join(args.wav_root, split)
                    create_mixtures(pairs, out, sample_rate=args.sample_rate,
                                    mode=args.mix_mode)
                    print(f"Stage 0: wrote {len(pairs)} {split} mixtures -> {out}")

    if args.stage <= 1 <= args.stop_stage:
        print("Stage 1: generating manifests")
        from ...cli.preprocess import main as pp
        pp(["--in-dir", args.wav_root, "--out-dir", args.json_root,
            "--sample-rate", str(args.sample_rate),
            "--num-speakers", str(args.C)])

    if args.stage <= 2 <= args.stop_stage:
        print("Stage 2: training")
        from ...cli.train import main as tr
        tr([
            "--train_dir", os.path.join(args.json_root, "tr"),
            "--valid_dir", os.path.join(args.json_root, "cv"),
            "--sample_rate", str(args.sample_rate),
            "--segment", str(args.segment), "--cv_maxlen", str(args.cv_maxlen),
            "--N", str(args.N), "--L", str(args.L), "--B", str(args.B),
            "--H", str(args.H), "--P", str(args.P), "--X", str(args.X),
            "--R", str(args.R), "--C", str(args.C),
            "--norm_type", args.norm_type, "--causal", str(args.causal),
            "--mask_nonlinear", args.mask_nonlinear,
            "--epochs", str(args.epochs), "--half_lr", str(args.half_lr),
            "--early_stop", str(args.early_stop), "--max_norm", str(args.max_norm),
            "--shuffle", str(args.shuffle), "--batch_size", str(args.batch_size),
            "--num_workers", str(args.num_workers),
            "--optimizer", args.optimizer, "--lr", str(args.lr),
            "--momentum", str(args.momentum), "--l2", str(args.l2),
            "--save_folder", save, "--checkpoint", str(args.checkpoint),
            "--continue_from", args.continue_from,
            "--save_every_steps", str(args.save_every_steps),
            "--print_freq", str(args.print_freq),
            "--visualize", str(args.visualize),
            "--compute_dtype", args.compute_dtype, "--remat", args.remat,
            "--scan_unroll", str(args.scan_unroll if args.scan_unroll
                                 else args.R),
            "--use_kernels", args.use_kernels, "--device", args.device,
            "--dp", str(args.dp), "--tp", str(args.tp),
            "--pad_to_multiple", str(args.pad_to_multiple),
        ])

    if args.stage <= 3 <= args.stop_stage:
        print("Stage 3: evaluation")
        from ...cli.evaluate import main as ev
        ev([
            "--model_path", os.path.join(save, "final.ckpt"),
            "--data_dir", os.path.join(args.json_root, "tt"),
            "--cal_sdr", str(args.cal_sdr),
            "--sample_rate", str(args.sample_rate),
            "--pad_to_multiple", str(args.pad_to_multiple),
            "--use_kernels", args.use_kernels, "--device", args.device,
        ])

    if args.stage <= 4 <= args.stop_stage:
        print("Stage 4: separation")
        from ...cli.separate import main as sp
        sp([
            "--model_path", os.path.join(save, "final.ckpt"),
            "--mix_json", os.path.join(args.json_root, "tt", "mix.json"),
            "--out_dir", os.path.join(save, "separate"),
            "--sample_rate", str(args.sample_rate),
            "--pad_to_multiple", str(args.pad_to_multiple),
            "--use_kernels", args.use_kernels, "--device", args.device,
        ])


if __name__ == "__main__":
    main()
