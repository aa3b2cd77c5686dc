"""Preprocess CLI: scan wav dirs into JSON manifests (the reference's
preprocess.py:37-47; the flags of convtasnet_tpu/cli/preprocess.py).

    python -m convtasnet_torch.cli.preprocess --in-dir wav --out-dir json

Writes <out-dir>/{tr,cv,tt}/{mix,s1..sC}.json from <in-dir>/{tr,cv,tt}/...
"""

from __future__ import annotations

import argparse

from ..data.manifest import preprocess


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("WSJ0 data preprocessing")
    p.add_argument("--in-dir", type=str, required=True,
                   help="Directory path of wsj0 including tr, cv and tt")
    p.add_argument("--out-dir", type=str, required=True,
                   help="Directory path to put output files")
    p.add_argument("--sample-rate", type=int, default=8000)
    p.add_argument("--num-speakers", type=int, default=2,
                   help="Number of sK source dirs to manifest")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    print(args)
    speakers = ["mix"] + [f"s{i + 1}" for i in range(args.num_speakers)]
    preprocess(args.in_dir, args.out_dir, args.sample_rate, speakers=speakers)


if __name__ == "__main__":
    main()
