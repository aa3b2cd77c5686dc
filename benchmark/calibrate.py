"""The readings a cell's limits are set from, many seeds in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 ... \
        [--seconds 2] [--control 3] [--faults half_batch altered]

For each seed, a run as `benchmark.run` makes it (set-up, a window of
`--seconds`, the check), printed as one JSON line with its numbers: the
program's readings. For the first `--control` seeds, the control: the
same sampled outputs computed by the reference one precision below the
configuration's (float8 e4m3 activations for bf16), in the program's place.
For each fault of `--faults` and the first `--fault_seeds` seeds, a run with that
fault planted in the port (benchmark/faults.py). For the first `--witness`
seeds, the reference without rounding (`--witness_kind f32`) or rounding
its backward to bf16 as well (`bf16_backward`) in the program's place: a
second witness of how far rounding alone moves each number. The last line sums up:
the largest program reading and the smallest control and fault reading of
each number. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from benchmark import faults, harness, spec
from benchmark.reference.convtasnet import rounding


def _free():
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser("Readings for a cell's limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault_seeds", type=int, default=3)
    p.add_argument("--witness", type=int, default=0,
                   help="seeds on which the float32 reference stands in for the program")
    p.add_argument("--witness_kind", choices=("f32", "bf16_backward"), default="f32")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    low, high = {}, {}

    def note(kind, seed, checks):
        row = {"kind": kind, "seed": seed, **{k: v["value"] for k, v in checks.items()}}
        print(json.dumps(row), flush=True)
        for k, v in checks.items():
            if kind == "program":
                low[k] = max(low.get(k, 0.0), v["value"])
            else:
                high.setdefault(kind, {})
                high[kind][k] = min(high[kind].get(k, math.inf), v["value"])

    for seed in args.seeds:
        res = harness.run(args.workload, seed, args.seconds, False, args.device)
        note("program", seed, res["checks"])
        _free()
    for seed in args.seeds[:args.witness]:
        drv = harness.make_driver(cell, seed, args.device)
        drv.setup()
        drv.window(args.seconds)
        drv.release()
        _free()
        ref = drv.reference(rounding(torch.bfloat16))
        witness = (rounding(None) if args.witness_kind == "f32"
                   else rounding(torch.bfloat16, backward=True))
        note(f"{args.witness_kind}_reference", seed,
             {k: {"value": v} for k, v in drv.compare(drv.reference(witness), ref).items()})
        del drv
        _free()
    for seed in args.seeds[:args.control]:
        drv = harness.make_driver(cell, seed, args.device)
        drv.setup()
        drv.window(args.seconds)
        drv.release()
        _free()
        note("control", seed, harness.check(drv, cell.limits, control=True)[1])
        del drv
        _free()
    for name in args.faults:
        for seed in args.seeds[:args.fault_seeds]:
            with faults.plant(name):
                res = harness.run(args.workload, seed, args.seconds, False, args.device)
            note(name, seed, res["checks"])
            _free()
    print(json.dumps({"summary": args.workload, "program_max": low, "lowest": high}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
