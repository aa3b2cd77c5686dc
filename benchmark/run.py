"""One run of one cell of BENCHMARK.json on this machine's card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `checks`, each number compared beside its limit; those numbers are
also the last lines of standard error. Exits non-zero, printing no result,
without enough CUDA devices, when a step of the run fails, or when JAX or
the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import spec  # noqa: E402

# Build and kernel caches inside the checkout, at fixed paths (the port
# builds its own kernels into convtasnet_torch/_kernel_build/).
CACHE = os.path.join(spec.ROOT, ".bench_cache")


def main(argv=None) -> int:
    p = argparse.ArgumentParser("One run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")

    import torch

    from benchmark import harness

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                         started=STARTED)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
