"""Data-parallel weak scaling of the train step over torch.distributed.

    torchrun --nproc_per_node N -m convtasnet_torch.tools.bench_scaling \\
        [--per_device_batch 8] [--steps 10] [--use_kernels hybrid]
    python -m convtasnet_torch.tools.bench_scaling --sizes 1 2 [--backend gloo] \\
        [--device cpu] [--tiny]

Weak scaling: each rank trains `per_device_batch` rows, so the global
batch grows with the world. Every rank runs the DP train step of
training/solver.py on its rows (seeded paper-config weights, a
data/synthetic batch of --seconds at 8 kHz, Adam, one gradient-bucket
all-reduce per step) and times `steps` steps after 2 warm-up steps (CUDA
events on a card, the host clock on the CPU).

Under torchrun (or the JAX package's COORDINATOR_ADDRESS variables) the
tool measures the world it was launched in, one process per card, and
rank 0 prints the row. Without a launcher it spawns each world size of
--sizes as processes of its own (a file store in a temporary directory;
the CPU form of the JAX tool's virtual-device mesh) and prints one row
per size, then a summary. The backend is nccl when every rank has a card
of its own, gloo otherwise: several ranks on one card (gloo carries the
all-reduce of CUDA tensors through the host) or on the CPU share the
device, and the summary says so (`shared_device`): their per-rank rates
are not per-card rates.

Row: {"devices", "global_batch", "ms", "audio_sps", "audio_sps_per_device",
"efficiency_vs_1" (from the second size on), "backend", "device"}.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import tempfile
import traceback

import numpy as np
import torch

from ..config import USE_KERNELS_CHOICES, ConvTasNetConfig
from ..data.synthetic import synthetic_batch
from ..models.conv_tasnet import init_params
from ..parallel import distributed
from ..parallel.mesh import make_mesh, shard_batch_fn
from ..training.optim import Optimizer
from ..training.solver import make_train_step
from ._bench import TINY, device_name, timed_ms

SR = 8000
JOIN_TIMEOUT_S = 600.0


def measure(args: argparse.Namespace, dev: torch.device) -> dict:
    """One rank's DP step time at the initialised world size."""
    world = distributed.world_size()
    cfg = ConvTasNetConfig(**(TINY if args.tiny else {}), use_kernels=args.use_kernels)
    T = int(args.seconds * SR)
    mesh = make_mesh(world, 1, 1, dev)
    gb = args.per_device_batch * world
    mix, lens, src = shard_batch_fn(mesh)(*synthetic_batch(np.random.default_rng(0), gb,
                                                           cfg.C, T, SR))
    params, state = init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    opt = Optimizer("adam", lr=1e-3)
    step = make_train_step(cfg, opt, 5.0, mesh)
    carry = [params, opt.init(params), state]

    def one():
        carry[0], carry[1], carry[2], _, _ = step(*carry, mix, src, lens)

    ms = timed_ms(one, args.steps, 2, dev)
    sps = gb * args.seconds / (ms / 1e3)
    return {"devices": world, "global_batch": gb, "ms": ms, "audio_sps": sps,
            "audio_sps_per_device": sps / world, "backend": torch.distributed.get_backend(),
            "device": device_name(dev)}


def _backend(args: argparse.Namespace, world: int) -> str:
    if args.backend:
        return args.backend
    own_card = args.device == "cuda" and world <= torch.cuda.device_count()
    return "nccl" if own_card else "gloo"


def _rank_main(rank: int, world: int, out_dir: str, args: argparse.Namespace) -> None:
    """One spawned rank: join, measure, rank 0 writes the row."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        dev = distributed.initialize(f"file://{out_dir}/store_{world}", world, rank,
                                     backend=_backend(args, world), device_type=args.device)
        try:
            row = measure(args, dev)
        finally:
            distributed.shutdown()
        if rank == 0:
            with open(os.path.join(out_dir, f"row_{world}.json"), "w") as f:
                json.dump(row, f)
    except Exception:
        with open(os.path.join(out_dir, f"error_{world}_r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _spawn(world: int, out_dir: str, args: argparse.Namespace) -> dict:
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, out_dir, args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        errors = [open(os.path.join(out_dir, e)).read() for e in sorted(os.listdir(out_dir))
                  if e.startswith(f"error_{world}_")]
        raise RuntimeError(f"world {world}: ranks exited {codes}\n" + "\n".join(errors))
    with open(os.path.join(out_dir, f"row_{world}.json")) as f:
        return json.load(f)


def main(argv=None):
    p = argparse.ArgumentParser("DP weak scaling of the train step")
    p.add_argument("--sizes", type=int, nargs="+", default=[1, 2],
                   help="world sizes to spawn (ignored under a launcher)")
    p.add_argument("--per_device_batch", type=int, default=8)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--use_kernels", default="hybrid", choices=USE_KERNELS_CHOICES)
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="default: nccl when each rank has a card of its own, else gloo")
    p.add_argument("--tiny", action="store_true", help="a small f32 config (CPU tests)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="default cuda; fails without a GPU unless cpu")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")

    if distributed.launched():
        world = int(os.environ.get("WORLD_SIZE", os.environ.get("NUM_PROCESSES", 1)))
        dev = distributed.initialize(backend=_backend(args, world), device_type=args.device)
        try:
            row, rank = measure(args, dev), distributed.rank()
        finally:
            distributed.shutdown()
        if rank == 0:
            print(json.dumps(row), flush=True)
        return [row]

    rows = []
    with tempfile.TemporaryDirectory() as out_dir:
        for world in args.sizes:
            row = _spawn(world, out_dir, args)
            if rows:
                row["efficiency_vs_1"] = row["audio_sps_per_device"] / rows[0]["audio_sps_per_device"]
            rows.append(row)
            print(json.dumps(row), flush=True)
    shared = args.device == "cpu" or max(args.sizes) > torch.cuda.device_count()
    print(json.dumps({"metric": "dp_weak_scaling", "backend": [r["backend"] for r in rows],
                      "shared_device": shared, "sizes": args.sizes,
                      "efficiency": [r.get("efficiency_vs_1", 1.0) for r in rows]}), flush=True)
    return rows


if __name__ == "__main__":
    main()
