"""Does torch.profiler still see the card's kernels around a process group?

Each scenario runs in a fresh process on the card. After each of its
stages a probe profiles a fixed loop of matmuls with torch.profiler
(CUDA activity) and records the device time it saw; 0 means the profiler
recorded no kernel. The scenarios take apart what the parallel phase of
chip_smoke.py does in one process: an NCCL group joined from a file
store or from torchrun's variables, collectives inside and outside a
profile, destroy_process_group, two gloo ranks spawned on the same card. The
"graph" scenario captures the paper-config forward (`auto`, batch 1 x 4 s)
as a CUDA graph (models/graphed.py), then profiles three replays and three
eager forwards; each must show device time.

    python -m convtasnet_torch.tools.check_profiler [--scenarios nccl gloo_cuda ...]

Prints one JSON line per scenario: {"scenario", "stages": [[stage,
device_us, cuda_events], ...], "blind_after": first stage with no device
time or null}. Exits 1 when a scenario failed or left the profiler blind.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

SCENARIOS = ("baseline", "many_profiles", "nccl", "nccl_cold", "nccl_env",
             "nccl_profiled_collective", "gloo_cuda", "spawn_gloo2", "graph")


def _profiled(fn, calls: int):
    """(device us, kernel names) torch.profiler records over `calls` of fn,
    raw (tools/_bench.profile_records: no filler, no check)."""
    import torch

    from ._bench import profile_records

    torch.cuda.synchronize()
    recs = profile_records(fn, calls)
    return sum(us for _, us in recs.values()), len(recs)


def _probe():
    import torch

    a = [torch.randn(1024, 1024, device="cuda")]

    def step():
        a[0] = a[0] @ a[0]
        a[0] = a[0] / a[0].norm()

    return _profiled(step, 5)


def _graph_scenario(stages):
    """A graphed paper-config forward: eager, capture, then a profile of
    replays and one of eager forwards."""
    import torch

    from ..config import ConvTasNetConfig
    from ..models import graphed
    from ..models.conv_tasnet import forward, init_params

    cfg = ConvTasNetConfig()
    params, state = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                                device="cuda")
    mix = torch.randn((1, 32000), device="cuda")

    def eager():
        return forward(params, state, cfg, mix)[0]

    g = graphed.GraphedForward(lambda m: forward(params, state, cfg, m)[0])
    with torch.inference_mode():
        g(mix)
        g(mix)  # the capture
        graphed.reset_counts()
        us, n = _profiled(lambda: g(mix), 3)
        stages.append(["profile of 3 replays", us, n])
        if graphed.counts()["replays"] != 3:
            raise RuntimeError(f"expected 3 replays, got {graphed.counts()}")
        us, n = _profiled(eager, 3)
        stages.append(["profile of 3 eager forwards", us, n])


def _gloo_rank(rank, world, store):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    t = torch.ones(1 << 20, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    dist.destroy_process_group()


def _one(name: str, tmp: str) -> dict:
    import torch
    import torch.distributed as dist

    from ..parallel import distributed

    stages = []

    def probe(stage):
        us, n = _probe()
        stages.append([stage, us, n])

    def all_reduce():
        t = torch.ones(1 << 20, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()

    torch.cuda.set_device(0)
    if name != "nccl_cold":
        probe("start")
    if name == "many_profiles":
        for i in range(200):
            probe(f"profile {i + 1}")
    elif name in ("nccl", "nccl_cold", "nccl_profiled_collective"):
        distributed.initialize(f"file://{tmp}/store", 1, 0)
        if name != "nccl_cold":
            probe("group joined")
        all_reduce()
        sub = dist.new_group([0])
        dist.all_reduce(torch.ones(4, device="cuda"), group=sub)
        if name == "nccl_profiled_collective":
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
                for _ in range(3):
                    all_reduce()
            probe("after a profile of collectives")
        elif name != "nccl_cold":
            probe("after collectives")
        distributed.shutdown()
        probe("after shutdown")
        probe("again")
    elif name == "nccl_env":
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                          WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
        distributed.initialize()
        all_reduce()
        distributed.shutdown()
        probe("after shutdown")
    elif name == "gloo_cuda":
        distributed.initialize(f"file://{tmp}/store", 1, 0, backend="gloo")
        all_reduce()
        distributed.shutdown()
        probe("after shutdown")
    elif name == "spawn_gloo2":
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_gloo_rank, args=(r, 2, f"{tmp}/store2")) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
        stages.append(["ranks exited", [p.exitcode for p in procs], 0])
        probe("after the spawned ranks")
    elif name == "graph":
        _graph_scenario(stages)
    elif name != "baseline":
        raise SystemExit(f"unknown scenario {name}")
    probe("end")
    blind = next((s[0] for s in stages if s[0] != "ranks exited" and s[1] <= 0), None)
    return {"scenario": name, "stages": stages if name != "many_profiles" else
            [s for s in stages if s[1] <= 0][:5] + stages[-1:], "blind_after": blind}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser("torch.profiler around process groups, on the card")
    p.add_argument("--scenarios", nargs="+", default=list(SCENARIOS), choices=SCENARIOS)
    p.add_argument("--one", default=None, help=argparse.SUPPRESS)
    p.add_argument("--timeout", type=float, default=240.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("check_profiler: no CUDA device (torch.cuda.is_available() is false)")
    if args.one:
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps(_one(args.one, tmp)), flush=True)
        return 0
    failed = 0
    for name in args.scenarios:
        try:
            out = subprocess.run([sys.executable, "-m", "convtasnet_torch.tools.check_profiler",
                                  "--one", name], capture_output=True, text=True,
                                 timeout=args.timeout)
            lines = out.stdout.strip().splitlines()
            if out.returncode or not lines:
                failed += 1
                print(json.dumps({"scenario": name, "rc": out.returncode,
                                  "stderr": out.stderr[-1500:]}), flush=True)
            else:
                print(lines[-1], flush=True)
                failed += json.loads(lines[-1])["blind_after"] is not None
        except subprocess.TimeoutExpired:
            failed += 1
            print(json.dumps({"scenario": name, "rc": "timeout"}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
