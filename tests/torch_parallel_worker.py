"""One rank of the port's multi-process CPU tests (gloo).

Imported by the spawned rank processes of tests/test_torch_parallel_*.py;
it imports torch and the port only. `run_ranks` starts `world` ranks of
`rank_main` (spawn), joins each with a timeout and terminates what is left.
A rank reads the cases from `cases.json` and their inputs from
`in_<name>.npz`, runs each on its mesh, and writes `out_<name>_r<rank>.npz`.
"""

import json
import multiprocessing
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from convtasnet_torch.training.optim import tree_paths

JOIN_TIMEOUT_S = 120.0


def run_ranks(world, target, args, timeout=JOIN_TIMEOUT_S):
    """Start `world` spawn processes of target(rank, world, *args); returns
    their exit codes (None for a rank that had to be terminated)."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world) + tuple(args)) for r in range(world)]
    for p in procs:
        p.start()
    codes = []
    for p in procs:
        p.join(timeout)
        if p.is_alive():
            p.terminate()
            p.join(10)
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


def flat(tree):
    """Nested dict of tensors / arrays -> {"a/b": np.ndarray}."""
    return {p: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            for p, v in tree_paths(tree)}


def unflat(arrays, prefix):
    tree = {}
    for key, a in arrays.items():
        if not key.startswith(prefix):
            continue
        *parents, leaf = key[len(prefix):].split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(np.array(a, dtype=np.float32))
    return tree


def _run_case(case, rank, out_dir):
    from convtasnet_torch.config import ConvTasNetConfig
    from convtasnet_torch.parallel import comm
    from convtasnet_torch.parallel.context import make_cp_train_step
    from convtasnet_torch.parallel.mesh import (gather_params, make_mesh, mesh_forward,
                                                shard_batch_fn, shard_params_fn)
    from convtasnet_torch.training.optim import Optimizer
    from convtasnet_torch.training.solver import make_train_step

    dp, tp, cp = case["mesh"]
    mesh = make_mesh(dp, tp, cp, "cpu")
    cfg = ConvTasNetConfig(**case["cfg"])
    z = dict(np.load(os.path.join(out_dir, f"in_{case['name']}.npz")))
    params, state = unflat(z, "params/"), unflat(z, "state/")
    mix, src, lens = z["mixture"], z["source"], z["lengths"]
    out = {"coord": np.array([mesh.data_rank, mesh.model_rank, mesh.context_rank])}
    with torch.no_grad():
        mix_l, _, _ = shard_batch_fn(mesh)(mix, lens, None)
        out["est"] = mesh_forward(cfg, params, state, mesh)(mix_l).numpy()
    if case.get("train"):
        mix_l, len_l, src_l = shard_batch_fn(mesh)(mix, lens, src)
        shard = shard_params_fn(mesh, tp, cfg.C)
        opt = Optimizer("sgd", lr=1.0)
        for tag, max_norm in (("", 1e9), ("clip_", 1e-3)):
            p0, s0, o0 = shard(params, state, opt.init(params))
            make = ((lambda: make_cp_train_step(cfg, opt, mesh, max_norm)) if cp > 1
                    else (lambda: make_train_step(cfg, opt, max_norm, mesh)))
            step = make()
            comm.reset_counts()
            p1, _, s1, loss, gnorm = step(p0, o0, s0, mix_l, src_l, len_l)
            out[tag + "collectives"] = np.array(comm.counts()["collectives"])
            # SGD at lr 1: the (clipped) gradient is the parameter change.
            w0, w1, ws = (gather_params(mesh, cfg.C, t)[0] for t in (p0, p1, s1))
            for k, v in flat(w0).items():
                out[f"{tag}grad/{k}"] = v - flat(w1)[k]
            for k, v in flat(ws).items():
                out[f"{tag}state/{k}"] = v
            out[tag + "loss"] = np.array(float(loss))
            out[tag + "gnorm"] = np.array(float(gnorm))
    np.savez(os.path.join(out_dir, f"out_{case['name']}_r{rank}.npz"), **out)


def rank_main(rank, world, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(out_dir, "cases.json")) as f:
            cases = json.load(f)
        for case in cases:
            _run_case(case, rank, out_dir)
    except Exception:
        with open(os.path.join(out_dir, f"error_r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def cli_main(rank, world, out_dir, cli, argv):
    """Run convtasnet_torch.cli.<cli> as one rank (the JAX-style
    rendezvous flags, a file store); write its result as JSON."""
    import importlib

    torch.set_num_threads(1)
    mod = importlib.import_module(f"convtasnet_torch.cli.{cli}")
    argv = list(argv) + ["--coordinator_address", f"file://{out_dir}/store_{cli}",
                         "--num_processes", str(world), "--process_id", str(rank)]
    try:
        result = mod.main(argv)
    except Exception:
        with open(os.path.join(out_dir, f"error_{cli}_r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    with open(os.path.join(out_dir, f"{cli}_r{rank}.json"), "w") as f:
        json.dump(result, f)
