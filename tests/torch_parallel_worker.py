"""One rank of the port's multi-process CPU tests (gloo).

Imported by the spawned rank processes of tests/test_torch_parallel_*.py
and tests/test_torch_graphed_mesh.py; it imports torch and the port only.
`run_ranks` starts `world` ranks of `rank_main` or `graph_main` (spawn),
joins each with a timeout and terminates what is left. A rank reads the
cases from `cases.json` and their inputs from `in_<name>.npz`, runs each
on its mesh, and writes `out_<name>_r<rank>.npz`.

`RecordOnly` is the capture backend of the graphed-step tests, which
have no card (tests/test_torch_graphed_step.py, test_torch_graphed_mesh.py).
"""

import collections
import json
import multiprocessing
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from convtasnet_torch.training.optim import tree_paths

JOIN_TIMEOUT_S = 120.0


class RecordOnly:
    """A capture backend without a card. Its warm-up runs the function,
    its capture returns empty outputs shaped like the warm-up's (a captured
    graph's static outputs hold nothing until the first replay) without
    running it, as a real capture runs no kernel and no collective, and its
    replay runs the function and writes the results into those outputs.
    `fail` makes the next capture raise."""

    def __init__(self):
        self.warm_ups, self.captures, self.fail = 0, 0, False
        self._warm = None

    def warm_up(self, fn, inputs):
        self.warm_ups += 1
        self._warm = fn(*inputs)
        return self._warm

    def capture(self, fn, inputs, pool=None):
        from convtasnet_torch.models import graphed

        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        self.captures += 1
        single = isinstance(self._warm, torch.Tensor)
        outs = tuple(torch.empty_like(t) for t in ((self._warm,) if single else self._warm))

        def replay():
            new = fn(*inputs)
            for o, n in zip(outs, (new,) if single else new):
                o.copy_(n)

        return graphed.Program(replay, outs[0] if single else outs, pool or "pool", 0)


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


# A host batch as the Solver's loaders give it.
Batch = collections.namedtuple("Batch", "mixture lengths source")


def _graph_solver_run(case, z, mesh, graphed_run, out_dir):
    """One Solver on `mesh` over the case's batches: graphed through
    RecordOnly with the step gate forced on, or as the gate leaves it (gloo:
    eager). Returns its results as arrays, keys prefixed by the mode."""
    from convtasnet_torch.config import ConvTasNetConfig, TrainConfig
    from convtasnet_torch.models import graphed
    from convtasnet_torch.models.conv_tasnet import ConvTasNet
    from convtasnet_torch.parallel import comm
    from convtasnet_torch.parallel.mesh import steps_graphable
    from convtasnet_torch.training import solver as solver_mod

    mode = "graphed" if graphed_run else "eager"
    cfg = ConvTasNetConfig(**case["cfg"])
    model = ConvTasNet(cfg, unflat(z, "params/"), unflat(z, "state/"), device="cpu")
    batches = [Batch(z[f"mix_{k}"], z[f"lens_{k}"], z[f"src_{k}"]) for k in "ABC"]
    cv = [Batch(z[f"cv_mix_{i}"], z[f"cv_lens_{i}"], z[f"cv_src_{i}"])
          for i in range(case["cv_batches"])]
    saved = graphed.backend_for, solver_mod.steps_graphable
    if graphed_run:  # gloo cannot be captured: the stand-in records, replays run
        backend = RecordOnly()
        graphed.backend_for = lambda device: backend
        solver_mod.steps_graphable = lambda mesh: True
    graphed.reset_counts()
    try:
        tcfg = TrainConfig(optimizer="adam", lr=1e-4, max_norm=5.0,
                           save_folder=os.path.join(out_dir, mode))
        s = solver_mod.Solver(model, tcfg, None, cv, log=lambda msg: None, mesh=mesh)
        out = {"gate": np.array(steps_graphable(mesh)),
               "graphed_step": np.array(isinstance(s.train_step, solver_mod.GraphedStep))}
        losses, collectives, rows = [], [], []
        for i, k in enumerate(case["order"]):
            mix, lens, src = s._to_device(batches["ABC".index(k)])
            rows.append(mix.shape[0])
            comm.reset_counts()
            s.params, s.opt_state, s.state, loss, gnorm = s.train_step(
                s.params, s.opt_state, s.state, mix, src, lens)
            collectives.append(comm.counts()["collectives"])
            losses.append([float(loss), float(gnorm)])
            if i + 1 == case["jax_steps"]:  # copies: the static trees change in place
                for name, tree in (("params", s.params), ("state", s.state),
                                   ("mu", s.opt_state.mu), ("nu", s.opt_state.nu)):
                    out.update({f"{name}/{p}": v.copy() for p, v in flat(tree).items()})
        for name, tree in (("final_params", s.params), ("final_state", s.state),
                           ("final_mu", s.opt_state.mu), ("final_nu", s.opt_state.nu)):
            out.update({f"{name}/{p}": v for p, v in flat(tree).items()})
        out["final_step"] = np.array(int(s.opt_state.step))
        out.update(losses=np.array(losses), collectives=np.array(collectives),
                   rows=np.array(rows))

        inner, cv_calls = s.eval_step, []

        def counted(*args):
            before = comm.counts()["collectives"]
            loss = inner(*args)
            cv_calls.append([comm.counts()["collectives"] - before, float(loss)])
            return loss

        s.eval_step = counted
        out["cv_mean"] = np.array(s._run_one_epoch(0, cross_valid=True)[0])
        out["cv_calls"] = np.array(cv_calls)
        s.eval_step = inner
        counts = s.graph_counts()
        out["graph_counts_none"] = np.array(counts is None)
        if counts is not None:
            for step, c in counts.items():
                for k in ("eager_calls", "captures", "replays", "keys", "graphs"):
                    out[f"{step}/{k}"] = np.array(c[k])
            out["train_keys"] = np.array(sorted(repr(k) for k in s.train_step.graphed.graphs()))
    finally:
        graphed.backend_for, solver_mod.steps_graphable = saved
    return {f"{mode}/{k}": v for k, v in out.items()}


def _eager_meshes(rank, world, out_dir):
    """TP and CP meshes over gloo: the Solver keeps the plain steps."""
    from convtasnet_torch.config import ConvTasNetConfig, TrainConfig
    from convtasnet_torch.models.conv_tasnet import ConvTasNet
    from convtasnet_torch.parallel.mesh import make_mesh, steps_graphable
    from convtasnet_torch.training.solver import GraphedStep, Solver

    out = {}
    cfg = ConvTasNetConfig(N=8, L=4, B=8, H=16, P=3, X=3, R=1, C=2, compute_dtype="float32",
                           use_kernels="0")
    for name, shape in (("tp", (1, world, 1)), ("cp", (1, 1, world))):
        mesh = make_mesh(*shape, "cpu")
        model = ConvTasNet(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        s = Solver(model, TrainConfig(save_folder=os.path.join(out_dir, name)), None, [],
                   log=lambda msg: None, mesh=mesh)
        out[f"{name}/gate"] = np.array(steps_graphable(mesh))
        out[f"{name}/graphed_step"] = np.array(isinstance(s.train_step, GraphedStep)
                                               or hasattr(s.eval_step, "graphed"))
        out[f"{name}/graph_counts_none"] = np.array(s.graph_counts() is None)
    np.savez(os.path.join(out_dir, f"out_meshes_r{rank}.npz"), **out)


def _failing_capture(rank, world, out_dir):
    """A DP Solver forced graphed whose capture fails: the capturing call
    raises GraphError naming the key on this rank, the next call of the key
    raises again, and no call goes on eagerly."""
    from convtasnet_torch.config import ConvTasNetConfig, TrainConfig
    from convtasnet_torch.models import graphed
    from convtasnet_torch.models.conv_tasnet import ConvTasNet
    from convtasnet_torch.parallel.mesh import make_mesh
    from convtasnet_torch.training import solver as solver_mod

    cfg = ConvTasNetConfig(N=8, L=4, B=8, H=16, P=3, X=3, R=1, C=2, compute_dtype="float32",
                           use_kernels="hybrid")
    rng = np.random.default_rng(3)
    src = (rng.normal(size=(4, 2, 120)) * 0.3).astype(np.float32)
    batch = Batch(src.sum(1), np.full(4, 120, np.int32), src)
    saved = graphed.backend_for, solver_mod.steps_graphable
    backend = RecordOnly()
    graphed.backend_for = lambda device: backend
    solver_mod.steps_graphable = lambda mesh: True
    errors = []
    try:
        model = ConvTasNet(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        s = solver_mod.Solver(model, TrainConfig(save_folder=os.path.join(out_dir, "fail")),
                              None, None, log=lambda msg: None, mesh=make_mesh(world, 1, 1, "cpu"))
        mix, lens, src_t = s._to_device(batch)
        s.train_step(s.params, s.opt_state, s.state, mix, src_t, lens)
        backend.fail = True
        for _ in range(2):
            try:
                s.train_step(s.params, s.opt_state, s.state, mix, src_t, lens)
            except graphed.GraphError as e:
                errors.append(str(e))
        calls = s.train_step.graphed.calls
    finally:
        graphed.backend_for, solver_mod.steps_graphable = saved
    np.savez(os.path.join(out_dir, f"out_fail_r{rank}.npz"), errors=np.array(errors),
             eager_calls=np.array(calls["eager_calls"]), step=np.array(int(s.opt_state.step)))


def graph_main(rank, world, out_dir):
    """The graphed-step cases of tests/test_torch_graphed_mesh.py on a DP
    mesh of `world` gloo ranks (each case graphed and eager), then the TP
    and CP meshes and a failing capture."""
    from convtasnet_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(out_dir, "cases.json")) as f:
            cases = json.load(f)
        mesh = make_mesh(world, 1, 1, "cpu")
        for case in cases:
            z = dict(np.load(os.path.join(out_dir, f"in_{case['name']}.npz")))
            out = {}
            for graphed_run in (True, False):
                out.update(_graph_solver_run(case, z, mesh, graphed_run, out_dir))
            np.savez(os.path.join(out_dir, f"out_{case['name']}_r{rank}.npz"), **out)
        _eager_meshes(rank, world, out_dir)
        _failing_capture(rank, world, out_dir)
    except Exception:
        with open(os.path.join(out_dir, f"error_r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
