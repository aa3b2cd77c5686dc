"""The graphed train and CV steps under a DP mesh (training/solver.py
`GraphedStep` behind parallel/mesh.steps_graphable) on the CPU.

Two gloo ranks (tests/torch_parallel_worker.py `graph_main`, spawned once
for the module) run each case through the Solver twice: graphed, with the
record-only capture backend (`RecordOnly`) and the step gate forced on,
since gloo cannot be captured for real; and as the gate leaves a gloo
group, eager. The stand-in's capture runs nothing and its replays run the
step, collectives included, so a capturing call that ran the step twice
would show in the collective counter and in opt_state.step. Each case runs
train batches A, B, A, B, A (4 rows, 2 per rank: eager first call,
capture, three replays), then C three times (3 rows, padded to 4: a key
of its own), then a CV epoch of three 2-row batches (eager, capture,
replay on both ranks in the same calls).

Against the eager mesh: bit for bit. Against JAX's jitted make_train_step
on the whole batch after the five A / B steps: rtol 2e-3 / atol 5e-4 (the
gradients' tolerance of tests/test_torch_train.py; Adam at lr 1e-4). The
card's captures with NCCL are held by chip_smoke.py's parallel phase."""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convtasnet_tpu
from convtasnet_torch.parallel import mesh as mesh_mod
from convtasnet_tpu.training import optim as jo
from convtasnet_tpu.training.solver import make_train_step as j_make_train_step

import torch_parallel_worker as worker

TOL = dict(rtol=2e-3, atol=5e-4)
SMALL = dict(N=16, L=8, B=16, H=32, P=3, X=3, R=2, C=2, compute_dtype="float32")
FORMS = ("hybrid", "whole", "0")
NORMS = ("gLN", "BN")
CASES = [{"name": f"{form}_{norm}", "cfg": {**SMALL, "use_kernels": form, "norm_type": norm},
          "order": "ABABACCC", "jax_steps": 5, "cv_batches": 3}
         for form in FORMS for norm in NORMS]
IDS = [c["name"] for c in CASES]
T = {"A": 480, "B": 480, "C": 400, "cv": 320}
ROWS = {"A": 4, "B": 4, "C": 3, "cv": 2}


def _batch(rng, rows, T):
    src = (rng.normal(size=(rows, 2, T)) * 0.3).astype(np.float32)
    return src.sum(1), src, np.array([T - 37 * i for i in range(rows)], np.int32)


def _inputs(norm):
    """Weights from the JAX package's init (one seed per norm) and the
    batches, as numpy."""
    jcfg = convtasnet_tpu.ConvTasNetConfig(norm_type=norm, **SMALL)
    params, state = convtasnet_tpu.init_params(jax.random.key(7), jcfg)
    rng = np.random.default_rng(7)
    batches = {k: _batch(rng, ROWS[k], T[k]) for k in "ABC"}
    cv = [_batch(rng, ROWS["cv"], T["cv"]) for _ in range(3)]
    return jcfg, params, state, batches, cv


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("graphed_mesh"))
    for case in CASES:
        _, params, state, batches, cv = _inputs(case["cfg"]["norm_type"])
        arrays = {f"params/{k}": v for k, v in worker.flat(
            jax.tree_util.tree_map(np.asarray, params)).items()}
        arrays.update({f"state/{k}": v for k, v in worker.flat(
            jax.tree_util.tree_map(np.asarray, state)).items()})
        for k, (mix, src, lens) in batches.items():
            arrays.update({f"mix_{k}": mix, f"src_{k}": src, f"lens_{k}": lens})
        for i, (mix, src, lens) in enumerate(cv):
            arrays.update({f"cv_mix_{i}": mix, f"cv_src_{i}": src, f"cv_lens_{i}": lens})
        np.savez(os.path.join(out, f"in_{case['name']}.npz"), **arrays)
    with open(os.path.join(out, "cases.json"), "w") as f:
        json.dump(CASES, f)
    codes = worker.run_ranks(2, worker.graph_main, (out,))
    errors = [open(os.path.join(out, e)).read() for e in sorted(os.listdir(out))
              if e.startswith("error_")]
    return {"dir": out, "codes": codes, "errors": errors}


def _ranks(world2, name):
    assert world2["codes"] == [0, 0], "\n".join(world2["errors"])
    return [dict(np.load(os.path.join(world2["dir"], f"out_{name}_r{r}.npz")))
            for r in range(2)]


def _tree(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def jax_refs():
    """Per norm: JAX's jitted step over the whole batches A, B, A, B, A
    (losses, parameters, moments, BN state after them)."""
    refs = {}
    for norm in NORMS:
        jcfg, params, state, batches, _ = _inputs(norm)
        opt = jo.Optimizer(kind="adam", lr=1e-4)
        step = j_make_train_step(convtasnet_tpu.ConvTasNet(jcfg), opt, max_norm=5.0)
        p, o, s, losses = params, opt.init(params), state, []
        for k in CASES[0]["order"][:CASES[0]["jax_steps"]]:
            mix, src, lens = batches[k]
            p, o, s, loss, gnorm = step(p, o, s, jnp.asarray(mix), jnp.asarray(src),
                                        jnp.asarray(lens))
            losses.append([float(loss), float(gnorm)])
        refs[norm] = {"losses": np.array(losses),
                      **{f"{name}/{k}": v for name, tree in (("params", p), ("state", s),
                                                             ("mu", o.mu), ("nu", o.nu))
                         for k, v in worker.flat(jax.tree_util.tree_map(np.asarray,
                                                                        tree)).items()}}
    return refs


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dp_solver_takes_the_graphed_step(world2, case):
    """Gate on: the Solver wraps both steps; each key is eager once,
    captured once, then replayed (A / B: 1 + 1 + 3, C: 1 + 1 + 1; CV:
    1 + 1 + 1). Gloo as it is: the plain steps, graph_counts() None."""
    for r, res in enumerate(_ranks(world2, case["name"])):
        assert res["graphed/graphed_step"] and not res["eager/graphed_step"], r
        assert not res["eager/gate"] and res["eager/graph_counts_none"], r
        assert not res["graphed/graph_counts_none"]
        got = {k: int(res[f"graphed/train_step/{k}"]) for k in
               ("eager_calls", "captures", "replays", "keys", "graphs")}
        assert got == {"eager_calls": 2, "captures": 2, "replays": 4, "keys": 2, "graphs": 2}
        cv = {k: int(res[f"graphed/cv_step/{k}"]) for k in ("eager_calls", "captures",
                                                           "replays")}
        assert cv == {"eager_calls": 1, "captures": 1, "replays": 1}
        assert int(res["graphed/final_step"]) == len(case["order"])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_graphed_dp_steps_equal_the_eager_mesh_steps_bit_for_bit(world2, case):
    """Losses and grad norms per call, and the parameters, moments and BN
    state after the last, graphed against eager, on both ranks; both ranks
    hold the same trees."""
    ranks = _ranks(world2, case["name"])
    for res in ranks:
        np.testing.assert_array_equal(res["graphed/losses"], res["eager/losses"])
        eager = _tree(res, "eager/final_")
        graphed = _tree(res, "graphed/final_")
        assert eager.keys() == graphed.keys() and len(eager) > 0
        for k in eager:
            np.testing.assert_array_equal(graphed[k], eager[k], err_msg=k)
    for k in _tree(ranks[0], "graphed/final_"):
        np.testing.assert_array_equal(ranks[0]["graphed/final_" + k],
                                      ranks[1]["graphed/final_" + k], err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_graphed_dp_steps_match_jax_whole_batch_steps(world2, jax_refs, case):
    """After A, B, A, B, A: every loss and grad norm, and the parameters,
    moments and BN state, against JAX's jitted step on the whole batch."""
    ref = jax_refs[case["cfg"]["norm_type"]]
    n = case["jax_steps"]
    for res in _ranks(world2, case["name"]):
        np.testing.assert_allclose(res["graphed/losses"][:n], ref["losses"], **TOL)
        got = _tree(res, "graphed/")
        for name in ("params", "state", "mu", "nu"):
            want = _tree(ref, name + "/")
            assert sorted(_tree(got, name + "/")) == sorted(want), name
            for k, v in want.items():
                np.testing.assert_allclose(got[f"{name}/{k}"], v, **TOL, err_msg=f"{name}/{k}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_each_collective_runs_once_per_call_on_every_rank(world2, case):
    """Train calls and the CV epoch's calls run as many collectives as the
    eager mesh's calls, on the capturing call as on the others (gLN: the
    row count and the bucket per train call, the row count and the loss
    per CV call); the CV losses and their mean equal the eager mesh's."""
    for res in _ranks(world2, case["name"]):
        np.testing.assert_array_equal(res["graphed/collectives"], res["eager/collectives"])
        assert len(set(res["eager/collectives"].tolist())) == 1
        if case["cfg"]["norm_type"] == "gLN":
            assert res["eager/collectives"][0] == 2
        cv_g, cv_e = res["graphed/cv_calls"], res["eager/cv_calls"]
        np.testing.assert_array_equal(cv_g[:, 0], cv_e[:, 0])
        assert cv_e[:, 0].tolist() == [2, 2, 2]
        np.testing.assert_array_equal(cv_g[:, 1], cv_e[:, 1])
        assert res["graphed/cv_mean"] == res["eager/cv_mean"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_a_last_batch_not_dividing_by_dp_is_one_key_on_both_ranks(world2, case):
    """C's 3 rows are padded to 4, so each rank steps 2 rows: both ranks
    see the same two keys, and C's calls (eager, capture, replay) give both
    the same loss."""
    ranks = _ranks(world2, case["name"])
    for res in ranks:
        assert res["graphed/rows"].tolist() == [2] * len(case["order"])
    keys = [res["graphed/train_keys"].tolist() for res in ranks]
    assert keys[0] == keys[1] and len(keys[0]) == 2
    assert any("(2, 400)" in k for k in keys[0]) and any("(2, 480)" in k for k in keys[0])
    np.testing.assert_array_equal(ranks[0]["graphed/losses"], ranks[1]["graphed/losses"])


def test_tp_and_cp_meshes_stay_eager(world2):
    """TP 2 and CP 2 over gloo: the gate is off, the Solver keeps the plain
    steps and graph_counts() is None."""
    assert world2["codes"] == [0, 0], "\n".join(world2["errors"])
    for r in range(2):
        res = dict(np.load(os.path.join(world2["dir"], f"out_meshes_r{r}.npz")))
        for name in ("tp", "cp"):
            assert not res[f"{name}/gate"] and not res[f"{name}/graphed_step"], (r, name)
            assert res[f"{name}/graph_counts_none"], (r, name)


def test_a_failing_capture_under_a_mesh_raises_on_the_rank(world2):
    """The capture fails after its warm-up (that call's one update, its
    collectives run on both ranks): GraphError names the key on each rank,
    the key is never run again, and nothing goes on eagerly."""
    assert world2["codes"] == [0, 0], "\n".join(world2["errors"])
    for r in range(2):
        res = dict(np.load(os.path.join(world2["dir"], f"out_fail_r{r}.npz")))
        errors = res["errors"].tolist()
        assert len(errors) == 2, r
        assert "capture of key" in errors[0] and "(2, 120)" in errors[0], errors[0]
        assert "failed before" in errors[1], errors[1]
        assert int(res["eager_calls"]) == 1 and int(res["step"]) == 2


@pytest.mark.parametrize("dp,tp,cp,device,backend,want", [
    (2, 1, 1, "cuda", "nccl", True),
    (1, 1, 1, "cuda", "nccl", True),
    (2, 1, 1, "cuda", "gloo", False),
    (2, 1, 1, "cpu", "gloo", False),
    (1, 2, 1, "cuda", "nccl", False),
    (1, 1, 2, "cuda", "nccl", False),
    (2, 2, 1, "cuda", "nccl", False),
])
def test_step_gate_reads_the_data_groups_backend(monkeypatch, dp, tp, cp, device, backend,
                                                 want):
    """steps_graphable: no mesh, or tp = cp = 1 with an NCCL data group on a
    card; the group's backend name faked."""
    group = object()
    monkeypatch.setattr(torch.distributed, "get_backend",
                        lambda g=None: backend if g is group else "unknown")
    mesh = SimpleNamespace(dp=dp, tp=tp, cp=cp, data=group, device=torch.device(device))
    assert mesh_mod.steps_graphable(None)
    assert mesh_mod.steps_graphable(mesh) is want
