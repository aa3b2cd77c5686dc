"""The graphed train and CV steps (convtasnet_torch/training/solver.py
`GraphedStep`, on models/graphed.GraphedForward) on the CPU.

The capture backend is a stand-in that records without running the
function, as a real capture runs no kernel (tests/torch_parallel_worker.py
`RecordOnly`): its warm-up runs the function, its capture returns empty
outputs shaped like the warm-up's (a captured graph's static outputs hold
nothing until the first replay), and its replay runs the function and
writes the results into those outputs. A wrapper that stepped at capture
as well would show in opt_state.step.

Against the JAX package's jitted, buffer-donating make_train_step on the
same weights (params_from_jax) and batches: rtol 2e-3 / atol 5e-4 (the
gradients' tolerance of tests/test_torch_train.py; Adam at lr 1e-4, where
a sign flip of a near-zero gradient element moves a parameter by at most
2e-4). Against the port's own eager steps: bit for bit. The card's graphs
are tested in tests/test_torch_cuda.py and chip_smoke.py."""

import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convtasnet_tpu
from convtasnet_torch.cli.train import main as train_main
from convtasnet_torch.config import ConvTasNetConfig, TrainConfig
from convtasnet_torch.data.dataset import AudioDataset, DataLoader
from convtasnet_torch.data.synthetic import make_wav_dataset
from convtasnet_torch.models import conv_tasnet as tm
from convtasnet_torch.models import graphed
from convtasnet_torch.parallel import distributed
from convtasnet_torch.parallel.mesh import make_mesh
from convtasnet_torch.training import optim as to
from convtasnet_torch.training.checkpoint import load_checkpoint
from convtasnet_torch.training.solver import GraphedStep, Solver, make_train_step
from convtasnet_tpu.training import optim as jo
from convtasnet_tpu.training.solver import make_train_step as j_make_train_step

from torch_parallel_worker import RecordOnly

torch.set_num_threads(1)
SMALL = dict(N=32, L=16, B=16, H=32, P=3, X=3, R=2, C=2, compute_dtype="float32")
TOL = dict(rtol=2e-3, atol=5e-4)
JAX_REMAT = {"none": False, "block": "block", "dots": "dots"}
STEPS = 5  # eager first call, capture, three replays


@pytest.fixture(autouse=True)
def _collect():
    """Free the wrappers that a test's own reference cycles keep alive, so
    that graphed.counts() (live wrappers) starts clean in the next test."""
    yield
    gc.collect()


@pytest.fixture
def record_only(monkeypatch):
    backend = RecordOnly()
    monkeypatch.setattr(graphed, "backend_for", lambda device: backend)
    graphed.reset_counts()
    yield backend
    graphed.reset_counts()


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)


def _batches(seed, M=2, T=640, n=2):
    """n seeded (mixture, source, lengths) numpy batches of one shape."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        src = (rng.normal(size=(M, 2, T)) * 0.3).astype(np.float32)
        out.append((src.sum(1), src, np.array([T - 61 * i for i in range(M)], np.int32)))
    return out


def _run(cfg, opt, params, state, batches, n, graph=True):
    """n steps from copies of the trees, cycling over `batches`: through a
    GraphedStep, or (graph=False) the plain step rebinding its trees.
    Returns (losses, params, opt_state, state, the step)."""
    params = to.tree_map(lambda t: t.clone(), params)
    state = to.tree_map(lambda t: t.clone(), state)
    o = opt.init(params)
    step = make_train_step(cfg, opt, 5.0)
    if graph:
        step = GraphedStep(step, params, o, state, tag=(cfg.kernel_form(True, "cpu"),))
    p, s, losses = params, state, []
    for i in range(n):
        mix, src, lens = (torch.from_numpy(a) for a in batches[i % len(batches)])
        p, o, s, loss, _ = step(p, o, s, mix, src, lens)
        losses.append(loss)
    return losses, p, o, s, step


def _assert_bits(a, b):
    """Two _run results equal bit for bit."""
    assert torch.equal(torch.stack(a[0]), torch.stack(b[0]))
    assert int(a[2].step) == int(b[2].step)
    for x, y in zip(to.tree_leaves(a[1]) + to.tree_leaves(a[2].mu) + to.tree_leaves(a[2].nu)
                    + to.tree_leaves(a[3]),
                    to.tree_leaves(b[1]) + to.tree_leaves(b[2].mu) + to.tree_leaves(b[2].nu)
                    + to.tree_leaves(b[3])):
        assert torch.equal(x, y)


# Optimizer keywords and model keywords per case.
JAX_CASES = {
    "adam": (dict(kind="adam", lr=1e-4), {}),
    "adam_l2": (dict(kind="adam", lr=1e-4, weight_decay=1e-2), {}),
    "sgd": (dict(kind="sgd", lr=0.1), {}),
    "sgd_momentum": (dict(kind="sgd", lr=0.1, momentum=0.9), {}),
    "adam_bn": (dict(kind="adam", lr=1e-4), dict(norm_type="BN")),
    "sgd_momentum_bn_hybrid": (dict(kind="sgd", lr=0.1, momentum=0.9),
                               dict(norm_type="BN", use_kernels="hybrid")),
    "adam_remat_block": (dict(kind="adam", lr=1e-4), dict(remat="block")),
    "adam_remat_dots": (dict(kind="adam", lr=1e-4), dict(remat="dots")),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_graphed_steps_match_jax_train_step(record_only, case):
    """STEPS calls of the graphed step (eager, capture, replays) against as
    many calls of the JAX package's jitted step: every loss, and the
    parameters, moments, step count and BN state after the last."""
    opt_kw, model_kw = JAX_CASES[case]
    norm_type = model_kw.get("norm_type", "gLN")
    remat = model_kw.get("remat", "none")
    jcfg = convtasnet_tpu.ConvTasNetConfig(norm_type=norm_type, remat=JAX_REMAT[remat],
                                           **SMALL)
    params, state = convtasnet_tpu.init_params(jax.random.key(4), jcfg)
    tp, ts = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                jax.tree_util.tree_map(np.asarray, state), "cpu")
    batches = _batches(4)
    jopt = jo.Optimizer(**opt_kw)
    jstep = j_make_train_step(convtasnet_tpu.ConvTasNet(jcfg), jopt, max_norm=5.0)
    jp, jo_state, js, jl = params, jopt.init(params), state, []
    for i in range(STEPS):
        jp, jo_state, js, loss, _ = jstep(jp, jo_state, js,
                                          *map(jnp.asarray, batches[i % len(batches)]))
        jl.append(float(loss))

    cfg = ConvTasNetConfig(norm_type=norm_type, use_kernels=model_kw.get("use_kernels", "0"),
                           remat=JAX_REMAT[remat], **SMALL)
    losses, p, o, s, step = _run(cfg, to.Optimizer(**opt_kw), tp, ts, batches, STEPS)
    assert graphed.counts() == {**graphed.counts(), "eager_calls": 1, "captures": 1,
                                "replays": STEPS - 2}
    assert int(o.step) == int(jo_state.step) == STEPS
    np.testing.assert_allclose([float(x) for x in losses], jl, **TOL)
    for (k, want), (_, got) in zip(_leaves(jp), _leaves(p)):
        np.testing.assert_allclose(got, want, **TOL, err_msg=k)
    for tree in ("mu", "nu"):
        for (k, want), (_, got) in zip(_leaves(getattr(jo_state, tree)),
                                       _leaves(getattr(o, tree))):
            np.testing.assert_allclose(got, want, **TOL, err_msg=f"{tree}/{k}")
    assert [k for k, _ in _leaves(js)] == [k for k, _ in _leaves(s)]
    for (k, want), (_, got) in zip(_leaves(js), _leaves(s)):
        np.testing.assert_allclose(got, want, **TOL, err_msg=k)


def _port_model(seed, **kw):
    cfg = ConvTasNetConfig(**{**SMALL, **kw})
    params, state = tm.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    return cfg, params, state


@pytest.mark.parametrize("use_kernels,norm_type,remat", [
    ("0", "gLN", False), ("hybrid", "gLN", False), ("whole", "cLN", False),
    ("0", "BN", "block"), ("0", "gLN", "dots")])
def test_graphed_steps_equal_eager_steps_bit_for_bit(record_only, use_kernels, norm_type,
                                                     remat):
    """The graphed step against the plain step rebinding its trees, in every
    training form: losses, parameters, moments and BN state, bit for bit."""
    cfg, params, state = _port_model(1, use_kernels=use_kernels, norm_type=norm_type,
                                     remat=remat)
    opt = to.Optimizer("adam", lr=1e-3)
    got = _run(cfg, opt, params, state, _batches(1), STEPS)
    assert record_only.captures == 1 and graphed.counts()["replays"] == STEPS - 2
    _assert_bits(got, _run(cfg, opt, params, state, _batches(1), STEPS, graph=False))


def test_exactly_one_update_per_call_including_the_capturing_call(record_only):
    """opt_state.step and the parameters after every call equal the eager
    run's after as many steps; the static trees keep their addresses."""
    cfg, params, state = _port_model(2)
    opt = to.Optimizer("sgd", lr=0.1, momentum=0.9)
    batches = _batches(2)
    _, p0, o0, _, step = _run(cfg, opt, params, state, batches, 0)
    ptrs = [t.data_ptr() for t in step._static]
    for n in range(1, STEPS + 1):
        mix, src, lens = (torch.from_numpy(a) for a in batches[(n - 1) % 2])
        p, o, s, _, _ = step(p0, o0, {}, mix, src, lens)
        assert p is step.params and o is step.opt_state and s is step.state
        assert int(o.step) == n
        want = _run(cfg, opt, params, state, batches, n, graph=False)
        assert all(torch.equal(a, b) for a, b in zip(to.tree_leaves(p),
                                                     to.tree_leaves(want[1])))
    assert record_only.warm_ups == record_only.captures == 1
    assert [t.data_ptr() for t in step._static] == ptrs


@pytest.mark.parametrize("how", ["set_lr", "new tensor"])
def test_a_new_lr_reaches_replays(record_only, how):
    """set_lr writes the device scalar the captured step reads; a state
    carrying a new lr tensor is copied into it. Either way the replays
    after it step at the new rate, as the eager steps do."""
    cfg, params, state = _port_model(3)
    opt = to.Optimizer("sgd", lr=0.1)
    batches = _batches(3)
    runs = []
    for graph in (True, False):
        p = to.tree_map(lambda t: t.clone(), params)
        o = opt.init(p)
        step = make_train_step(cfg, opt, 5.0)
        if graph:
            step = GraphedStep(step, p, o, state)
        ptr, losses = o.lr.data_ptr(), []
        for i in range(6):
            if i == 3:
                o = (to.set_lr(o, float(o.lr) / 2) if how == "set_lr"
                     else o._replace(lr=torch.tensor(0.05)))
                assert float(o.lr) == np.float32(0.05)
                assert (o.lr.data_ptr() == ptr) is (how == "set_lr")
            mix, src, lens = (torch.from_numpy(a) for a in batches[i % 2])
            p, o, _, loss, _ = step(p, o, state, mix, src, lens)
            losses.append(loss)
        if graph:  # the static rate keeps its address
            assert o is step.opt_state and o.lr.data_ptr() == ptr
        runs.append((losses, p, o))
    assert graphed.counts()["replays"] == 4  # calls 3-6, two of them after the change
    assert torch.equal(torch.stack(runs[0][0]), torch.stack(runs[1][0]))
    for a, b in zip(to.tree_leaves(runs[0][1]), to.tree_leaves(runs[1][1])):
        assert torch.equal(a, b)


def test_a_smaller_last_batch_is_a_key_of_its_own(record_only):
    """Batches of 2 and a last batch of 1 (an epoch's tail): two keys, each
    captured at its second call, bit for bit against eager."""
    cfg, params, state = _port_model(4)
    opt = to.Optimizer("adam", lr=1e-3)
    batches = [_batches(4)[0], _batches(5, M=1)[0]] * 3
    got = _run(cfg, opt, params, state, batches, len(batches))
    assert len(got[4].graphed.graphs()) == 2 and record_only.captures == 2
    assert got[4].graphed.stats()["keys"] == 2
    assert graphed.counts() == {**graphed.counts(), "eager_calls": 2, "captures": 2,
                                "replays": 2}
    _assert_bits(got, _run(cfg, opt, params, state, batches, len(batches), graph=False))


def test_beyond_the_cap_a_key_stays_eager_and_updates_the_static_trees(record_only,
                                                                     monkeypatch):
    monkeypatch.setattr(graphed, "MAX_GRAPHS", 1)
    cfg, params, state = _port_model(5)
    opt = to.Optimizer("adam", lr=1e-3)
    batches = [_batches(6)[0], _batches(7, M=1)[0]] * 3
    got = _run(cfg, opt, params, state, batches, len(batches))
    step = got[4]
    assert record_only.captures == 1 and len(step.graphed.graphs()) == 1
    # The batch-2 key: eager, capture, replay; the batch-1 key: eager thrice,
    # sent eager for good (over the cap) at its second call.
    assert step.graphed.calls == {"eager_calls": 4, "captures": 1, "replays": 1, "over_cap": 1}
    assert got[1] is step.params and int(step.opt_state.step) == len(batches)
    _assert_bits(got, _run(cfg, opt, params, state, batches, len(batches), graph=False))


def test_a_failing_capture_raises_with_the_key_and_never_retries(record_only):
    """The capture fails after its warm-up (that call's one update):
    GraphError names the key, and the key is never run again."""
    cfg, params, state = _port_model(6, use_kernels="hybrid")
    step = GraphedStep(make_train_step(cfg, to.Optimizer("adam"), 5.0), params,
                       to.Optimizer("adam").init(params), state,
                       tag=(cfg.kernel_form(True, "cpu"),))
    mix, src, lens = (torch.from_numpy(a) for a in _batches(6)[0])
    step(step.params, step.opt_state, state, mix, src, lens)
    record_only.fail = True
    with pytest.raises(graphed.GraphError, match=r"capture of key .*\(2, 640\).*whole_tcn_train"):
        step(step.params, step.opt_state, state, mix, src, lens)
    record_only.fail = False
    with pytest.raises(graphed.GraphError, match="failed before"):
        step(step.params, step.opt_state, state, mix, src, lens)
    assert record_only.captures == 0 and step.graphed.calls["eager_calls"] == 1
    assert int(step.opt_state.step) == 2


# ---------------------------------------------------------------------------
# The Solver and the train CLI through the graphed steps
# ---------------------------------------------------------------------------

NET = ["--N", "16", "--L", "8", "--B", "16", "--H", "32", "--X", "2", "--R", "2",
       "--compute_dtype", "float32", "--device", "cpu", "--num_workers", "1",
       "--print_freq", "1", "--segment", "0.5", "--batch_size", "2"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("wav")
    return make_wav_dataset(str(root), n_utts=5, min_sec=0.6, max_sec=1.0, seed=8,
                            splits=("tr", "cv"))


def _train(data, folder, monkeypatch, graph, *extra):
    """The train CLI on the CPU, its steps graphed through the stand-in or
    (graph=False) all eager; returns its result."""
    graphed.reset_counts()
    if graph:
        monkeypatch.setattr(graphed, "backend_for", lambda device: RecordOnly())
    else:
        monkeypatch.setattr(graphed, "MAX_GRAPHS", 0)
    try:
        return train_main(["--train_dir", os.path.join(data, "tr"), "--valid_dir",
                           os.path.join(data, "cv"), "--save_folder", str(folder), *NET,
                           "--use_kernels", "hybrid", *extra])
    finally:
        monkeypatch.undo()


def _params(path):
    return {k: v for k, v in load_checkpoint(path)["arrays"].items()
            if not k.startswith("header")}


def _same_runs(got, want, folder_got, folder_want, names):
    assert got["tr_loss"] == want["tr_loss"] and got["cv_loss"] == want["cv_loss"]
    for name in names:
        a, b = _params(os.path.join(folder_got, name)), _params(os.path.join(folder_want, name))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}: {k}")


def test_train_cli_graphed_equals_eager_with_continue_and_mid_epoch_resume(
        data, tmp_path, monkeypatch):
    """Two epochs with --save_every_steps 1, then --continue_from
    epoch1.ckpt, then a resume from a mid-epoch latest.ckpt: each graphed
    run against the same run all eager, losses and checkpoints bit for
    bit; the graphed runs replay both steps."""
    runs = {}
    for graph in (True, False):
        d = tmp_path / ("graphed" if graph else "eager")
        full = _train(data, d / "full", monkeypatch, graph, "--epochs", "2", "--checkpoint",
                      "1", "--save_every_steps", "1")
        cont = _train(data, d / "cont", monkeypatch, graph, "--epochs", "2", "--checkpoint",
                      "1", "--continue_from", str(d / "full" / "epoch1.ckpt"))
        _train(data, d / "cut", monkeypatch, graph, "--epochs", "1", "--save_every_steps", "3")
        assert load_checkpoint(str(d / "cut" / "latest.ckpt"))["header"]["extra"][
            "step_in_epoch"] == 3
        resumed = _train(data, d / "resumed", monkeypatch, graph, "--epochs", "2",
                         "--checkpoint", "1", "--continue_from", str(d / "cut" / "latest.ckpt"))
        runs[graph] = (d, full, cont, resumed)
    (dg, *g), (de, *e) = runs[True], runs[False]
    for name, a, b, ckpts in (("full", g[0], e[0], ("epoch1.ckpt", "epoch2.ckpt", "latest.ckpt")),
                              ("cont", g[1], e[1], ("epoch2.ckpt",)),
                              ("resumed", g[2], e[2], ("epoch2.ckpt", "final.ckpt"))):
        _same_runs(a, b, dg / name, de / name, ckpts)
    np.testing.assert_allclose(g[2]["tr_loss"], g[0]["tr_loss"], rtol=1e-6)
    train, cv = g[0]["graphs"]["train_step"], g[0]["graphs"]["cv_step"]
    assert train["captures"] >= 1 and train["replays"] >= 1 and cv["replays"] >= 1
    assert train["eager_calls"] + train["captures"] + train["replays"] == g[0]["steps"]
    assert train["over_cap"] == cv["over_cap"] == 0
    assert e[0]["graphs"]["train_step"]["eager_calls"] == e[0]["steps"]
    log = open(dg / "full" / "train.log").read()
    assert "Graphs | End of Epoch 1" in log and "train_step graphs:" in log


def _solver(data, folder, **kw):
    cfg = ConvTasNetConfig(N=16, L=8, B=16, H=32, X=2, R=2, compute_dtype="float32",
                           use_kernels="hybrid")
    tcfg = TrainConfig(save_folder=str(folder), batch_size=2, segment=0.5, print_freq=100,
                       **kw)
    tr = DataLoader(AudioDataset(os.path.join(data, "tr"), 2, segment=0.5))
    cv = DataLoader(AudioDataset(os.path.join(data, "cv"), 1, segment=-1))
    model = tm.ConvTasNet(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return Solver(model, tcfg, tr, cv, log=lambda s: None)


def test_kept_losses_survive_later_replays(data, tmp_path, monkeypatch):
    """--visualize keeps each step's device loss until a read-back point:
    the graphed run's per-iteration losses equal the eager run's."""
    hist = {}
    for graph in (True, False):
        if graph:
            monkeypatch.setattr(graphed, "backend_for", lambda device: RecordOnly())
        solver = _solver(data, tmp_path / str(graph), epochs=2, visualize=True)
        solver._plot = lambda *a: None
        solver.train()
        hist[graph] = [h["loss"] for h in solver.iter_history]
        if graph:
            assert solver.graph_counts()["train_step"]["replays"] >= 3
        monkeypatch.undo()
    assert len(set(hist[True])) == len(hist[True]) == len(hist[False]) >= 6
    assert hist[True] == hist[False]


CV_SCRIPT = [5.0, 4.0, 4.5, 4.6, 4.7, 3.0, 3.1, 3.2, 3.3, 3.4, 3.5]


def test_lr_halving_schedule_reaches_the_graphed_step(data, tmp_path, monkeypatch):
    """tests/test_torch_solver.py's scripted CV losses, with one real train
    step per epoch through the graphed step: the rate of every epoch's
    history, the step's lr tensor (same address throughout) and the
    parameters bit for bit against the same run all eager."""
    runs = {}
    for graph in (True, False):
        if graph:
            monkeypatch.setattr(graphed, "backend_for", lambda device: RecordOnly())
        solver = _solver(data, tmp_path / str(graph), epochs=len(CV_SCRIPT), half_lr=True,
                         optimizer="sgd", lr=0.1)
        batch = solver.tr_loader.dataset.load_batch(0)
        ptr = solver.opt_state.lr.data_ptr()
        seen = []

        def epoch(e, cross_valid, solver=solver, batch=batch, seen=seen):
            if cross_valid:
                return CV_SCRIPT[e], 0.0
            mix, lens, src = solver._to_device(batch)
            solver.params, solver.opt_state, solver.state, loss, _ = solver.train_step(
                solver.params, solver.opt_state, solver.state, mix, src, lens)
            seen.append(float(solver.opt_state.lr))
            return float(loss), 0.0

        solver._run_one_epoch = epoch
        hist = solver.train()["history"]
        assert solver.opt_state.lr.data_ptr() == ptr
        runs[graph] = (hist, seen, solver)
        monkeypatch.undo()
    (hg, sg, g), (he, se, e) = runs[True], runs[False]
    lrs = [h["lr"] for h in hg]
    assert lrs == [h["lr"] for h in he] and sg == se and min(lrs) < 0.1
    assert g.graph_counts()["train_step"]["replays"] == len(CV_SCRIPT) - 2
    for a, b in zip(to.tree_leaves(g.params), to.tree_leaves(e.params)):
        assert torch.equal(a, b)


def test_a_mesh_keeps_the_eager_steps(data, tmp_path):
    """Under a mesh (here one gloo rank) the Solver's steps are the plain
    ones and graph_counts() is None; without one they are graphed."""
    distributed.initialize(f"file://{tmp_path}/store", 1, 0, device_type="cpu")
    try:
        solver = _solver(data, tmp_path / "mesh", epochs=1)
        meshed = Solver(solver.model, solver.cfg, solver.tr_loader, solver.cv_loader,
                        log=lambda s: None, mesh=make_mesh(device="cpu"))
        assert not isinstance(meshed.train_step, GraphedStep)
        assert not hasattr(meshed.eval_step, "graphed") and meshed.graph_counts() is None
        assert isinstance(solver.train_step, GraphedStep)
        assert set(solver.graph_counts()) == {"train_step", "cv_step"}
    finally:
        distributed.shutdown()
