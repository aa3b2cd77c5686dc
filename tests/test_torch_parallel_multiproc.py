"""The port's DP, TP, CP and TP x CP paths in 2 and 4 gloo processes on the
CPU, against the JAX package on the same weights.

One module-scoped fixture per world size spawns the ranks once
(tests/torch_parallel_worker.py); they run every case of that world and
write npz files, and each test below compares one case: the forward, the
gradients of one train step (SGD at lr 1, so the parameter change is the
gradient) and a clipped step. References: the JAX single-device forward
and gradient on the same zero-row-padded batch and, under CP, the same
padded signal (the statistics include the padding, as JAX's own
cp_forward does), plus JAX's own sharded forward over the conftest's
virtual devices where it has one (CP: cp_forward; TP: the GSPMD forward).
Tolerances (f32): rtol 5e-4 / atol 5e-5 on forwards and losses, rtol
2e-3 / atol 5e-4 on gradients.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

import convtasnet_tpu
from convtasnet_tpu.models.conv_tasnet import forward as j_forward
from convtasnet_tpu.ops.loss import cal_loss as j_cal_loss
from convtasnet_tpu.parallel.context import cp_forward as j_cp_forward
from convtasnet_tpu.parallel.context import cp_padded_frames
from convtasnet_tpu.parallel.mesh import make_mesh as j_make_mesh
from convtasnet_tpu.parallel.mesh import shard_params_fn as j_shard_params_fn
from convtasnet_tpu.training.optim import clip_by_global_norm as j_clip

import torch_parallel_worker as worker

FWD = dict(rtol=5e-4, atol=5e-5)
GRAD = dict(rtol=2e-3, atol=5e-4)
TINY = dict(N=8, L=4, B=8, H=16, P=3, X=3, R=1, C=2, compute_dtype="float32")


def _case(name, mesh, train=True, M=2, K=64, **cfg):
    return {"name": name, "mesh": mesh, "train": train, "M": M, "K": K,
            "cfg": {**TINY, "use_kernels": "hybrid" if mesh[1:] == [1, 1] else "0", **cfg}}


CASES = {
    2: [
        _case("dp_gLN", [2, 1, 1], M=3),
        _case("dp_BN", [2, 1, 1], M=3, norm_type="BN"),
        _case("tp_gLN", [1, 2, 1]),
        _case("tp_cLN_causal", [1, 2, 1], norm_type="cLN", causal=True),
        _case("tp_softmax_C3", [1, 2, 1], mask_nonlinear="softmax", C=3),
        _case("tp_BN", [1, 2, 1], norm_type="BN", train=False),
        _case("cp_gLN", [1, 1, 2]),
        _case("cp_cLN_causal_K63", [1, 1, 2], K=63, norm_type="cLN", causal=True),
        _case("cp_cLN_short", [1, 1, 2], train=False, K=40, norm_type="cLN", X=5),
        # The eager chain under remat: the recompute issues the block's
        # collectives again in backward, and BN's state advances once.
        _case("tp_gLN_remat_dots", [1, 2, 1], remat="dots"),
        _case("cp_gLN_remat_block", [1, 1, 2], remat="block"),
        _case("dp_BN_remat_repeat", [2, 1, 1], M=3, norm_type="BN", use_kernels="0",
              remat="repeat"),
    ],
    4: [
        _case("cp4_gLN_K63", [1, 1, 4], train=False, K=63),
        _case("cp4_short", [1, 1, 4], train=False, K=64, X=5),
        _case("tpcp_gLN", [1, 2, 2]),
        _case("tpcp_cLN_causal", [1, 2, 2], norm_type="cLN", causal=True),
        _case("dptp_gLN", [2, 2, 1], M=3),
        _case("dpcp_gLN", [2, 1, 2], M=3),
    ],
}
BY_NAME = {c["name"]: (world, c) for world, cs in CASES.items() for c in cs}


def _jax_cfg(case):
    cfg = {k: v for k, v in case["cfg"].items() if k != "use_kernels"}
    return convtasnet_tpu.ConvTasNetConfig(**cfg)


def _inputs(case, seed):
    jcfg = _jax_cfg(case)
    params, state = convtasnet_tpu.init_params(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    T = (case["K"] - 1) * jcfg.stride + jcfg.L
    src = (rng.standard_normal((case["M"], jcfg.C, T)) * 0.3).astype(np.float32)
    mix = src.sum(1)
    lens = np.full(case["M"], T, np.int32)
    lens[-1] -= 2 * jcfg.stride
    return params, state, mix, src, lens


def _spawn(world, tmp_path_factory):
    out = str(tmp_path_factory.mktemp(f"world{world}"))
    data = {}
    for i, case in enumerate(CASES[world]):
        params, state, mix, src, lens = _inputs(case, i)
        data[case["name"]] = (params, state, mix, src, lens)
        arrays = {"mixture": mix, "source": src, "lengths": lens}
        arrays.update({f"params/{k}": v for k, v in worker.flat(
            jax.tree_util.tree_map(np.asarray, params)).items()})
        arrays.update({f"state/{k}": v for k, v in worker.flat(
            jax.tree_util.tree_map(np.asarray, state)).items()})
        np.savez(os.path.join(out, f"in_{case['name']}.npz"), **arrays)
    with open(os.path.join(out, "cases.json"), "w") as f:
        json.dump(CASES[world], f)
    codes = worker.run_ranks(world, worker.rank_main, (out,))
    errors = [open(os.path.join(out, e)).read() for e in sorted(os.listdir(out))
              if e.startswith("error_")]
    return {"dir": out, "codes": codes, "errors": errors, "data": data, "refs": {}}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(2, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(4, tmp_path_factory)


def _outputs(run, name, world):
    assert run["codes"] == [0] * world, (run["codes"], run["errors"])
    return [dict(np.load(os.path.join(run["dir"], f"out_{name}_r{r}.npz")))
            for r in range(world)]


def _padded(case, mix, src, lens):
    """The batch as the mesh pads it: zero rows to the dp multiple and,
    under CP, zeros to the padded signal length."""
    jcfg = _jax_cfg(case)
    dp, _, cp = case["mesh"]
    M, T = mix.shape
    M_pad = -(-M // dp) * dp
    T_pad = T
    if cp > 1:
        T_pad = max(T, (cp_padded_frames(jcfg, T, cp) - 1) * jcfg.stride + jcfg.L)
    mix = np.pad(mix, ((0, M_pad - M), (0, T_pad - T)))
    src = np.pad(src, ((0, M_pad - M), (0, 0), (0, 0)))
    lens = np.pad(lens, (0, M_pad - M))
    return mix, src, lens, T


def _jax_reference(run, name, train):
    """JAX single-device results on the padded batch, computed once per
    case: the eval forward's est [M, C, T], and with `train` the loss, the
    gradients and the new state of a training forward."""
    key = (name, train)
    if key in run["refs"]:
        return run["refs"][key]
    case = BY_NAME[name][1]
    jcfg = _jax_cfg(case)
    params, state, mix, src, lens = run["data"][name]
    pmix, psrc, plens, T = _padded(case, mix, src, lens)
    if not train:
        est, _ = jax.jit(lambda p, s, m: j_forward(p, s, jcfg, m))(
            params, state, jnp.asarray(pmix[: mix.shape[0]]))
        run["refs"][key] = np.asarray(est)[..., :T]
        return run["refs"][key]

    def loss_fn(p):
        e, new_state = j_forward(p, state, jcfg, jnp.asarray(pmix), train=True)
        loss, *_ = j_cal_loss(jnp.asarray(psrc), e[..., :T], jnp.asarray(plens))
        return loss, new_state

    (loss, new_state), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    run["refs"][key] = (float(loss), grads, new_state)
    return run["refs"][key]


def _assemble(case, outs, key):
    """The rows of every data rank (from its first TP / CP rank), in order."""
    first = [o for o in outs if o["coord"][1] == 0 and o["coord"][2] == 0]
    first.sort(key=lambda o: o["coord"][0])
    return np.concatenate([o[key] for o in first])


def _check_forward(run, name):
    world, case = BY_NAME[name]
    outs = _outputs(run, name, world)
    want = _jax_reference(run, name, False)
    got = _assemble(case, outs, "est")[: want.shape[0]]
    np.testing.assert_allclose(got, want, **FWD)
    for o in outs:  # every rank of a TP / CP group holds the same rows
        d = o["coord"][0]
        rows = o["est"].shape[0]
        ref = _assemble(case, outs, "est")[d * rows:(d + 1) * rows]
        np.testing.assert_allclose(o["est"], ref, **FWD)
    return want


def _check_step(run, name):
    world, case = BY_NAME[name]
    outs = _outputs(run, name, world)
    loss, grads, new_state = _jax_reference(run, name, True)
    gflat = worker.flat(jax.tree_util.tree_map(np.asarray, grads))
    clipped, norm = j_clip(grads, 1e-3)
    cflat = worker.flat(jax.tree_util.tree_map(np.asarray, clipped))
    for o in outs:  # every rank: the same global loss, gradients, state
        np.testing.assert_allclose(o["loss"], loss, **FWD)
        np.testing.assert_allclose(o["clip_gnorm"], float(norm), **FWD)
        for k, v in gflat.items():
            np.testing.assert_allclose(o[f"grad/{k}"], v, **GRAD, err_msg=k)
            np.testing.assert_allclose(o[f"clip_grad/{k}"], cflat[k], **GRAD, err_msg=k)
        for k, v in worker.flat(jax.tree_util.tree_map(np.asarray, new_state)).items():
            np.testing.assert_allclose(o[f"state/{k}"], v, **FWD, err_msg=k)
    return outs


def _jax_sharded_forward(case, data):
    """JAX's own sharded forward over the virtual devices (CP: cp_forward
    on a 'context' mesh; TP: the GSPMD forward on a ('data', 'model') mesh)."""
    jcfg = _jax_cfg(case)
    params, state, mix, _, _ = data
    _, tp, cp = case["mesh"]
    if cp > 1 and tp == 1:
        mesh = JMesh(np.array(jax.devices()[:cp]), ("context",))
        return np.asarray(j_cp_forward(params, state, jcfg, jnp.asarray(mix), mesh))
    mesh = j_make_mesh(dp=1, tp=tp, devices=jax.devices()[:tp])
    p, s, _ = j_shard_params_fn(mesh, tp)(params, state, None)
    est, _ = jax.jit(lambda p, s, m: j_forward(p, s, jcfg, m))(p, s, jnp.asarray(mix))
    return np.asarray(est)


FORWARD_2 = [c["name"] for c in CASES[2]]
STEP_2 = [c["name"] for c in CASES[2] if c["train"]]
FORWARD_4 = [c["name"] for c in CASES[4]]
STEP_4 = [c["name"] for c in CASES[4] if c["train"]]


@pytest.mark.parametrize("name", FORWARD_2)
def test_forward_world2(world2, name):
    _check_forward(world2, name)


@pytest.mark.parametrize("name", STEP_2)
def test_train_step_world2(world2, name):
    outs = _check_step(world2, name)
    dp, tp, cp = BY_NAME[name][1]["mesh"]
    if dp > 1 and BY_NAME[name][1]["cfg"].get("norm_type", "gLN") != "BN":
        # DP: the real-row count and the gradient bucket, nothing else.
        assert all(int(o["collectives"]) == 2 for o in outs)


@pytest.mark.parametrize("name", ["tp_gLN", "tp_softmax_C3", "tp_BN", "cp_cLN_causal_K63"])
def test_forward_world2_against_jax_sharded(world2, name):
    world, case = BY_NAME[name]
    outs = _outputs(world2, name, world)
    want = _jax_sharded_forward(case, world2["data"][name])
    np.testing.assert_allclose(_assemble(case, outs, "est"), want, **FWD)


@pytest.mark.parametrize("name", FORWARD_4)
def test_forward_world4(world4, name):
    _check_forward(world4, name)


@pytest.mark.parametrize("name", STEP_4)
def test_train_step_world4(world4, name):
    _check_step(world4, name)


@pytest.mark.parametrize("name", ["cp4_short"])
def test_forward_world4_against_jax_sharded(world4, name):
    world, case = BY_NAME[name]
    outs = _outputs(world4, name, world)
    want = _jax_sharded_forward(case, world4["data"][name])
    np.testing.assert_allclose(_assemble(case, outs, "est"), want, **FWD)


@pytest.mark.parametrize("plain,remat,per_block", [("tp_gLN", "tp_gLN_remat_dots", 4),
                                                   ("cp_gLN", "cp_gLN_remat_block", 6)])
def test_remat_reissues_collectives_world2(world2, plain, remat, per_block):
    """A remat step recomputes its blocks in backward, collectives
    included: per block the 2 norms' 2 statistics each and, under CP, the
    conv's 2 halo exchanges (TP: 44 -> 56 per step, CP: 41 -> 59 at X=3).
    The recompute stops before the block's TP output all-reduce, which
    backward does not need."""
    n0, n1 = (int(_outputs(world2, name, 2)[0]["collectives"]) for name in (plain, remat))
    assert n1 - n0 == per_block * TINY["X"] * TINY["R"], (n0, n1)
