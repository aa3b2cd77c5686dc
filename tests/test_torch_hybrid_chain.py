"""The per-block hybrid form as one autograd Function over the chain
(whole_chain_hybrid), on the CPU (f32, small widths).

- whole_chain_hybrid against the JAX package's whole_block_hybrid run
  block after block over stacked weights under jax.vjp (Pallas forward in
  interpret mode, plain XLA backward), and against the per-block op it
  replaces in the model; its saved y1 / c against the per-block op's;
- the model's `hybrid` training forward past the memory gate (the budget
  lowered inside the test): it takes the `whole` chain, which saves less
  than the whole-TCN op; the gradient of each stacked block leaf comes
  from one node of that chain Function, through views only (no per-block
  select), and the gradients match the JAX model's, which takes its own
  per-block hybrid form when the whole-TCN kernel does not fit the TPU's
  VMEM (forced inside the test the same way).

Tolerances: rtol 5e-4 / atol 5e-5 on forwards and losses, rtol 2e-3 /
atol 5e-4 on gradients (tests/test_pallas_tcn.py's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convtasnet_tpu
from convtasnet_torch.config import ConvTasNetConfig
from convtasnet_torch.models import conv_tasnet as tm
from convtasnet_torch.ops.kernels import tcn_block as tb
from convtasnet_torch.ops.kernels.whole_block_hybrid import whole_block_hybrid, whole_chain_hybrid
from convtasnet_torch.ops.kernels.whole_block_vjp import _WholeChainTrain
from convtasnet_torch.ops.kernels.whole_tcn_hybrid import chain_forward
from convtasnet_torch.ops.loss import cal_loss
from convtasnet_torch.training import optim as to
from convtasnet_tpu.ops.pallas import whole_block_hybrid as j_hybrid
from convtasnet_tpu.ops.pallas import whole_tcn as j_whole_tcn

torch.set_num_threads(1)
FWD = dict(rtol=5e-4, atol=5e-5)
GRAD = dict(rtol=2e-3, atol=5e-4)
B = H = 128
P = 3
NORM_CAUSAL = [("gLN", False), ("gLN", True), ("cLN", False), ("cLN", True)]
GRAD_NAMES = ("dx", "in_w", "in_prelu", "in_gamma", "in_beta", "dw_w", "dw_prelu",
              "dw_gamma", "dw_beta", "out_w")


def _params(rng, NB):
    f = np.float32
    return [
        (rng.normal(size=(NB, B, H)) * 0.15).astype(f),          # in_w
        np.full((NB,), 0.25, f),                                 # in_prelu
        (rng.normal(size=(NB, H)) * 0.2 + 1).astype(f),          # in_gamma
        (rng.normal(size=(NB, H)) * 0.1).astype(f),              # in_beta
        (rng.normal(size=(NB, P, H)) * 0.3).astype(f),           # dw_w
        np.full((NB,), -0.1, f),                                 # dw_prelu: sign flips
        (rng.normal(size=(NB, H)) * 0.2 + 1).astype(f),          # dw_gamma
        (rng.normal(size=(NB, H)) * 0.1).astype(f),              # dw_beta
        (rng.normal(size=(NB, H, B)) * 0.15).astype(f),          # out_w
    ]


def _inputs(seed, NB, K, Kp, M=2):
    rng = np.random.default_rng(seed)
    ps = _params(rng, NB)
    x = np.zeros((M, Kp, B), np.float32)
    x[:, :K] = rng.normal(size=(M, K, B)) * 0.5
    g = np.zeros((M, Kp, B), np.float32)
    g[:, :K] = rng.normal(size=(M, K, B))
    return ps, x, g


def _jax_grads(fn, x, ps, g):
    out, vjp = jax.vjp(fn, jnp.asarray(x), *[jnp.asarray(p) for p in ps])
    return np.asarray(out), [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _torch_grads(fn, x, ps, g):
    leaves = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in [x] + list(ps)]
    out = fn(*leaves)
    return out.detach().numpy(), [v.numpy() for v in
                                  torch.autograd.grad(out, leaves, torch.from_numpy(g))]


def _jax_hybrid_chain(x, *ps, norm_type, causal, X, vk):
    """JAX's per-block hybrid form over stacked weights, block after block,
    as its scan over the repeats runs it (models/conv_tasnet.py:317-392)."""
    for nb in range(ps[0].shape[0]):
        x = j_hybrid.whole_block_hybrid(x, *[p[nb] for p in ps], norm_type, 2 ** (nb % X),
                                        causal, True, vk)
    return x


@pytest.mark.parametrize("norm_type,causal", NORM_CAUSAL)
def test_hybrid_chain_matches_jax(norm_type, causal):
    """Forward output and the ten gradients (x and the nine stacked leaves)
    of the chain op against JAX's per-block hybrid op under jax.vjp: X=2,
    R=2 (four blocks, two repeats)."""
    X, NB, Kp = 2, 4, 256
    K = 200 if causal else 256
    ps, x, g = _inputs(71 + 2 * causal + (norm_type == "cLN"), NB, K, Kp)
    vk = K if K != Kp else None
    want, wgrads = _jax_grads(
        lambda x, *p: _jax_hybrid_chain(x, *p, norm_type=norm_type, causal=causal, X=X,
                                        vk=vk), x, ps, g)
    got, ggrads = _torch_grads(
        lambda *a: whole_chain_hybrid(*a, norm_type, causal, X, valid_k=K), x, ps, g)
    np.testing.assert_allclose(got, want, **FWD)
    assert len(ggrads) == len(wgrads) == 10
    for name, a, b in zip(GRAD_NAMES, ggrads, wgrads):
        np.testing.assert_allclose(a.reshape(b.shape), b, **GRAD, err_msg=name)


@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("cLN", True)])
def test_hybrid_chain_matches_the_per_block_ops(norm_type, causal):
    """The chain op against the NB per-block Functions the model ran before
    it (views of the stacked leaves), on the same leaves: output and the
    ten gradients."""
    X, NB, Kp, K = 2, 4, 256, 200
    ps, x, g = _inputs(43, NB, K, Kp)

    def per_block(x, *leaves):
        for nb in range(NB):
            x = whole_block_hybrid(x, *[a[nb] for a in leaves], norm_type, 2 ** (nb % X),
                                   causal, valid_k=K)
        return x

    want, wgrads = _torch_grads(per_block, x, ps, g)
    got, ggrads = _torch_grads(
        lambda *a: whole_chain_hybrid(*a, norm_type, causal, X, valid_k=K), x, ps, g)
    np.testing.assert_allclose(got, want, **FWD)
    for name, a, b in zip(GRAD_NAMES, ggrads, wgrads):
        np.testing.assert_allclose(a, b, **FWD, err_msg=name)


def test_hybrid_chain_saves_what_the_per_block_ops_save():
    """The Function keeps block nb's input, y1 and c in slot nb of three
    [NB, ...] buffers, the same tensors the per-block op saves, and the
    nine parameter leaves themselves: no more bytes."""
    X, NB, Kp, K = 2, 3, 256, 200
    ps, x, _ = _inputs(5, NB, K, Kp)
    leaves = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in [x] + list(ps)]
    out = whole_chain_hybrid(*leaves, "gLN", False, X, valid_k=K)
    x_res, y1_res, c_res, *params = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in (x_res, y1_res, c_res)] == [(NB, 2, Kp, B),
                                                                (NB, 2, Kp, H)] + [(NB, 2, Kp, H)]
    assert all(p is leaf for p, leaf in zip(params, leaves[1:]))
    xin = leaves[0].detach()
    for nb in range(NB):
        blk = [p.detach()[nb] for p in leaves[1:]]
        assert torch.equal(x_res[nb], xin)
        y1, s1 = tb.in_gemm_plain(xin, blk[0], blk[1], "gLN")
        _, _, c = tb.dwconv_plain(y1, s1, *blk[1:6], "gLN", 2 ** (nb % X), False, K, save=True)
        assert torch.equal(y1_res[nb], y1) and torch.equal(c_res[nb], c)
        xin = whole_block_hybrid(xin, *blk, "gLN", 2 ** (nb % X), False, valid_k=K)
    assert torch.equal(out.detach(), xin)


def test_chain_forward_writes_y1_into_the_given_slots():
    """chain_forward with y1_res: K1's y1 of block nb lands in slot nb, and
    the output, x_res, c_res and s2 equal a run without it."""
    X, NB, Kp, K = 2, 3, 256, 230
    ps, x, _ = _inputs(9, NB, K, Kp)
    tx, tp = torch.from_numpy(x), [torch.from_numpy(p) for p in ps]
    y1_res = torch.full((NB, 2, Kp, H), float("nan"))
    a = chain_forward(tx, *tp, "cLN", True, X, K, y1_res=y1_res)
    b = chain_forward(tx, *tp, "cLN", True, X, K)
    for u, v in zip(a[:3], b[:3]):
        assert torch.equal(u, v)
    for u, v in zip(a[3], b[3]):
        assert torch.equal(u, v)
    assert not torch.isnan(y1_res).any()
    assert torch.equal(y1_res[0], tb.in_gemm_plain(tx, tp[0][0], tp[1][0], "cLN")[0])


# ---------------------------------------------------------------------------
# The model past the memory gate
# ---------------------------------------------------------------------------

SMALL = dict(N=16, L=4, B=128, H=128, P=3, X=2, R=2, C=2, compute_dtype="float32")
BLOCK_LEAVES = ("in_w", "in_prelu", "in_gamma", "in_beta", "dw_w", "dw_prelu", "dw_gamma",
                "dw_beta", "out_w")


def _leaves(tree, prefix=""):
    """(path, array) in sorted-key order, the order of to.tree_leaves."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


def _parents(root):
    """{node: [nodes whose next_functions hold it]} over the whole graph."""
    parents, stack, seen = {}, [root], {root}
    while stack:
        node = stack.pop()
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            parents.setdefault(nxt, []).append(node)
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return parents


@pytest.mark.parametrize("norm_type", ["gLN", "cLN"])
def test_model_hybrid_past_the_gate_runs_one_chain_node(monkeypatch, norm_type):
    """use_kernels="hybrid" with the budget at 1 KiB: the forward takes the
    `whole` chain (the gate's fallback), the graph holds one node of that
    chain Function, and each stacked block leaf's gradient reaches it
    through views alone (no SelectBackward, no index). Loss and every
    gradient leaf against the JAX model with use_pallas="hybrid" whose
    whole-TCN kernel is made not to fit VMEM, so that it takes its own
    fallback, the per-block hybrid form: the same gradients."""
    jcfg = convtasnet_tpu.ConvTasNetConfig(norm_type=norm_type, use_pallas="hybrid", **SMALL)
    params, state = convtasnet_tpu.init_params(jax.random.key(11), jcfg)
    rng = np.random.default_rng(11)
    M, T = 2, 402
    src = (rng.normal(size=(M, 2, T)) * 0.3).astype(np.float32)
    mix = src.sum(1)
    lens = np.array([T, T - 61], np.int32)
    monkeypatch.setattr(j_whole_tcn, "tcn_vmem_need", lambda *a, **k: 1 << 40)
    jmodel = convtasnet_tpu.ConvTasNet(jcfg)

    def jloss(p):
        est, _ = jmodel.apply(p, state, jnp.asarray(mix), train=True)
        return convtasnet_tpu.cal_loss(jnp.asarray(src), est, jnp.asarray(lens))[0]

    jl, jgrads = jax.value_and_grad(jloss)(params)

    cfg = ConvTasNetConfig(norm_type=norm_type, use_kernels="hybrid", **SMALL)
    monkeypatch.setattr(tm, "residual_budget", lambda device: 1024)
    assert tm.chain_form(cfg, True, M, 200, "cpu") == "whole_block_train"
    tp, ts = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                jax.tree_util.tree_map(np.asarray, state), "cpu")
    leaves_tree = to.tree_map(lambda p: p.clone().requires_grad_(True), tp)
    est, _ = tm.forward(leaves_tree, ts, cfg, torch.from_numpy(mix), train=True)
    loss = cal_loss(torch.from_numpy(src), est, torch.from_numpy(lens))[0]

    parents = _parents(loss.grad_fn)
    chain = [n for n in list(parents) + [loss.grad_fn]
             if type(n).__name__ == _WholeChainTrain.__name__ + "Backward"]
    assert len(chain) == 1
    blocks = leaves_tree["separator"]["blocks"]
    for k in BLOCK_LEAVES:
        acc = next(n for n in parents if type(n).__name__ == "AccumulateGrad"
                   and n.variable is blocks[k])
        path = [acc]
        while path[-1] is not chain[0]:
            ups = parents[path[-1]]
            assert len(ups) == 1, (k, [type(u).__name__ for u in ups])
            path.append(ups[0])
            assert len(path) < 5, k
        assert all(type(n).__name__.startswith(("View", "Reshape", "AccumulateGrad",
                                                "_WholeChain")) for n in path), k

    grads = torch.autograd.grad(loss, to.tree_leaves(leaves_tree))
    np.testing.assert_allclose(float(loss.detach()), float(jl), **FWD)
    jleaves = list(_leaves(jgrads))
    assert len(jleaves) == len(grads)
    for (k, want), got in zip(jleaves, grads):
        np.testing.assert_allclose(got.numpy(), want, **GRAD, err_msg=k)
