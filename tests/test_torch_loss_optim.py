"""convtasnet_torch.ops.loss and training.optim against the JAX package
(f32, CPU; inputs from numpy). Tolerances: rtol 5e-4 / atol 5e-5 on values,
rtol 2e-3 / atol 5e-4 on gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_torch.ops import loss as tl
from convtasnet_torch.training import optim as to
from convtasnet_tpu.ops import loss as jl
from convtasnet_tpu.training import optim as jo

FWD = dict(rtol=5e-4, atol=5e-5)
GRAD = dict(rtol=2e-3, atol=5e-4)


def _batch(seed, C, lengths, T=400):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(len(lengths), C, T)).astype(np.float32)
    est = (src[:, ::-1] * 0.7 + rng.normal(size=src.shape) * 0.5).astype(np.float32)
    return src, est, np.array(lengths, np.int32)


@pytest.mark.parametrize("method", ["direct", "gram"])
@pytest.mark.parametrize("C,lengths", [(2, [400, 333, 250]), (3, [400, 120]),
                                       (2, [400, 0, 310])])
def test_cal_loss_and_grad_match_jax(method, C, lengths):
    """Loss, per-utterance SNR, masked and reordered estimates, and
    d(loss)/d(estimate), with padded lengths and a zero-length row."""
    src, est, lens = _batch(C + len(lengths), C, lengths)
    jout = jl.cal_loss(jnp.asarray(src), jnp.asarray(est), jnp.asarray(lens), method)
    jgrad = jax.grad(lambda e: jl.cal_loss(jnp.asarray(src), e, jnp.asarray(lens),
                                           method)[0])(jnp.asarray(est))
    e = torch.from_numpy(est.copy()).requires_grad_(True)
    tout = tl.cal_loss(torch.from_numpy(src), e, torch.from_numpy(lens), method)
    for name, a, b in zip(("loss", "max_snr", "masked", "reordered"), tout, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **FWD, err_msg=name)
    (tgrad,) = torch.autograd.grad(tout[0], e)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **GRAD)


@pytest.mark.parametrize("C", [2, 3])
def test_si_snr_with_pit_perm_matches_jax(C):
    src, est, lens = _batch(11 + C, C, [400, 380])
    jsnr, jperm, _ = jl.si_snr_with_pit(jnp.asarray(src), jnp.asarray(est), jnp.asarray(lens))
    tsnr, tperm, _ = tl.si_snr_with_pit(torch.from_numpy(src), torch.from_numpy(est),
                                        torch.from_numpy(lens))
    np.testing.assert_allclose(tsnr.numpy(), np.asarray(jsnr), **FWD)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tl.perm_matrix(C), jl.perm_matrix(C))


def _tree(rng):
    f = np.float32
    return {"a": {"w": rng.normal(size=(4, 3)).astype(f), "b": rng.normal(size=(3,)).astype(f)},
            "c": rng.normal(size=(2, 2, 2)).astype(f)}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


OPTS = [dict(kind="adam"), dict(kind="adam", weight_decay=0.1),
        dict(kind="sgd", lr=0.05), dict(kind="sgd", lr=0.05, momentum=0.9),
        dict(kind="sgd", lr=0.05, momentum=0.9, weight_decay=0.01)]


@pytest.mark.parametrize("kw", OPTS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_optimizer_three_updates_match_jax(kw, max_norm):
    """Three clipped updates (clip active at max_norm 0.5, inactive at 100)
    with a set_lr between the second and third: parameters, state leaves
    and gradient norms against the JAX Optimizer."""
    rng = np.random.default_rng(3)
    p_np = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jopt, topt = jo.Optimizer(**kw), to.Optimizer(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    tp = to.tree_map(torch.from_numpy, p_np)
    js, ts = jopt.init(jp), topt.init(tp)
    for i, g in enumerate(grads):
        if i == 2:
            js, ts = jo.set_lr(js, 0.5 * float(js.lr)), to.set_lr(ts, 0.5 * float(ts.lr))
        jg, jn = jo.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g), max_norm)
        tg, tn = to.clip_by_global_norm(to.tree_map(torch.from_numpy, g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), **FWD)
        jp, js = jopt.update(jg, js, jp)
        tp, ts = topt.update(tg, ts, tp)
    for (k, a), (_, b) in zip(_leaves(to.tree_map(lambda t: t.numpy(), tp)), _leaves(jp)):
        np.testing.assert_allclose(a, b, **FWD, err_msg=k)
    assert int(ts.step) == int(js.step) == 3
    np.testing.assert_allclose(float(ts.lr), float(js.lr), rtol=1e-7)
    for part in ("mu", "nu"):
        tl_ = dict(_leaves(to.tree_map(lambda t: t.numpy(), getattr(ts, part))))
        jl_ = dict(_leaves(jax.tree_util.tree_map(np.asarray, getattr(js, part))))
        assert tl_.keys() == jl_.keys()
        for k in tl_:
            assert tl_[k].shape == jl_[k].shape, (part, k)
            np.testing.assert_allclose(tl_[k], jl_[k], **FWD, err_msg=f"{part}/{k}")
