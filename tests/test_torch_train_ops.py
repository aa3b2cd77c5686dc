"""The port's training ops against the JAX package's custom VJPs (f32, CPU).

whole_tcn_train, whole_block_train and whole_block_hybrid take the plain
versions of their kernels on CPU tensors; the JAX ops run their Pallas
kernels in interpret mode, as tests/test_pallas_hybrid.py and
tests/test_pallas_whole_vjp.py run them. Inputs come from numpy; the
forward output, the saved residuals and the eleven gradients (dx and the
ten parameter gradients) are compared. Tolerances: rtol 5e-4 / atol 5e-5
on forwards, rtol 2e-3 / atol 5e-4 on gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_torch.ops.kernels import tcn_block
from convtasnet_torch.ops.kernels.whole_block_hybrid import whole_block_hybrid
from convtasnet_torch.ops.kernels.whole_block_vjp import whole_block_train
from convtasnet_torch.ops.kernels.whole_tcn import PLAIN_STAGES
from convtasnet_torch.ops.kernels.whole_tcn_hybrid import chain_save, whole_tcn_train
from convtasnet_tpu.ops.pallas import whole_block_hybrid as j_hybrid
from convtasnet_tpu.ops.pallas import whole_block_vjp as j_vjp
from convtasnet_tpu.ops.pallas import whole_tcn_hybrid as j_tcn
from convtasnet_tpu.ops.pallas.fused_whole_block import whole_block_pallas
from convtasnet_tpu.ops.pallas.whole_tcn import whole_tcn_pallas

torch.set_num_threads(1)
FWD = dict(rtol=5e-4, atol=5e-5)
GRAD = dict(rtol=2e-3, atol=5e-4)
B = H = 128
P = 3


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


def _check_grads(got, want):
    names = ["dx", "in_w", "in_prelu", "in_gamma", "in_beta", "dw_w", "dw_prelu",
             "dw_gamma", "dw_beta", "out_w"]
    assert len(got) == len(want) == 10
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.reshape(b.shape), b, **GRAD, err_msg=name)


TCN_CASES = [("gLN", False, 200), ("gLN", True, 256), ("cLN", False, 256), ("cLN", True, 200)]


@pytest.mark.parametrize("norm_type,causal,K", TCN_CASES)
def test_whole_tcn_train_matches_jax(norm_type, causal, K):
    """Forward output and the ten gradients of the whole-TCN training op
    (X=2, R=1: two chained blocks) against whole_tcn_train's custom VJP."""
    X, NB, Kp = 2, 2, 256
    ps, x, g = _inputs(K + 7, NB, K, Kp)
    vk = K if K != Kp else None
    want, wgrads = _jax_grads(
        lambda *a: j_tcn.whole_tcn_train(*a, norm_type, causal, X, True, vk), x, ps, g)
    got, ggrads = _torch_grads(
        lambda *a: whole_tcn_train(*a, norm_type, causal, X, valid_k=K)[0], x, ps, g)
    np.testing.assert_allclose(got, want, **FWD)
    _check_grads(ggrads, wgrads)


@pytest.mark.parametrize("norm_type,causal,K", [("gLN", False, 200), ("cLN", True, 256)])
def test_whole_tcn_save_residuals_match_jax(norm_type, causal, K):
    """The residual-saving forward: out, every block's input x_nb and conv
    output c_nb against whole_tcn_pallas(save_residuals=True)."""
    X, NB, Kp = 3, 3, 256
    ps, x, _ = _inputs(K, NB, K, Kp)
    vk = K if K != Kp else None
    want = whole_tcn_pallas(jnp.asarray(x), *[jnp.asarray(p) for p in ps], norm_type, causal,
                            X, True, vk, save_residuals=True)
    out, x_res, c_res, _ = chain_save(torch.from_numpy(x), *[torch.from_numpy(p) for p in ps],
                                      norm_type, causal, X, K, PLAIN_STAGES)
    got = (out, x_res.transpose(0, 1), c_res.transpose(0, 1))  # to [M, NB, K_pad, ch]
    for name, a, b in zip(("out", "x_res", "c_res"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD, err_msg=name)


BLOCK_CASES = [("gLN", False, 2, 200), ("gLN", True, 1, 256), ("cLN", False, 4, 256),
               ("cLN", True, 8, 200), ("gLN", False, 128, 200)]


@pytest.mark.parametrize("norm_type,causal,dilation,K", BLOCK_CASES)
def test_whole_block_train_matches_jax(norm_type, causal, dilation, K):
    """The per-block recompute op against whole_block_train's custom VJP
    (its backward recomputes from x alone), up to the largest dilation."""
    Kp = 256
    ps, x, g = _inputs(dilation + K, 1, K, Kp)
    ps = [p[0] for p in ps]
    vk = K if K != Kp else None
    want, wgrads = _jax_grads(
        lambda *a: j_vjp.whole_block_train(*a, norm_type, dilation, causal, True, vk),
        x, ps, g)
    got, ggrads = _torch_grads(
        lambda *a: whole_block_train(*a, norm_type, dilation, causal, valid_k=K), x, ps, g)
    np.testing.assert_allclose(got, want, **FWD)
    _check_grads(ggrads, wgrads)


@pytest.mark.parametrize("norm_type,causal,dilation,K", BLOCK_CASES)
def test_whole_block_hybrid_matches_jax(norm_type, causal, dilation, K):
    """The per-block hybrid op against whole_block_hybrid's custom VJP, and
    its saved y1 / c against whole_block_pallas(save_residuals=True)."""
    Kp = 256
    ps, x, g = _inputs(dilation + K + 1, 1, K, Kp)
    ps = [p[0] for p in ps]
    vk = K if K != Kp else None
    want, wgrads = _jax_grads(
        lambda *a: j_hybrid.whole_block_hybrid(*a, norm_type, dilation, causal, True, vk),
        x, ps, g)
    got, ggrads = _torch_grads(
        lambda *a: whole_block_hybrid(*a, norm_type, dilation, causal, valid_k=K), x, ps, g)
    np.testing.assert_allclose(got, want, **FWD)
    _check_grads(ggrads, wgrads)
    # The saved residuals: y1 from K1, c from K2 in save mode.
    _, jy1, jc = whole_block_pallas(jnp.asarray(x), *[jnp.asarray(p) for p in ps], norm_type,
                                    dilation, causal, True, vk, save_residuals=True)
    tx, tp = torch.from_numpy(x), [torch.from_numpy(np.array(p)) for p in ps]
    y1, s1 = tcn_block.tcn_in_gemm(tx, tp[0], tp[1], norm_type)
    _, _, c = tcn_block.tcn_dwconv(y1, s1, tp[1], tp[2], tp[3], tp[4], tp[5], norm_type,
                                   dilation, causal, K, save=True)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), **FWD)
    np.testing.assert_allclose(c.numpy()[:, :K], np.asarray(jc)[:, :K], **FWD)
