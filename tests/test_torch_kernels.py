"""Plain versions of the TCN-block kernels against the TPU kernels.

`whole_tcn_reference` is held against `whole_tcn_pallas(fold_norm2=True)`
and `whole_block_reference` against `whole_block_pallas`, both run in
interpret mode on the CPU as the JAX package's own tests run them. The
CUDA kernels themselves run only on the card: tests/test_torch_cuda.py and
chip_smoke.py hold them against these plain versions there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_torch.ops.kernels import tcn_block
from convtasnet_torch.ops.kernels.whole_block import (whole_block,
                                                      whole_block_reference)
from convtasnet_torch.ops.kernels.whole_tcn import whole_tcn, whole_tcn_reference
from convtasnet_tpu.ops.pallas.fused_whole_block import whole_block_pallas
from convtasnet_tpu.ops.pallas.whole_tcn import whole_tcn_pallas

torch.set_num_threads(1)
TOL = dict(rtol=5e-4, atol=5e-5)
ORDER = ("in_w", "in_prelu", "in_gamma", "in_beta", "dw_w", "dw_prelu",
         "dw_gamma", "dw_beta", "out_w")
CASES = [(n, c, K) for n in ("gLN", "cLN") for c in (False, True) for K in (200, 256)]


def _blocks(rng, NB, B=16, H=32, P=3):
    f = np.float32
    return {
        "in_w": (rng.normal(size=(NB, B, H)) * 0.2).astype(f),
        "in_prelu": np.full((NB,), 0.25, f),
        "in_gamma": (rng.normal(size=(NB, H)) * 0.1 + 1).astype(f),
        "in_beta": (rng.normal(size=(NB, H)) * 0.1).astype(f),
        "dw_w": (rng.normal(size=(NB, P, H)) * 0.3).astype(f),
        "dw_prelu": np.full((NB,), 0.25, f),
        "dw_gamma": (rng.normal(size=(NB, H)) * 0.1 + 1).astype(f),
        "dw_beta": (rng.normal(size=(NB, H)) * 0.1).astype(f),
        "out_w": (rng.normal(size=(NB, H, B)) * 0.2).astype(f),
    }


def _args(bp, conv):
    return [conv(bp[k]) for k in ORDER]


@pytest.mark.parametrize("norm_type,causal,K", CASES)
def test_whole_tcn_reference_matches_pallas(norm_type, causal, K):
    rng = np.random.default_rng(K)
    X = 3
    bp = _blocks(rng, 2 * X)
    x = (rng.normal(size=(3, K, 16)) * 0.5).astype(np.float32)
    want = whole_tcn_pallas(jnp.asarray(x), *_args(bp, jnp.asarray), norm_type,
                            causal, X, interpret=True, fold_norm2=True)
    got = whole_tcn_reference(torch.from_numpy(x), *_args(bp, torch.as_tensor),
                              norm_type, causal, X)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("norm_type,causal,K", CASES)
def test_whole_block_reference_matches_pallas(norm_type, causal, K):
    rng = np.random.default_rng(K + 1)
    bp = {k: v[0] for k, v in _blocks(rng, 1).items()}
    x = (rng.normal(size=(3, K, 16)) * 0.5).astype(np.float32)
    d = 4
    want = whole_block_pallas(jnp.asarray(x), *_args(bp, jnp.asarray), norm_type,
                              d, causal, interpret=True)
    got = whole_block_reference(torch.from_numpy(x), *_args(bp, torch.as_tensor),
                                norm_type, d, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prepadded_valid_k_keeps_pad_rows_zero():
    """Pre-padded input with valid_k: pad rows come out exactly zero and the
    valid rows equal the unpadded call; the input is not modified."""
    rng = np.random.default_rng(5)
    bp = _blocks(rng, 4)
    x = torch.from_numpy((rng.normal(size=(2, 100, 16)) * 0.5).astype(np.float32))
    xp = torch.nn.functional.pad(x, (0, 0, 0, 28))
    before = xp.clone()
    args = _args(bp, torch.as_tensor)
    got = whole_tcn_reference(xp, *args, "gLN", False, 2, valid_k=100)
    want = whole_tcn_reference(x, *args, "gLN", False, 2)
    np.testing.assert_allclose(got[:, :100].numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
    assert torch.all(got[:, 100:] == 0)
    assert torch.equal(xp, before)


def test_cpu_tensors_take_the_plain_versions():
    """The wrappers send CPU tensors to the plain versions: same numbers,
    no launch counted."""
    rng = np.random.default_rng(9)
    bp = _blocks(rng, 2)
    x = torch.from_numpy((rng.normal(size=(2, 130, 16)) * 0.5).astype(np.float32))
    args = _args(bp, torch.as_tensor)
    tcn_block.reset_counts()
    got = whole_tcn(x, *args, "cLN", True, 2)
    assert torch.equal(got, whole_tcn_reference(x, *args, "cLN", True, 2))
    one = [a[0] for a in args]
    got = whole_block(x, *one, "gLN", 2, False)
    assert torch.equal(got, whole_block_reference(x, *one, "gLN", 2, False))
    assert tcn_block.counts() == {k: 0 for k in tcn_block.counts()}


def test_kernel_wrappers_reject_unsupported_widths():
    """A CUDA launch is refused for widths the kernels do not tile; the
    check runs before any device work, so it is exercised with meta
    tensors (the same code path as CUDA tensors)."""
    x = torch.empty((1, 128, 16), device="meta")
    with pytest.raises(ValueError, match="multiples of 128"):
        tcn_block.tcn_in_gemm(x, torch.empty((16, 32), device="meta"),
                              torch.empty((1,), device="meta"), "gLN")
