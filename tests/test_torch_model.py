"""convtasnet_torch.forward against convtasnet_tpu.forward (f32, CPU).

JAX parameters from convtasnet_tpu.init_params are carried across with
params_from_jax; mixtures come from numpy. Tolerances: rtol 5e-4 /
atol 5e-5, those of tests/test_pallas_tcn.py."""

import jax
import numpy as np
import pytest
import torch

import convtasnet_tpu
from convtasnet_torch.config import ConvTasNetConfig
from convtasnet_torch.models import conv_tasnet as tm
from convtasnet_torch.ops.kernels import tcn_block

torch.set_num_threads(1)
TOL = dict(rtol=5e-4, atol=5e-5)
SMALL = dict(N=32, L=16, B=16, H=32, P=3, X=3, R=2, compute_dtype="float32")


def _setup(seed, M=3, T=400, **kw):
    jcfg = convtasnet_tpu.ConvTasNetConfig(use_pallas=False, **SMALL, **kw)
    params, state = convtasnet_tpu.init_params(jax.random.key(seed), jcfg)
    p_np = jax.tree_util.tree_map(np.asarray, params)
    s_np = jax.tree_util.tree_map(np.asarray, state)
    mix = np.random.default_rng(seed).normal(size=(M, T)).astype(np.float32)
    tp, ts = tm.params_from_jax(p_np, s_np, "cpu")
    return jcfg, params, state, tp, ts, mix


MATRIX = [(n, c, m, C) for n in ("gLN", "cLN", "BN") for c in (False, True)
          for m in ("relu", "softmax") for C in (2, 3)]


@pytest.mark.parametrize("norm_type,causal,mask,C", MATRIX)
def test_forward_matches_jax(norm_type, causal, mask, C):
    kw = dict(norm_type=norm_type, causal=causal, mask_nonlinear=mask, C=C)
    jcfg, params, state, tp, ts, mix = _setup(len(MATRIX) + C, **kw)
    train = norm_type == "BN"  # BN: train mode, running stats must agree
    want, wstate = convtasnet_tpu.forward(params, state, jcfg, jax.numpy.asarray(mix),
                                          train=train)
    cfg = ConvTasNetConfig(use_kernels=0, **SMALL, **kw)
    got, gstate = tm.forward(tp, ts, cfg, torch.from_numpy(mix), train=train)
    assert got.shape == (3, C, 400) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if train:
        for k, v in wstate["blocks"].items():
            np.testing.assert_allclose(gstate["blocks"][k].numpy(), np.asarray(v),
                                       **TOL, err_msg=k)


@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("cLN", True)])
@pytest.mark.parametrize("form", ["auto", "block"])
def test_kernel_forms_on_cpu_match_jax_kernels(norm_type, causal, form):
    """use_kernels auto/block on CPU tensors (the kernels' plain versions)
    against JAX use_pallas=True (whole_tcn_pallas in interpret mode)."""
    jcfg, params, state, tp, ts, mix = _setup(7, M=2, norm_type=norm_type,
                                              causal=causal)
    jk = convtasnet_tpu.ConvTasNetConfig(use_pallas=True, norm_type=norm_type,
                                         causal=causal, **SMALL)
    want, _ = convtasnet_tpu.forward(params, state, jk, jax.numpy.asarray(mix))
    cfg = ConvTasNetConfig(use_kernels=form, norm_type=norm_type, causal=causal,
                           **SMALL)
    assert cfg.kernel_form == ("whole_tcn" if form == "auto" else "whole_block")
    tcn_block.reset_counts()
    got, _ = tm.forward(tp, ts, cfg, torch.from_numpy(mix))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sum(tcn_block.counts().values()) == 0  # CPU: no kernel launched


def test_bn_always_eager():
    cfg = ConvTasNetConfig(use_kernels="auto", norm_type="BN", **SMALL)
    assert cfg.kernel_form == "eager"


def test_module_wraps_functional_forward():
    jcfg, params, state, tp, ts, mix = _setup(3, norm_type="BN")
    cfg = ConvTasNetConfig(norm_type="BN", **SMALL)
    model = tm.ConvTasNet(cfg, tp, ts, device="cpu").eval()
    assert model.num_params() == sum(np.asarray(v).size
                                     for v in jax.tree_util.tree_leaves(params))
    assert dict(model.named_parameters())["separator.blocks.in_w"].shape == (2, 3, 16, 32)
    want, _ = convtasnet_tpu.forward(params, state, jcfg, jax.numpy.asarray(mix))
    with torch.inference_mode():
        got = model(torch.from_numpy(mix))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_params_matches_jax_structure_and_scale():
    cfg = ConvTasNetConfig(**SMALL)
    tp, ts = tm.init_params(torch.Generator().manual_seed(0), cfg)
    jp, _ = convtasnet_tpu.init_params(
        jax.random.key(0), convtasnet_tpu.ConvTasNetConfig(**SMALL))
    flat_t = {k: v for k, v in _leaves(tp)}
    flat_j = {k: np.asarray(v) for k, v in _leaves(jp)}
    assert flat_t.keys() == flat_j.keys()
    for k in flat_t:
        assert tuple(flat_t[k].shape) == flat_j[k].shape, k
    # xavier std of in_w: sqrt(2 / (B + H)) for the torch shape [H, B, 1]
    std = float(flat_t["separator/blocks/in_w"].std())
    assert abs(std - np.sqrt(2 / 48)) < 0.02
    assert torch.all(flat_t["separator/blocks/in_prelu"] == 0.25)
    assert ts == {}


def test_default_device_requires_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.ConvTasNet(ConvTasNetConfig(**SMALL))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v
