"""convtasnet_torch streaming against convtasnet_tpu streaming (f32, CPU).

JAX parameters carried across with params_from_jax, the same numpy inputs
from a seed. Tolerances: rtol 5e-4 / atol 5e-5, those of
tests/test_pallas_tcn.py; the config is tests/test_streaming.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convtasnet_tpu
from convtasnet_torch.config import ConvTasNetConfig
from convtasnet_torch.models import conv_tasnet as tm
from convtasnet_torch.models import streaming as ts
from convtasnet_tpu.models import streaming as js

torch.set_num_threads(1)
TOL = dict(rtol=5e-4, atol=5e-5)
CAUSAL = dict(N=8, L=4, B=8, H=16, P=3, X=3, R=2, C=2, norm_type="cLN", causal=True,
              compute_dtype="float32")


def _setup(seed, **kw):
    jcfg = convtasnet_tpu.ConvTasNetConfig(use_pallas=False, **{**CAUSAL, **kw})
    params, state = convtasnet_tpu.init_params(jax.random.key(seed), jcfg)
    tp, tstate = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                    jax.tree_util.tree_map(np.asarray, state), "cpu")
    cfg = ConvTasNetConfig(use_kernels=0, **{**CAUSAL, **kw})
    return jcfg, params, state, cfg, tp, tstate


def _stream(sep, x, chunk):
    outs = [sep.push(torch.from_numpy(x[:, i: i + chunk])) for i in range(0, x.shape[1], chunk)]
    outs.append(sep.flush())
    return torch.cat(outs, dim=-1).numpy()


def _leaves_np(state):
    return [np.asarray(t) for t in ts.state_leaves(state)]


@pytest.mark.parametrize("mask,C", [("relu", 2), ("softmax", 3)])
def test_stream_step_matches_jax(mask, C):
    """First and steady chunk: the output and every state leaf."""
    jcfg, params, _, cfg, tp, _ = _setup(3, mask_nonlinear=mask, C=C)
    x = np.random.default_rng(3).standard_normal((2, 48)).astype(np.float32)
    jstate = js.init_stream_state(jcfg, batch=2)
    tstate = ts.init_stream_state(cfg, batch=2, device="cpu")
    for first, chunk in ((True, x[:, :24]), (False, x[:, 24:])):
        jout, jstate = js.stream_step(params, jstate, jcfg, jnp.asarray(chunk), first=first)
        tout, tstate = ts.stream_step(tp, tstate, cfg, torch.from_numpy(chunk), first=first)
        assert tout.shape == jout.shape and tout.dtype == torch.float32
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        want = _leaves_np(jstate)
        got = _leaves_np(tstate)
        assert len(got) == len(want) == 2 + jcfg.R * jcfg.X
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, i
            np.testing.assert_allclose(g, w, **TOL, err_msg=f"state leaf {i}")


def test_streamed_matches_offline_port_and_jax(rng):
    jcfg, params, state, cfg, tp, tstate = _setup(0)
    T = 256
    x = rng.standard_normal((1, T)).astype(np.float32)
    streamed = _stream(ts.StreamingSeparator(cfg, tp, batch=1, device="cpu"), x, 64)
    T_conv = (cfg.num_frames(T) - 1) * cfg.stride + cfg.L
    assert streamed.shape == (1, cfg.C, T_conv)
    port, _ = tm.forward(tp, tstate, cfg, torch.from_numpy(x))
    jax_out, _ = convtasnet_tpu.forward(params, state, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(streamed, port.numpy()[..., :T_conv], **TOL)
    np.testing.assert_allclose(streamed, np.asarray(jax_out)[..., :T_conv], **TOL)


def test_chunk_sizes_agree(rng):
    _, _, _, cfg, tp, _ = _setup(1)
    x = rng.standard_normal((2, 192)).astype(np.float32)

    def run(chunk):
        return _stream(ts.StreamingSeparator(cfg, tp, batch=2, device="cpu"), x, chunk)

    np.testing.assert_allclose(run(32), run(96), **TOL)


def test_batch4_matches_each_stream_alone(rng):
    _, _, _, cfg, tp, tstate = _setup(4)
    T = 256
    x = rng.standard_normal((4, T)).astype(np.float32) * 0.5
    together = _stream(ts.StreamingSeparator(cfg, tp, batch=4, device="cpu"), x, 32)
    for b in range(4):
        alone = _stream(ts.StreamingSeparator(cfg, tp, batch=1, device="cpu"), x[b:b + 1], 32)
        np.testing.assert_allclose(together[b:b + 1], alone, **TOL)
    offline, _ = tm.forward(tp, tstate, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(together, offline.numpy()[..., : together.shape[-1]], **TOL)
    assert np.abs(together[0] - together[1]).max() > 1e-3  # distinct streams


def test_reset_matches_fresh_separator(rng):
    _, _, _, cfg, tp, _ = _setup(5)
    a, b = (rng.standard_normal((1, 160)).astype(np.float32) for _ in range(2))
    sep = ts.StreamingSeparator(cfg, tp, batch=1, device="cpu")
    first = _stream(sep, a, 40)
    sep.reset()
    second = _stream(sep, b, 40)
    np.testing.assert_array_equal(first, _stream(
        ts.StreamingSeparator(cfg, tp, batch=1, device="cpu"), a, 40))
    np.testing.assert_array_equal(second, _stream(
        ts.StreamingSeparator(cfg, tp, batch=1, device="cpu"), b, 40))
    assert np.abs(first - second).max() > 1e-3


@pytest.mark.parametrize("kw,match", [(dict(causal=False), "causal"),
                                      (dict(norm_type="gLN"), "cLN"),
                                      (dict(norm_type="BN"), "cLN")])
def test_rejects_non_streamable_configs(kw, match):
    cfg = ConvTasNetConfig(**{**CAUSAL, **kw})
    jcfg = convtasnet_tpu.ConvTasNetConfig(**{**CAUSAL, **kw})
    with pytest.raises(ValueError, match=match):
        js.init_stream_state(jcfg)
    with pytest.raises(ValueError, match=match):
        ts.init_stream_state(cfg, device="cpu")
    params, _ = tm.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match=match):
        ts.StreamingSeparator(cfg, params, device="cpu")


def test_rejects_misaligned_chunk():
    _, _, _, cfg, tp, _ = _setup(2)
    st = ts.init_stream_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="multiple of stride"):
        ts.stream_step(tp, st, cfg, torch.zeros((1, 33)), first=True)
    sep = ts.StreamingSeparator(cfg, tp, batch=2, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        sep.push(torch.zeros((1, 32)))


def test_init_stream_state_bf16_matches_jax():
    kw = {**CAUSAL, "compute_dtype": "bfloat16"}
    want = js.init_stream_state(convtasnet_tpu.ConvTasNetConfig(**kw), batch=3)
    got = ts.init_stream_state(ConvTasNetConfig(**kw), batch=3, device="cpu")
    assert got.keys() == want.keys()
    jl = [want["sample_tail"]] + [h for r in want["conv_hist"] for h in r] + [want["ola_tail"]]
    tl = ts.state_leaves(got)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        assert not t.any()
    assert tl[1].dtype == torch.bfloat16 and tl[0].dtype == tl[-1].dtype == torch.float32


def test_separator_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is taken")
    _, _, _, cfg, tp, _ = _setup(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.StreamingSeparator(cfg, tp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.init_stream_state(cfg)
