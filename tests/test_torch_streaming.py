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


# ---- the block kernel's plain version, its dispatch and its plan ----------

from convtasnet_torch.ops.kernels import limits as klimits  # noqa: E402
from convtasnet_torch.ops.kernels import stream_block as sb  # noqa: E402

CAUSAL_WIDTHS = dict(N=256, L=20, B=256, H=512, P=3, X=8, R=4, C=2, norm_type="cLN",
                     causal=True)


def _former_block(x, hist, bp, dilation, dt):
    """The per-block ops stream_step ran inline before they moved into
    stream_block_plain, verbatim."""
    from convtasnet_torch.ops.activations import prelu
    from convtasnet_torch.ops.conv import pointwise
    from convtasnet_torch.ops.norms import channelwise_layer_norm

    def causal_dw(x, hist, w, dilation):
        P = w.shape[0]
        span = (P - 1) * dilation
        ext = torch.cat([hist, x], dim=1)
        Kc = x.shape[1]
        wd = w.to(x.dtype)
        out = None
        for p in range(P):
            tap = ext[:, p * dilation: p * dilation + Kc, :] * wd[p]
            out = tap if out is None else out + tap
        return out, (ext[:, ext.shape[1] - span:, :] if span > 0 else hist)

    y = pointwise(x, bp["in_w"], dt).to(dt)
    y = prelu(y, bp["in_prelu"])
    y = channelwise_layer_norm(y, bp["in_gamma"], bp["in_beta"])
    y, h = causal_dw(y, hist, bp["dw_w"], dilation)
    y = prelu(y, bp["dw_prelu"])
    y = channelwise_layer_norm(y, bp["dw_gamma"], bp["dw_beta"])
    return x + pointwise(y, bp["out_w"], dt).to(dt), h


def _block_leaves(gen, B, H, P, dt):
    def rn(*s):
        return torch.randn(s, generator=gen)
    return {"in_w": (rn(B, H) * 0.3).to(dt), "in_prelu": torch.tensor(0.25).to(dt),
            "in_gamma": 1 + 0.1 * rn(H), "in_beta": 0.1 * rn(H), "dw_w": (rn(P, H) * 0.5).to(dt),
            "dw_prelu": torch.tensor(0.25).to(dt), "dw_gamma": 1 + 0.1 * rn(H),
            "dw_beta": 0.1 * rn(H), "out_w": (rn(H, B) * 0.3).to(dt)}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Kc,dilation", [(3, 1), (5, 4), (12, 2), (16, 8)])
def test_stream_block_plain_is_the_former_inline_ops_bit_for_bit(dt, Kc, dilation):
    """stream_block_plain (and the wrapper on the CPU) gives the ops stream_step
    ran inline, output and new history bit for bit, with Kc below and above
    the span, two chunks in a row."""
    gen = torch.Generator().manual_seed(Kc * 10 + dilation)
    bp = _block_leaves(gen, 8, 16, 3, dt)
    hist = torch.randn((2, 2 * dilation, 16), generator=gen).to(dt)
    want_h = got_h = wrap_h = hist
    for _ in range(2):
        x = torch.randn((2, Kc, 8), generator=gen).to(dt)
        want, want_h = _former_block(x, want_h, bp, dilation, dt)
        got, got_h = sb.stream_block_plain(x, got_h, bp, dilation, dt)
        wrap, wrap_h = sb.stream_block(x, wrap_h, bp, dilation, dt)
        assert got.dtype == dt and got_h.shape == hist.shape
        for a in (got, wrap):
            assert torch.equal(a, want)
        for a in (got_h, wrap_h):
            assert torch.equal(a, want_h)


@pytest.mark.parametrize("kw,device,form", [
    (dict(CAUSAL_WIDTHS), "cuda", "kernel"),              # the causal config: bf16, auto
    (dict(CAUSAL_WIDTHS), "cpu", "kernel"),               # the plain version on the CPU
    (dict(CAUSAL_WIDTHS, use_kernels="block"), "cuda", "kernel"),
    (dict(CAUSAL_WIDTHS, use_kernels=0), "cuda", "library"),
    (dict(CAUSAL_WIDTHS, compute_dtype="float32"), "cuda", "library"),
    (dict(CAUSAL_WIDTHS, B=128, H=256), "cuda", "library"),   # widths it is not built for
    (dict(CAUSAL_WIDTHS, X=12), "cuda", "library"),           # a ring past shared memory
    (dict(CAUSAL, compute_dtype="bfloat16"), "cuda", "library"),  # the tests' tiny widths
    (dict(CAUSAL), "cuda", "library"),
])
def test_block_form_picks_the_kernel_only_where_it_runs(kw, device, form):
    """Decided from the config with no card, as kernel_form is."""
    cfg = ConvTasNetConfig(**kw)
    assert ts.block_form(cfg, device) == form
    bf16 = cfg.compute_dtype == "bfloat16"
    assert (form == "kernel") == (cfg.kernel_form(False, device) != "eager"
                                  and klimits.stream_limit(cfg.B, cfg.H, cfg.P, cfg.X, bf16)
                                  is None)


@pytest.mark.parametrize("M,Kc,tiles", [(1, 15, 1), (1, 16, 1), (64, 16, 1), (1, 800, 50),
                                        (4, 799, 50)])
def test_stream_plan_at_the_causal_widths(M, Kc, tiles):
    """b1 at the first (15 frames) and steady (16) 20 ms chunk, b64, and a
    1 s chunk: one cluster of 8 CTAs a stream, 64 channels and 32 output
    columns a CTA, the frames in tiles of 16, a ring of span + 16 frames,
    within shared memory at every dilation of the chain."""
    B, H, P = 256, 512, 3
    smems = []
    for d in [2 ** i for i in range(8)]:
        p = sb.stream_plan(M, Kc, B, H, P, d)
        assert (p.clusters, p.cluster, p.ctas, p.threads) == (M, 8, 8 * M, 128)
        assert (p.channels, p.columns, p.rows, p.tiles) == (64, 32, 16, tiles)
        assert p.ring == 2 * d + 16 and p.smem == klimits.stream_smem(B, H, P, 2 * d)
        assert p.smem <= klimits.STREAM_SMEM
        smems.append(p.smem)
    assert smems == sorted(smems) and smems[-1] < 150_000


def test_stream_plan_refuses_what_the_kernel_is_not_built_for():
    with pytest.raises(ValueError, match="built for"):
        sb.stream_plan(1, 16, 128, 256, 3, 1)
    with pytest.raises(ValueError, match="overflows"):
        sb.stream_plan(1, 16, 256, 512, 3, 2048)
    with pytest.raises(ValueError, match="no stream launch"):
        sb.stream_plan(1, 0, 256, 512, 3, 1)
    assert "bf16" in klimits.stream_limit(256, 512, 3, 8, False)
    assert klimits.stream_limit(256, 512, 3, 8, True) is None
    assert "overflows" in klimits.stream_limit(256, 512, 3, 12, True)
    assert "built for" in klimits.stream_limit(512, 512, 3, 1, True)


def test_stream_step_kernel_form_on_the_cpu_is_the_library_ops_bit_for_bit():
    """At widths the kernel takes, bf16: the step through stream_block (its
    plain version on the CPU) against the step on the library ops, first
    and steady chunk, output and every state leaf bit for bit."""
    kw = dict(CAUSAL_WIDTHS, N=16, L=8, X=2, R=1)
    cfg, lib = ConvTasNetConfig(**kw), ConvTasNetConfig(use_kernels=0, **kw)
    assert ts.block_form(cfg, "cpu") == "kernel" and ts.block_form(lib, "cpu") == "library"
    params, _ = tm.init_params(torch.Generator().manual_seed(8), cfg, device="cpu")
    params = ts._step_params(params, cfg, torch.device("cpu"))
    x = torch.randn((2, 96), generator=torch.Generator().manual_seed(9))
    sk, sl = (ts.init_stream_state(c, batch=2, device="cpu") for c in (cfg, lib))
    for first, chunk in ((True, x[:, :48]), (False, x[:, 48:])):
        ok, sk = ts.stream_step(params, sk, cfg, chunk, first=first)
        ol, sl = ts.stream_step(params, sl, lib, chunk, first=first)
        assert torch.equal(ok, ol)
        for a, b in zip(ts.state_leaves(sk), ts.state_leaves(sl)):
            assert torch.equal(a, b)
