"""convtasnet_torch ops against their convtasnet_tpu counterparts (f32, CPU).

Same numpy-seeded inputs through both packages; tolerances are the
forward ones of tests/test_pallas_tcn.py (rtol 5e-4, atol 5e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_torch.ops import activations as t_act
from convtasnet_torch.ops import conv as t_conv
from convtasnet_torch.ops import framing as t_framing
from convtasnet_torch.ops import norms as t_norms
from convtasnet_tpu.ops import activations as j_act
from convtasnet_tpu.ops import conv as j_conv
from convtasnet_tpu.ops import framing as j_framing
from convtasnet_tpu.ops import norms as j_norms

torch.set_num_threads(1)
TOL = dict(rtol=5e-4, atol=5e-5)


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(kw or TOL))


@pytest.fixture
def data():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 40, 24)).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=(24,))).astype(np.float32)
    b = (0.1 * rng.normal(size=(24,))).astype(np.float32)
    return rng, x, g, b


def test_prelu(data):
    _, x, _, _ = data
    jx, tx = _pair(x)
    _close(t_act.prelu(tx, torch.tensor(0.3)), j_act.prelu(jx, jnp.float32(0.3)))


@pytest.mark.parametrize("kind", ["cLN", "gLN"])
def test_layer_norms(data, kind):
    _, x, g, b = data
    jx, tx = _pair(x)
    jg, tg = _pair(g)
    jb, tb = _pair(b)
    got, _ = t_norms.apply_norm(kind, tx, {"gamma": tg, "beta": tb}, None, False)
    want, _ = j_norms.apply_norm(kind, jx, {"gamma": jg, "beta": jb}, None, False)
    _close(got, want)


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm(data, train):
    rng, x, g, b = data
    rm = (0.1 * rng.normal(size=(24,))).astype(np.float32)
    rv = (1 + 0.1 * rng.random(24)).astype(np.float32)
    got = t_norms.batch_norm(*[torch.from_numpy(a) for a in (x, g, b, rm, rv)], train)
    want = j_norms.batch_norm(*[jnp.asarray(a) for a in (x, g, b, rm, rv)], train)
    for t, j in zip(got, want):  # y, running mean, running var
        _close(t, j)


def test_pointwise(data):
    rng, x, _, _ = data
    w = rng.normal(size=(24, 10)).astype(np.float32)
    _close(t_conv.pointwise(torch.from_numpy(x), torch.from_numpy(w), torch.float32),
           j_conv.pointwise(jnp.asarray(x), jnp.asarray(w), jnp.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_depthwise_dilated(data, causal, d):
    rng, x, _, _ = data
    w = rng.normal(size=(3, 24)).astype(np.float32)
    _close(t_conv.depthwise_dilated(torch.from_numpy(x), torch.from_numpy(w), d, causal),
           j_conv.depthwise_dilated(jnp.asarray(x), jnp.asarray(w), d, causal))


@pytest.mark.parametrize("L,S", [(16, 8), (12, 5)])  # L % S == 0, general case
def test_framing_round_trip(L, S):
    rng = np.random.default_rng(L)
    sig = rng.normal(size=(2, 203)).astype(np.float32)
    got = t_framing.frame_signal(torch.from_numpy(sig), L, S)
    want = j_framing.frame_signal(jnp.asarray(sig), L, S)
    _close(got, want, rtol=0, atol=0)
    frames = rng.normal(size=(2, 3, got.shape[1], L)).astype(np.float32)
    _close(t_framing.overlap_and_add(torch.from_numpy(frames), S),
           j_framing.overlap_and_add(jnp.asarray(frames), S))
