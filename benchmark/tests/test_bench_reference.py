"""The plain reference agrees with the port's CPU eager path at a tiny
float32 configuration: the forward, the loss, the train step and the
stream."""

import dataclasses

import pytest
import torch

from benchmark import traffic, weights
from benchmark.reference import convtasnet as ref
from benchmark.tests import tiny

SEED = tiny.SEED


def _cfg(**kw):
    from convtasnet_torch.config import ConvTasNetConfig

    return ConvTasNetConfig(**{**tiny.MODEL, "compute_dtype": "float32", "use_kernels": "0",
                               **kw})


@pytest.mark.parametrize("kw", [dict(norm_type="gLN"), dict(norm_type="cLN", causal=True),
                                dict(norm_type="gLN", mask_nonlinear="softmax", C=3)],
                         ids=["gLN", "cLN-causal", "softmax-C3"])
def test_forward_matches_the_port(kw):
    from convtasnet_torch.models.conv_tasnet import forward

    cfg = _cfg(**kw)
    m = dataclasses.asdict(cfg)
    params = weights.make(m, SEED, "cpu")
    mix = traffic.mixtures(SEED, 2, cfg.C, 1234, 8000, "cpu")
    got = forward(params, {}, cfg, mix)[0]
    want = ref.forward(params, ref.Model(**m), mix, ref.rounding(None))
    torch.testing.assert_close(want, got, rtol=1e-4, atol=2e-5)


def test_bf16_rounding_points_follow_the_port():
    """In bf16 the reference sits at the port's rounding noise: far closer
    than one precision below (fp8) sits."""
    from convtasnet_torch.models.conv_tasnet import forward

    cfg = _cfg(compute_dtype="bfloat16")
    m = dataclasses.asdict(cfg)
    params = weights.make(m, SEED, "cpu")
    mix = traffic.mixtures(SEED, 2, cfg.C, 4000, 8000, "cpu")
    got = forward(params, {}, cfg, mix)[0]
    bf = ref.forward(params, ref.Model(**m), mix, ref.rounding(torch.bfloat16))
    fp8 = ref.forward(params, ref.Model(**m), mix, ref.rounding(ref.FP8))
    assert ref.wave_error(got, bf) < 0.05
    assert ref.wave_error(fp8, bf) > 3 * ref.wave_error(got, bf)


def test_loss_matches_the_port():
    from convtasnet_torch.ops.loss import cal_loss

    src = traffic.sources(SEED, 3, 2, 900, 8000, "cpu")
    est = src.flip(1) + 0.1 * torch.randn(src.shape, generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([900, 700, 333])
    torch.testing.assert_close(ref.pit_loss(src, est, lens), cal_loss(src, est, lens)[0],
                               rtol=1e-5, atol=1e-5)


def test_train_steps_match_the_port():
    from convtasnet_torch.training.optim import Optimizer
    from convtasnet_torch.training.solver import make_train_step

    cfg = _cfg()
    m = dataclasses.asdict(cfg)
    params = weights.make(m, SEED, "cpu")
    src = traffic.sources(SEED, 6, cfg.C, 1600, 8000, "cpu").reshape(3, 2, cfg.C, 1600)
    lens = torch.full((2,), 1600)
    batches = [(src[i].sum(1), src[i], lens) for i in range(3)]
    opt = Optimizer("adam", lr=1e-3)
    step = make_train_step(cfg, opt, 5.0)
    p, st = weights.make(m, SEED, "cpu"), opt.init(params)
    losses = []
    for mix, s, ln in batches:
        p, st, _, loss, _ = step(p, st, {}, mix, s, ln)
        losses.append(float(loss))
        if len(losses) == 1:
            g1 = {n: t / 0.1 for n, t in ref.leaves(st.mu)}
    r_losses, r_grads, r_after = ref.train(params, ref.Model(**m), batches, ref.rounding(None),
                                           3, 1e-3, 5.0)
    assert r_losses == pytest.approx(losses, rel=1e-5, abs=1e-5)
    flat = dict(ref.leaves(params))
    row_loss, _, rows = ref.row_grads(flat, ref.Model(**m), batches[0], ref.rounding(None))
    assert ref.row_shares(g1, rows).tolist() == pytest.approx([1.0, 1.0], abs=1e-3)
    assert sum(row_loss) / 2 == pytest.approx(r_losses[0])
    half = {n: t / 2 for n, t in g1.items()}  # scale drops out; a row left out reads 0
    assert ref.row_shares(half, rows).tolist() == pytest.approx([1.0, 1.0], abs=1e-3)
    _, g_first, _ = ref.row_grads(flat, ref.Model(**m), (batches[0][0][:1], batches[0][1][:1],
                                                          batches[0][2][:1]), ref.rounding(None))
    first = {n: t for (n, _), t in zip(ref.leaves(params), g_first)}
    assert ref.row_shares(first, rows).tolist() == pytest.approx([2.0, 0.0], abs=1e-3)
    r_p = r_after[-1]
    for n, t in ref.leaves(p):
        torch.testing.assert_close(r_grads[0][n], g1[n], rtol=1e-3, atol=1e-6)
        torch.testing.assert_close(r_p[n], t, rtol=1e-4, atol=1e-6)


def test_stream_matches_the_offline_reference():
    from convtasnet_torch.models.streaming import StreamingSeparator

    cfg = _cfg(norm_type="cLN", causal=True)
    m = dataclasses.asdict(cfg)
    params = weights.make(m, SEED, "cpu")
    mix = traffic.mixtures(SEED, 1, cfg.C, 1600, 8000, "cpu")
    sep = StreamingSeparator(cfg, params, batch=1, device="cpu")
    outs = [sep.push(mix[:, s:s + 160]) for s in range(0, 1600, 160)] + [sep.flush()]
    got = torch.cat(outs, dim=-1)
    want = ref.forward(params, ref.Model(**m), mix, ref.rounding(None))
    torch.testing.assert_close(want, got, rtol=1e-4, atol=2e-5)
