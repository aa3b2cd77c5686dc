"""KFW (tcn_fold_weights), the fold's weight terms, and the whole-TCN
forward that runs it, on the CPU (f32, small widths).

- the KFW wrapper on a CPU tensor against fold_weights (its plain
  version), bit for bit, in bf16 and f32;
- `whole_tcn`, the port's whole-TCN forward, against the JAX package's
  whole_tcn_pallas (fold form, Pallas in interpret mode), gLN and cLN,
  causal and not;
- on meta tensors, with a stand-in kernel library: KFW's launch arguments
  and refusals, and a dispatch log of one `whole_tcn` forward, which
  launches KFW once and K1, K2, K3 NB times each, and otherwise runs only
  views, allocations and the cast of in_w (JAX casts in_w outside its
  kernel too, convtasnet_tpu/ops/pallas/whole_tcn.py:369).

The kernel itself runs on the card only (tests/test_torch_cuda.py,
chip_smoke.py). Tolerances: rtol 5e-4 / atol 5e-5 on forwards
(tests/test_pallas_tcn.py's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from convtasnet_torch.ops.kernels import tcn_block as tb
from convtasnet_torch.ops.kernels.whole_tcn import whole_tcn
from convtasnet_tpu.ops.pallas.whole_tcn import whole_tcn_pallas
from test_torch_gemm_plan import H100_SMS, meta_lib  # noqa: F401 (fixture)

torch.set_num_threads(1)
FWD = dict(rtol=5e-4, atol=5e-5)
B = H = 128
P = 3
NORM_CAUSAL = [("gLN", False), ("gLN", True), ("cLN", False), ("cLN", True)]


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


def _fold_inputs(seed, NB, h, b):
    rng = np.random.default_rng(seed)
    out_w = rng.normal(size=(NB, h, b)).astype(np.float32) * 0.2
    g2 = (rng.normal(size=(NB, h)) * 0.2 + 1).astype(np.float32)
    b2 = (rng.normal(size=(NB, h)) * 0.1).astype(np.float32)
    return [torch.from_numpy(a) for a in (out_w, g2, b2)]


# ---------------------------------------------------------------------------
# The wrapper on the CPU is the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("NB,h,b", [(1, 128, 128), (4, 128, 256), (3, 256, 128)])
def test_kfw_on_a_cpu_tensor_is_fold_weights(dtype, NB, h, b):
    """The KFW wrapper on CPU tensors: fold_weights' three terms, bit for
    bit, with wp in the activation dtype and g2w / b2w f32 [NB, B]; no
    launch is counted."""
    out_w, g2, b2 = _fold_inputs(NB * 10 + h + b, NB, h, b)
    tb.reset_counts()
    got = tb.tcn_fold_weights(out_w, g2, b2, dtype)
    want = tb.fold_weights(out_w, g2, b2, dtype)
    assert [t.dtype for t in got] == [dtype, torch.float32, torch.float32]
    assert [t.shape for t in got] == [(NB, h, b), (NB, b), (NB, b)]
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert tb.counts()["tcn_fold_weights"] == 0


def test_fold_weights_rounds_w_to_the_activation_dtype():
    """The plain version's terms from W rounded to bf16 first: wp is
    round(g2 * round(W)), g2w / b2w the f32 products with round(W)."""
    out_w, g2, b2 = _fold_inputs(3, 2, 128, 128)
    wr = out_w.to(torch.bfloat16).float()
    wp, g2w, b2w = tb.fold_weights(out_w, g2, b2, torch.bfloat16)
    assert torch.equal(wp, (g2[..., None] * wr).to(torch.bfloat16))
    np.testing.assert_allclose(g2w.numpy(), np.einsum("nh,nhb->nb", g2.numpy(), wr.numpy()),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b2w.numpy(), np.einsum("nh,nhb->nb", b2.numpy(), wr.numpy()),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The whole-TCN forward against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm_type,causal", NORM_CAUSAL)
def test_whole_tcn_matches_jax_fold_form(norm_type, causal):
    """The port's whole_tcn (KFW's plain version on the CPU, then K1, K2,
    K3 fold per block) against whole_tcn_pallas(fold_norm2=True) in
    interpret mode: X=2, R=2, zero pad rows past valid_k."""
    X, NB, Kp = 2, 4, 256
    K = 200 if causal else 256
    rng = np.random.default_rng(61 + 2 * causal + (norm_type == "cLN"))
    ps = _params(rng, NB)
    x = np.zeros((2, Kp, B), np.float32)
    x[:, :K] = rng.normal(size=(2, K, B)) * 0.5
    vk = K if K != Kp else None
    want = whole_tcn_pallas(jnp.asarray(x), *[jnp.asarray(p) for p in ps], norm_type, causal,
                            X, interpret=True, valid_k=vk, fold_norm2=True)
    got, _ = whole_tcn(torch.from_numpy(x), *[torch.from_numpy(p) for p in ps], norm_type,
                       causal, X, valid_k=K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    assert not got[:, K:].any()


# ---------------------------------------------------------------------------
# The kernel path on meta tensors
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype,code", [(torch.bfloat16, 1), (torch.float32, 0)])
def test_kfw_launches_once_with_the_stacked_shapes(meta_lib, dtype, code):
    """One launch over all blocks: (dtype code, NB, H, B) as passed, and
    the outputs' shapes and types."""
    NB, h, b = 32, 512, 256
    wp, g2w, b2w = tb.tcn_fold_weights(_meta(NB, h, b), _meta(NB, h), _meta(NB, h), dtype)
    assert [name for name, _ in meta_lib.calls] == ["tcn_fold_weights"]
    args = meta_lib.calls[0][1]
    assert args[1] == code and args[-4:-1] == (NB, h, b)
    # the stand-in library answers 0 resident CTAs: the plan counts two per SM
    assert args[-6:-4] == tb.fold_plan(NB, h, b, H100_SMS, 0) == (3, 171)
    assert wp.shape == (NB, h, b) and wp.dtype == dtype
    assert g2w.shape == b2w.shape == (NB, b) and g2w.dtype == b2w.dtype == torch.float32


@pytest.mark.parametrize("NB,H,B,resident,want", [
    (32, 512, 256, 4, (4, 128)),     # the paper widths
    (60, 1024, 256, 4, (2, 512)),    # the scaled config's
    (32, 512, 256, 1, (3, 171)),     # one CTA resident: two per SM all the same
    (1, 130, 256, 4, (2, 65)),       # one block, H no multiple of anything
    (1, 40, 64, 4, (1, 40)),         # fewer rows than a slice's least
    (200, 512, 256, 4, (1, 512))])   # more column tiles than one wave holds
def test_kfw_plan_splits_h_for_every_sm(NB, H, B, resident, want):
    """KFW's grid: slices of H such that the CTAs number at least two per
    SM (or as many as are resident at once, if more), each slice at least
    FOLD_MIN_ROWS rows (four 16-byte loads per thread), the slices covering
    H."""
    splits, rows = tb.fold_plan(NB, H, B, H100_SMS, resident)
    assert (splits, rows) == want
    assert splits * rows >= H > (splits - 1) * rows
    assert splits == 1 or rows >= tb.FOLD_MIN_ROWS
    tiles = NB * B // tb.FOLD_COLS
    assert tiles * splits >= min(2 * H100_SMS, tiles * max(1, H // tb.FOLD_MIN_ROWS))


@pytest.mark.parametrize("what,shapes,dtype,match", [
    ("B", ((2, 128, 96), (2, 128), (2, 128)), torch.bfloat16, "multiple of 64"),
    ("g2", ((2, 128, 128), (2, 64), (2, 128)), torch.bfloat16, "norm2 vectors"),
    ("b2", ((2, 128, 128), (2, 128), (1, 128)), torch.float32, "norm2 vectors"),
    ("dtype", ((2, 128, 128), (2, 128), (2, 128)), torch.float16, "unsupported"),
])
def test_kfw_refuses(meta_lib, what, shapes, dtype, match):
    with pytest.raises(ValueError, match=match):
        tb.tcn_fold_weights(*[_meta(*s) for s in shapes], dtype)
    assert not meta_lib.calls


def test_kfw_refuses_weights_of_another_type(meta_lib):
    with pytest.raises(ValueError, match="expected torch.float32"):
        tb.tcn_fold_weights(_meta(2, 128, 128, dtype=torch.bfloat16), _meta(2, 128),
                            _meta(2, 128), torch.bfloat16)
    assert not meta_lib.calls


# Torch ops that launch nothing on a card: views and allocations.
NO_LAUNCH = ("aten::view", "aten::_unsafe_view", "aten::select", "aten::slice",
             "aten::reshape", "aten::alias", "aten::empty", "aten::empty_like",
             "aten::unsqueeze", "aten::detach", "aten::as_strided", "aten::squeeze",
             "aten::lift_fresh")


def _forward_events(meta_lib, NB, dt):
    """One whole_tcn forward on meta tensors: its torch ops (with the
    tensors' shapes) and the stand-in's launches, in order."""
    X, M, Kp, K = 2, 2, 384, 300
    shapes = [(NB, B, H), (NB,), (NB, H), (NB, H), (NB, P, H), (NB,), (NB, H), (NB, H),
              (NB, H, B)]
    params = [_meta(*s) for s in shapes]
    x = _meta(M, Kp, B, dtype=dt)
    events = []
    calls = meta_lib.calls
    seen = len(calls)

    def drain():
        nonlocal seen
        events.extend(("launch", name, ()) for name, _ in calls[seen:])
        seen = len(calls)

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            drain()
            shapes_in = tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
            events.append(("op", func._schema.name, shapes_in))
            return func(*args, **(kwargs or {}))

    with Log():
        out, _ = whole_tcn(x, *params, "gLN", False, X, valid_k=K)
    drain()
    assert out.shape == x.shape and out.dtype == dt
    return events


@pytest.mark.parametrize("NB", [2, 4])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_whole_tcn_forward_runs_only_the_kernels(meta_lib, NB, dt):
    """KFW once, first, then K1, K2, K3 per block; the torch ops are views,
    allocations and (bf16) one cast of the stacked in_w: no bmm, mul or
    cast of out_w, whose fold terms come from KFW alone."""
    events = _forward_events(meta_lib, NB, dt)
    launches = [n for kind, n, _ in events if kind == "launch"]
    assert launches == ["tcn_fold_weights"] + ["tcn_in_gemm", "tcn_dwconv", "tcn_out_gemm"] * NB
    ops = [(n, s) for kind, n, s in events if kind == "op" and n not in NO_LAUNCH]
    want = [("aten::_to_copy", ((NB, B, H),))] if dt == torch.bfloat16 else []
    assert ops == want
