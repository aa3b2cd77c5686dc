"""The kernels' launch limits in the dispatch, on the CPU.

`ConvTasNetConfig.kernel_form` decides from the config, before any launch,
whether the form's kernels take it on a card; beyond a limit the chain runs
eager, as the JAX package's gate sends such a config to XLA. The wrappers
keep refusing what their kernels cannot take. Here they run on meta tensors
with a stand-in for the compiled library: a config passes a wrapper when it
reaches the launch, and is refused when the wrapper raises ValueError."""

import itertools

import numpy as np
import pytest
import torch

import convtasnet_tpu
from convtasnet_torch.config import ConvTasNetConfig
from convtasnet_torch.models import conv_tasnet as tm
from convtasnet_torch.ops.kernels import limits
from convtasnet_torch.ops.kernels import tcn_block as tb
from convtasnet_torch.ops.kernels import tcn_block_bwd as tbb
from convtasnet_tpu.models.conv_tasnet import _use_fused_whole
from test_torch_gemm_plan import meta_lib  # noqa: F401 (fixture)

FLAGS = {(False, "auto"): "whole_tcn", (False, "block"): "whole_block",
         (True, "hybrid"): "whole_tcn_train", (True, "whole"): "whole_block_train"}


# (B, H, P, X, compute_dtype, {train: kernels take it}): at each limit and
# one step beyond it.
LIMIT_CASES = {
    "bf16 H at GEMM_MAX_H": (256, 1024, 3, 8, "bfloat16", {False: True, True: True}),
    "bf16 H beyond": (256, 2048, 3, 8, "bfloat16", {False: False, True: False}),
    "f32 H 1024": (256, 1024, 3, 8, "float32", {False: True, True: True}),
    "f32 H 2048 (no H limit)": (256, 2048, 3, 8, "float32", {False: True, True: True}),
    "span 1024 (X=10): KB2's limit": (256, 512, 3, 10, "bfloat16", {False: True, True: True}),
    "span 2048 (X=11)": (256, 512, 3, 11, "bfloat16", {False: True, True: False}),
    "span 4096 (X=12): K2's limit": (256, 512, 3, 12, "bfloat16", {False: True, True: False}),
    "span 8192 (X=13)": (256, 512, 3, 13, "bfloat16", {False: False, True: False}),
    "P=8, KB2's taps": (256, 512, 8, 8, "bfloat16", {False: True, True: True}),
    "P=9": (256, 512, 9, 8, "bfloat16", {False: True, True: False}),
    "P=9, f32": (256, 512, 9, 8, "float32", {False: True, True: False}),
    "B=96": (96, 512, 3, 8, "bfloat16", {False: False, True: False}),
}


@pytest.mark.parametrize("device", ["cuda", "meta"])
@pytest.mark.parametrize("train,flag", list(FLAGS))
@pytest.mark.parametrize("case", list(LIMIT_CASES))
def test_kernel_form_at_and_beyond_each_limit(case, train, flag, device):
    B, H, P, X, dt, takes = LIMIT_CASES[case]
    cfg = ConvTasNetConfig(B=B, H=H, P=P, X=X, compute_dtype=dt, use_kernels=flag)
    want = FLAGS[(train, flag)] if takes[train] else "eager"
    assert cfg.kernel_form(train, device) == want
    assert cfg.kernel_form(train, "cpu") == FLAGS[(train, flag)]  # plain versions: any config
    assert (limits.kernel_limit(B, H, P, X, dt == "bfloat16", train) is None) == takes[train]


def _form_launches(cfg, form, M=1, Kp=128, K=100):
    """Every kernel wrapper the form launches, as (name, thunk), at the
    chain's largest dilation, on meta tensors."""
    dt, B, H, P = cfg.dtype, cfg.B, cfg.H, cfg.P
    d = 2 ** (cfg.X - 1)

    def act(ch, dtype=dt):
        return torch.empty((M, Kp, ch), dtype=dtype, device="meta")

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    x, g = act(B), act(B)
    y1, c, e, dz, db, dy1 = (act(H) for _ in range(6))
    in_w, in_wt = (torch.empty(shape, dtype=dt, device="meta") for shape in ((B, H), (H, B)))
    out_w, out_wt = in_wt, in_w
    s, a, vh, vb, w = f32(M, 1, 2), f32(1), f32(H), f32(B), f32(P, H)
    norm = cfg.norm_type
    calls = [("K1", lambda: tb.tcn_in_gemm(x, in_w, a, norm))]
    if form in ("whole_tcn", "whole_block", "whole_block_train"):
        calls.append(("K2", lambda: tb.tcn_dwconv(y1, s, a, vh, vh, w, a, norm, d, False, K)))
    if form in ("whole_tcn_train", "whole_block_train"):
        calls.append(("K2 save", lambda: tb.tcn_dwconv(y1, s, a, vh, vh, w, a, norm, d, False,
                                                      K, save=True)))
    if form == "whole_tcn":
        calls.append(("K3 fold", lambda: tb.tcn_out_gemm(e, s, x, out_w, vb, vb, norm, K,
                                                        True)))
    else:
        calls.append(("K3 unfold", lambda: tb.tcn_out_gemm(e, s, x, out_w, vh, vh, norm, K,
                                                          False)))
    if form in ("whole_tcn_train", "whole_block_train"):
        calls += [
            ("KB1", lambda: tbb.tcn_bwd_dz(g, out_wt, c, s, a, vh, norm, K)),
            ("KW z", lambda: tbb.tcn_wgrad(c, g, K, (s, a, vh, vh, norm))),
            ("KB2", lambda: tbb.tcn_bwd_dwconv(y1, c, dz, s, s, s, a, vh, vh, w, a, vh, norm,
                                               d, False, K)),
            ("KB3", lambda: tbb.tcn_bwd_dx(db, y1, in_wt, g, s, s, a, vh, norm, K)),
            ("KW din", lambda: tbb.tcn_wgrad(x, dy1, K)),
        ]
    return calls


def _refusals(cfg, form):
    out = []
    for name, call in _form_launches(cfg, form):
        try:
            call()
        except ValueError:
            out.append(name)
    return out


GRID = list(itertools.product((96, 256), (512, 1024, 1152, 2048), (3, 8, 9),
                              (8, 10, 11, 12, 13), ("bfloat16", "float32")))


@pytest.mark.parametrize("train,flag", list(FLAGS))
def test_kernel_form_matches_the_wrappers_limits(meta_lib, train, flag):
    """Property over a grid of configs: whenever kernel_form picks a kernel
    form on a card, every wrapper that form launches admits the config (at
    the largest dilation); whenever it picks eager, one of them refuses."""
    picked = 0
    for B, H, P, X, dt in GRID:
        cfg = ConvTasNetConfig(B=B, H=H, P=P, X=X, compute_dtype=dt, use_kernels=flag)
        form = cfg.kernel_form(train, "cuda")
        refused = _refusals(cfg, FLAGS[(train, flag)])
        if form == "eager":
            assert refused, (B, H, P, X, dt)
        else:
            assert form == FLAGS[(train, flag)] and not refused, (B, H, P, X, dt, refused)
            picked += 1
    assert 0 < picked < len(GRID)
    assert meta_lib.calls


def test_jax_gate_admits_what_the_port_sends_eager():
    """X=11, P=3, H=512, 4 s: the JAX package's hybrid gate admits it for
    training (about 17 MiB of its 30 MiB), and it trains there. KB2's span
    limit (1024) refuses its largest dilation (span 2048), so on a card the
    port takes the eager chain for training (it used to raise in KB2 at the
    first backward) and keeps the kernels for inference."""
    jcfg = convtasnet_tpu.ConvTasNetConfig(X=11, P=3, H=512, use_pallas="hybrid")
    assert _use_fused_whole(jcfg, None, np.zeros((1, 3199, 256), np.float32), train=True)
    cfg = ConvTasNetConfig(X=11, P=3, H=512, use_kernels="hybrid")
    assert cfg.kernel_form(train=True, device="cuda") == "eager"
    assert cfg.kernel_form(train=False, device="cuda") == "whole_tcn"
    assert limits.kernel_limit(256, 512, 3, 11, True, True).startswith("conv span 2048")


def test_training_forward_beyond_kb2_limits_takes_eager_before_any_launch():
    """A training forward at X=11 (span 2048) on the meta device follows the
    CUDA dispatch without a card: it takes the eager chain and returns the
    estimates' shape instead of reaching the kernel wrappers."""
    cfg = ConvTasNetConfig(N=16, L=4, B=128, H=128, P=3, X=11, R=1, use_kernels="hybrid")
    assert cfg.kernel_form(train=True, device="meta") == "eager"
    params, state = tm.init_params(torch.Generator(), cfg, device="meta")
    est, _ = tm.forward(params, state, cfg, torch.empty((2, 400), device="meta"), train=True)
    assert est.shape == (2, 2, 400)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrappers_keep_refusing_beyond_their_limits(meta_lib, dtype):
    """The guards stay in the wrappers: a CUDA-path call beyond a limit
    raises before any launch."""
    cfg = ConvTasNetConfig(P=9, X=8, compute_dtype=str(dtype).split(".")[1])
    assert _refusals(cfg, "whole_tcn_train") == ["KB2"]
    cfg = ConvTasNetConfig(P=3, X=11, compute_dtype=str(dtype).split(".")[1])
    assert _refusals(cfg, "whole_tcn_train") == ["KB2"]
    cfg = ConvTasNetConfig(P=3, X=13, compute_dtype=str(dtype).split(".")[1])
    assert _refusals(cfg, "whole_tcn_train") == ["K2 save", "KB2"]
    cfg = ConvTasNetConfig(H=2048, compute_dtype=str(dtype).split(".")[1])
    want = ["K3 unfold", "KB3"] if dtype == torch.bfloat16 else []
    assert _refusals(cfg, "whole_tcn_train") == want
