"""The CUDA kernels of convtasnet_torch against their plain versions.

These need a CUDA device and the CUDA toolkit (the kernels are built with
nvcc on first use); elsewhere they skip. The file imports only torch and
the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from convtasnet_torch.ops.kernels import tcn_block
from convtasnet_torch.utils import ledger
from convtasnet_torch.ops.kernels.whole_block import whole_block, whole_block_reference
from convtasnet_torch.ops.kernels.whole_tcn import whole_tcn, whole_tcn_reference

pytestmark = pytest.mark.cuda
ORDER = ("in_w", "in_prelu", "in_gamma", "in_beta", "dw_w", "dw_prelu",
         "dw_gamma", "dw_beta", "out_w")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _blocks(NB, B=128, H=256, P=3, device=None):
    rng = np.random.default_rng(NB)
    f = np.float32
    bp = {
        "in_w": rng.normal(size=(NB, B, H)) * 0.1,
        "in_prelu": np.full((NB,), 0.25),
        "in_gamma": rng.normal(size=(NB, H)) * 0.1 + 1,
        "in_beta": rng.normal(size=(NB, H)) * 0.1,
        "dw_w": rng.normal(size=(NB, P, H)) * 0.3,
        "dw_prelu": np.full((NB,), 0.25),
        "dw_gamma": rng.normal(size=(NB, H)) * 0.1 + 1,
        "dw_beta": rng.normal(size=(NB, H)) * 0.1,
        "out_w": rng.normal(size=(NB, H, B)) * 0.1,
    }
    return [torch.as_tensor(bp[k].astype(f), device=device) for k in ORDER]


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("cLN", True)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_whole_tcn_kernels_match_plain(dev, norm_type, causal, dtype, tol):
    args = _blocks(4, device=dev)
    x = torch.randn((2, 300, 128), generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev).to(dtype)
    tcn_block.reset_counts()
    got, _ = whole_tcn(x, *args, norm_type, causal, 2)
    assert tcn_block.counts()["tcn_out_gemm_fold"] == 4
    assert tcn_block.counts()["tcn_fold_weights"] == 1
    want, _ = whole_tcn_reference(x, *args, norm_type, causal, 2)
    assert got.shape == x.shape and torch.isfinite(got.float()).all()
    assert _rel_l2(got, want) <= tol


@pytest.mark.parametrize("dilation", [1, 8])
def test_whole_block_kernels_match_plain(dev, dilation):
    one = [a[0] for a in _blocks(1, device=dev)]
    x = torch.randn((3, 256, 128), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    got, _ = whole_block(x, *one, "gLN", dilation, False)
    want, _ = whole_block_reference(x, *one, "gLN", dilation, False)
    assert _rel_l2(got, want) <= 1e-5


def test_kernels_repeat_bit_for_bit(dev):
    """Partial sums reduce in a fixed order: no run-to-run drift."""
    args = _blocks(2, device=dev)
    x = torch.randn((2, 256, 128), generator=torch.Generator(device=dev).manual_seed(2),
                    device=dev).to(torch.bfloat16)
    a, _ = whole_tcn(x, *args, "gLN", False, 2)
    b, _ = whole_tcn(x, *args, "gLN", False, 2)
    assert torch.equal(a, b)


def test_unsupported_width_raises(dev):
    x = torch.zeros((1, 128, 96), device=dev)
    with pytest.raises(ValueError, match="multiples of 128"):
        tcn_block.tcn_in_gemm(x, torch.zeros((96, 128), device=dev),
                              torch.zeros(1, device=dev), "gLN")


# ---------------------------------------------------------------------------
# Training kernels: K2 save mode, the backward kernels and the three ops
# ---------------------------------------------------------------------------

from convtasnet_torch.ops.kernels import tcn_block_bwd as tbb  # noqa: E402
from convtasnet_torch.ops.kernels.whole_block_hybrid import whole_block_hybrid  # noqa: E402
from convtasnet_torch.ops.kernels.whole_block_vjp import whole_block_train  # noqa: E402
from convtasnet_torch.ops.kernels.whole_tcn_hybrid import (chain_save, whole_tcn_bwd,  # noqa: E402
                                                          whole_tcn_train)


def _rel_max(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _bwd_inputs(dev, dtype, norm_type, causal, dilation, K=300, Kp=384, M=2, B=128,
                H=256):
    """Block inputs and the forward residuals from the plain versions."""
    gen = torch.Generator(device=dev).manual_seed(dilation)
    one = [a[0] for a in _blocks(1, B=B, H=H, device=dev)]
    in_w, a1, g1, b1, w, a2, g2, b2, out_w = one
    x = torch.randn((M, Kp, B), generator=gen, device=dev)
    x[:, K:] = 0
    g = torch.randn((M, Kp, B), generator=gen, device=dev).to(dtype)
    x = x.to(dtype)
    y1, s1 = tcn_block.in_gemm_plain(x, in_w.to(dtype), a1, norm_type)
    _, s2, c = tcn_block.dwconv_plain(y1, s1, a1, g1, b1, w, a2, norm_type, dilation,
                                      causal, K, save=True)
    return dict(x=x, g=g, y1=y1, s1=s1, c=c, s2=s2, in_w=in_w.to(dtype), a1=a1, g1=g1,
                b1=b1, w=w, a2=a2, g2=g2, b2=b2, out_w=out_w.to(dtype), K=K)


BWD_CASES = [("gLN", False, 1), ("gLN", True, 8), ("cLN", False, 4), ("cLN", True, 32)]


@pytest.mark.parametrize("norm_type,causal,dilation", BWD_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1.6e-2)])
def test_backward_kernels_match_plain(dev, norm_type, causal, dilation, dtype, tol):
    """K2 save mode, KB1, KW (both forms), KB2 and KB3 each against its
    plain version on the same inputs; partials compared after their sum."""
    d = _bwd_inputs(dev, dtype, norm_type, causal, dilation)
    K = d["K"]
    red = 1 if norm_type == "gLN" else 2
    ek, s2k, ck = tcn_block.tcn_dwconv(d["y1"], d["s1"], d["a1"], d["g1"], d["b1"], d["w"],
                                      d["a2"], norm_type, dilation, causal, K, save=True)
    assert _rel_max(ck, d["c"]) <= tol
    assert _rel_max(s2k.sum(red), d["s2"].sum(red)) <= tol
    out_wt = d["out_w"].t().contiguous()
    args = (d["g"], out_wt, d["c"], d["s2"], d["a2"], d["g2"], norm_type, K)
    dzk, colk, gs2k = tbb.tcn_bwd_dz(*args)
    dzp, colp, gs2p = tbb.bwd_dz_plain(*args)
    assert _rel_max(dzk, dzp) <= tol
    assert _rel_max(colk.sum(0), colp.sum(0)) <= tol
    assert _rel_max(gs2k.sum(red), gs2p.sum(red)) <= tol
    z = (d["s2"], d["a2"], d["g2"], d["b2"], norm_type)
    assert _rel_max(tbb.tcn_wgrad(d["c"], d["g"], K, z).sum(0),
                    tbb.wgrad_plain(d["c"], d["g"], K, z).sum(0)) <= tol
    args = (d["y1"], d["c"], dzp, d["s1"], d["s2"], gs2p, d["a1"], d["g1"], d["b1"], d["w"],
            d["a2"], d["g2"], norm_type, dilation, causal, K)
    dbk, chk, gs1k, da2k = tbb.tcn_bwd_dwconv(*args)
    dbp, chp, gs1p, da2p = tbb.bwd_dwconv_plain(*args)
    assert _rel_max(dbk, dbp) <= tol
    assert _rel_max(chk.sum(0), chp.sum(0)) <= tol
    assert _rel_max(gs1k.sum(red), gs1p.sum(red)) <= tol
    assert _rel_max(da2k.sum(), da2p.sum()) <= tol
    args = (dbp, d["y1"], d["in_w"].t().contiguous(), d["g"], d["s1"], gs1p, d["a1"], d["g1"],
            norm_type, K)
    dxk, dy1k, da1k = tbb.tcn_bwd_dx(*args)
    dxp, dy1p, da1p = tbb.bwd_dx_plain(*args)
    assert _rel_max(dxk, dxp) <= tol and torch.all(dxk[:, K:] == 0)
    assert _rel_max(dy1k, dy1p) <= tol
    assert _rel_max(da1k.sum(), da1p.sum()) <= tol
    assert _rel_max(tbb.tcn_wgrad(d["x"], dy1p, K).sum(0),
                    tbb.wgrad_plain(d["x"], dy1p, K).sum(0)) <= tol


def _op_grads(op, x, params, g, *static, plain):
    x = x.clone().requires_grad_(True)
    ps = [p.clone().requires_grad_(True) for p in params]
    out = op(x, *ps, *static, plain=plain)
    if op is whole_tcn_train:
        out = out[0]  # (out, s), s None without a skip path
    grads = torch.autograd.grad(out, [x] + ps, g)
    return out.detach(), grads


@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("cLN", True)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_training_ops_match_plain(dev, norm_type, causal, dtype, tol):
    """whole_tcn_train, whole_block_train and whole_block_hybrid: output and
    the eleven gradients (x and ten parameters) of the kernel run against
    the plain run, relative L2. The whole-TCN op's gradients are held
    against the plain backward of the kernel forward's residuals: through
    its four blocks a change of 1e-4 in x moves the plain bf16 gradients by
    3-4e-2 (PReLU's kinks, and its d_alpha sums cancel), so from two
    forwards that round apart the end-to-end gradients differ by 1.8-5.3e-2
    on the H100 (seeds 5-8, with K1 and KB1 on WMMA tiles or on wgmma
    alike); the forward is held end to end through its output."""
    X, K, Kp = 2, 300, 384
    args = _blocks(2 * X, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2, Kp, 128), generator=gen, device=dev)
    x[:, K:] = 0
    x = x.to(dtype)
    g = torch.randn((2, Kp, 128), generator=gen, device=dev).to(dtype)
    ops = [(whole_tcn_train, args, (norm_type, causal, X, K))]
    one = [a[0] for a in args]
    for op in (whole_block_train, whole_block_hybrid):
        ops.append((op, one, (norm_type, 4, causal, K)))
    tcn_block.reset_counts()
    tbb.reset_counts()
    for op, params, static in ops:
        got, gk = _op_grads(op, x, params, g, *static, plain=False)
        want, gp = _op_grads(op, x, params, g, *static, plain=True)
        assert _rel_l2(got, want) <= tol, op.__name__
        if op is whole_tcn_train:
            _, x_res, c_res, s2 = chain_save(x, *params, *static[:3], K)
            gp = whole_tcn_bwd(g, x_res, c_res, s2, *params, *static[:3], K,
                               tcn_block.in_gemm_plain, tbb.PLAIN_BWD)
        for i, (a, b) in enumerate(zip(gk, gp)):
            assert _rel_l2(a, b) <= tol, (op.__name__, i)
    counts = tbb.counts()
    assert counts["tcn_bwd_dz"] == 2 * X + 1 and counts["tcn_wgrad_in"] == 2 * X + 1
    # KF once per group: the whole-TCN op's 2X blocks fill one group, the
    # whole block is a group of one, and the hybrid op's backward is plain
    assert counts["tcn_bwd_finish"] == 2


def test_backward_repeats_bit_for_bit(dev):
    """Partials reduce in a fixed order, no float atomics: two backward
    runs give identical bytes."""
    X, K, Kp = 2, 300, 384
    args = _blocks(2 * X, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((2, Kp, 128), generator=gen, device=dev)
    x[:, K:] = 0
    x = x.to(torch.bfloat16)
    g = torch.randn((2, Kp, 128), generator=gen, device=dev).to(torch.bfloat16)
    a = _op_grads(whole_tcn_train, x, args, g, "gLN", False, X, K, plain=False)[1]
    b = _op_grads(whole_tcn_train, x, args, g, "gLN", False, X, K, plain=False)[1]
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("n_kw,n_tile,B,H,P", [(1, 1, 128, 256, 3), (7, 125, 256, 512, 3),
                                               (25, 250, 256, 512, 3), (3, 40, 128, 128, 8)])
def test_bwd_finish_matches_plain_and_repeats(dev, n_kw, n_tile, B, H, P):
    """KF against bwd_finish_plain on a group of three slots of random
    partials of each layout (the last slots holding fewer KB2 partials
    than the buffers), into rows 1-3 of five stacked gradients (the others
    untouched), and two launches giving identical bits."""
    gen = torch.Generator(device=dev).manual_seed(n_kw + n_tile)
    cap = tbb.PartCounts(n_kw, n_kw, n_tile, 2 * n_tile, 2 * n_tile, 4 * n_tile)
    slots = tbb.FinishSlots.alloc(3, cap, B, H, P, dev)
    for t in slots:
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    counts = [cap, cap._replace(nch=max(1, n_tile // 2), nda2=2 * n_tile),
              cap._replace(nch=1, nda2=1)]
    shapes = [(5, B, H), (5,), (5, H), (5, H), (5, P, H), (5,), (5, H), (5, H), (5, H, B)]
    want, got, again = ([torch.full(sh, float("nan"), device=dev) for sh in shapes]
                        for _ in range(3))
    tbb.bwd_finish_plain(slots, counts, want, 1)
    tbb.reset_counts()
    tbb.tcn_bwd_finish(slots, counts, got, 1)
    tbb.tcn_bwd_finish(slots, counts, again, 1)
    assert tbb.counts()["tcn_bwd_finish"] == 2
    for name, a, b, c in zip(tbb.GRAD_ORDER, got, want, again):
        assert _rel_max(a[1:4], b[1:4]) <= 1e-4, name
        assert torch.isnan(a[0]).all() and torch.isnan(a[4]).all(), name
        assert torch.equal(a[1:4], c[1:4]), name


def test_grouped_finish_repeats_whatever_the_group(dev):
    """The whole-TCN backward with KF finishing groups of 1, 3 (the last
    group short) and all 2X blocks: the same bits, a KF launch per group."""
    X, K, Kp = 2, 300, 384
    args = _blocks(2 * X, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((2, Kp, 128), generator=gen, device=dev)
    x[:, K:] = 0
    x = x.to(torch.bfloat16)
    g = torch.randn((2, Kp, 128), generator=gen, device=dev).to(torch.bfloat16)
    _, x_res, c_res, s2 = chain_save(x, *args, "gLN", False, X, K)
    runs = {}
    for group in (1, 3, 2 * X):
        tbb.reset_counts()
        runs[group] = whole_tcn_bwd(g, x_res, c_res, s2, *args, "gLN", False, X, K,
                                    group=group)
        assert tbb.counts()["tcn_bwd_finish"] == -(-2 * X // group)
    for group in (1, 3):
        assert all(torch.equal(a, b) for a, b in zip(runs[group], runs[2 * X]))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 1e-1)])
def test_whole_chain_matches_the_per_block_ops(dev, dtype, tol):
    """The chain-level whole op (one Function over the blocks) against the
    per-block recompute ops over views of the stacked leaves: output and
    every gradient, relative L2 (the train step's TOL_GRAD_F32 /
    TOL_GRAD_BF16 of chip_smoke.py)."""
    from convtasnet_torch.ops.kernels.whole_block_vjp import whole_chain_train

    X, K, Kp = 2, 300, 384
    args = _blocks(2 * X, device=dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((2, Kp, 128), generator=gen, device=dev)
    x[:, K:] = 0
    x = x.to(dtype)
    g = torch.randn((2, Kp, 128), generator=gen, device=dev).to(dtype)

    def per_block(x, *leaves):
        for nb in range(2 * X):
            x = whole_block_train(x, *[a[nb] for a in leaves], "gLN", 2 ** (nb % X), False,
                                  valid_k=K)
        return x

    res = []
    for fn in (per_block, lambda *a: whole_chain_train(*a, "gLN", False, X, valid_k=K)):
        leaves = [x.clone().requires_grad_(True)] + [a.clone().requires_grad_(True)
                                                     for a in args]
        out = fn(*leaves)
        res.append((out.detach(), torch.autograd.grad(out, leaves, g)))
    assert _rel_l2(res[1][0], res[0][0]) <= tol
    for i, (a, b) in enumerate(zip(res[1][1], res[0][1])):
        assert torch.isfinite(a.float()).all() and _rel_l2(a, b) <= tol, i


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 1e-1)])
def test_hybrid_chain_matches_the_per_block_ops(dev, dtype, tol):
    """The chain-level hybrid op (one Function over the blocks) against the
    per-block hybrid ops over views of the stacked leaves: output and
    every gradient, relative L2 (as the whole op's test above)."""
    from convtasnet_torch.ops.kernels.whole_block_hybrid import whole_chain_hybrid

    X, K, Kp = 2, 300, 384
    args = _blocks(2 * X, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((2, Kp, 128), generator=gen, device=dev)
    x[:, K:] = 0
    x = x.to(dtype)
    g = torch.randn((2, Kp, 128), generator=gen, device=dev).to(dtype)

    def per_block(x, *leaves):
        for nb in range(2 * X):
            x = whole_block_hybrid(x, *[a[nb] for a in leaves], "cLN", 2 ** (nb % X), True,
                                   valid_k=K)
        return x

    res = []
    for fn in (per_block, lambda *a: whole_chain_hybrid(*a, "cLN", True, X, valid_k=K)):
        leaves = [x.clone().requires_grad_(True)] + [a.clone().requires_grad_(True)
                                                     for a in args]
        out = fn(*leaves)
        res.append((out.detach(), torch.autograd.grad(out, leaves, g)))
    assert torch.equal(res[1][0], res[0][0])
    for i, (a, b) in enumerate(zip(res[1][1], res[0][1])):
        assert torch.isfinite(a.float()).all() and _rel_l2(a, b) <= tol, i


@pytest.mark.parametrize("NB,H,B", [(4, 256, 128), (32, 512, 256), (60, 1024, 256),
                                    (1, 130, 256), (1, 40, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_weights_kernel_matches_plain(dev, NB, H, B, dtype):
    """KFW against fold_weights: wp bit for bit; g2w / b2w within 1e-4 of
    the sum of |g2| |W| per column (another summation order); a second
    launch gives the same bytes; one launch counted per call."""
    gen = torch.Generator(device=dev).manual_seed(NB)
    out_w = torch.randn((NB, H, B), generator=gen, device=dev) * 0.1
    g2 = torch.randn((NB, H), generator=gen, device=dev) * 0.1 + 1
    b2 = torch.randn((NB, H), generator=gen, device=dev) * 0.1
    tcn_block.reset_counts()
    got = tcn_block.tcn_fold_weights(out_w, g2, b2, dtype)
    again = tcn_block.tcn_fold_weights(out_w, g2, b2, dtype)
    assert tcn_block.counts()["tcn_fold_weights"] == 2
    want = tcn_block.fold_weights(out_w, g2, b2, dtype)
    assert torch.equal(got[0], want[0])
    wr = out_w.to(dtype).float().abs()
    for a, b, v in zip(got[1:], want[1:], (g2, b2)):
        scale = torch.einsum("nh,nhb->nb", v.abs(), wr)
        assert float(((a - b).abs() / scale).max()) <= 1e-4
    for a, b in zip(got, again):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K3 and KB3 on the wgmma pipeline (bf16) and the SIMT tiles (f32), at every
# tile plan: a card of one SM makes gemm_plan take 128-row tiles, the real
# card's SM count 64-row tiles (and 128 columns for K3) at these row counts.
# ---------------------------------------------------------------------------

# (256, 1024): H at GEMM_MAX_H, the bf16 limit of K3 and KB3.
GEMM_WIDTHS = [(128, 256), (128, 512), (256, 256), (256, 512), (256, 1024)]
GEMM_DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 1.6e-2)]


def _plan_sms(monkeypatch, one_sm):
    if one_sm:
        monkeypatch.setattr(tcn_block, "_sm_count", lambda index: 1)
        monkeypatch.setattr(tbb, "_sm_count", lambda index: 1)


def _k3_inputs(dev, dtype, B, H, norm_type, causal, M=3, Kp=384, K=300):
    """e and its norm2 partials from the plain K1 and K2, the residual x."""
    in_w, a1, g1, b1, w, a2, g2, b2, out_w = [a[0] for a in _blocks(1, B=B, H=H, device=dev)]
    gen = torch.Generator(device=dev).manual_seed(B + H)
    x = torch.randn((M, Kp, B), generator=gen, device=dev)
    x[:, K:] = 0
    x = x.to(dtype)
    y1, s1 = tcn_block.in_gemm_plain(x, in_w.to(dtype), a1, norm_type)
    e, s2 = tcn_block.dwconv_plain(y1, s1, a1, g1, b1, w, a2, norm_type, 2, causal, K)
    return x, e, s2, g2, b2, out_w, K


@pytest.mark.parametrize("one_sm", [False, True])
@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("gLN", True), ("cLN", False),
                                              ("cLN", True)])
@pytest.mark.parametrize("B,H", GEMM_WIDTHS)
@pytest.mark.parametrize("dtype,tol", GEMM_DTYPES)
def test_out_gemm_matches_plain(dev, monkeypatch, one_sm, norm_type, causal, B, H, dtype, tol):
    """K3 fold and unfold, into a fresh tensor and in place, against the
    plain version; rows >= K exact zeros; two launches give equal bytes."""
    _plan_sms(monkeypatch, one_sm)
    x, e, s2, g2, b2, out_w, K = _k3_inputs(dev, dtype, B, H, norm_type, causal)
    for fold in (True, False):
        if fold:
            wmat, va, vb = tcn_block.fold_weights(out_w, g2, b2, dtype)
        else:
            wmat, va, vb = out_w.to(dtype), g2, b2
        args = (e, s2, x, wmat, va, vb, norm_type, K, fold)
        want = tcn_block.out_gemm_plain(*args)
        got = tcn_block.tcn_out_gemm(*args)
        assert _rel_max(got, want) <= tol, fold
        assert torch.all(got[:, K:] == 0)
        assert torch.equal(tcn_block.tcn_out_gemm(*args), got)
        xi = x.clone()
        inplace = tcn_block.tcn_out_gemm(e, s2, xi, wmat, va, vb, norm_type, K, fold, out=xi)
        assert inplace.data_ptr() == xi.data_ptr() and torch.equal(inplace, got)


@pytest.mark.parametrize("one_sm", [False, True])
@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("gLN", True), ("cLN", False),
                                              ("cLN", True)])
@pytest.mark.parametrize("B,H", GEMM_WIDTHS)
@pytest.mark.parametrize("dtype,tol", GEMM_DTYPES)
def test_bwd_dx_matches_plain(dev, monkeypatch, one_sm, norm_type, causal, B, H, dtype, tol):
    """KB3 against its plain version: dx (rows >= K exact zeros), dy1 and
    the d_alpha1 partials; two launches give equal bytes."""
    _plan_sms(monkeypatch, one_sm)
    d = _bwd_inputs(dev, dtype, norm_type, causal, 2, M=3, B=B, H=H)
    K = d["K"]
    dz, _, gs2 = tbb.bwd_dz_plain(d["g"], d["out_w"].t().contiguous(), d["c"], d["s2"],
                                  d["a2"], d["g2"], norm_type, K)
    db, _, gs1, _ = tbb.bwd_dwconv_plain(d["y1"], d["c"], dz, d["s1"], d["s2"], gs2, d["a1"],
                                         d["g1"], d["b1"], d["w"], d["a2"], d["g2"], norm_type,
                                         2, causal, K)
    args = (db, d["y1"], d["in_w"].t().contiguous(), d["g"], d["s1"], gs1, d["a1"], d["g1"],
            norm_type, K)
    dxk, dy1k, da1k = tbb.tcn_bwd_dx(*args)
    dxp, dy1p, da1p = tbb.bwd_dx_plain(*args)
    assert _rel_max(dxk, dxp) <= tol and torch.all(dxk[:, K:] == 0)
    assert _rel_max(dy1k, dy1p) <= tol
    assert _rel_max(da1k.sum(), da1p.sum()) <= max(tol, 2e-3)
    again = tbb.tcn_bwd_dx(*args)
    assert all(torch.equal(u, v) for u, v in zip((dxk, dy1k, da1k), again))


# ---------------------------------------------------------------------------
# KW on its TMA + wgmma kernel (bf16) and the SIMT tiles (f32), both forms,
# at the launch plan of the card, of a card of one SM (one split) and at
# forced cluster plans (splits, cluster); Bm's rows >= K poisoned with NaN.
# ---------------------------------------------------------------------------

WGRAD_PLANS = {"auto": None, "one_sm": None, "splits4_cluster2": (4, 2),
               "splits8_cluster4": (8, 4), "splits8_cluster8": (8, 8)}


@pytest.mark.parametrize("plan", list(WGRAD_PLANS))
@pytest.mark.parametrize("M", [5, 1])
@pytest.mark.parametrize("norm_type", ["gLN", "cLN"])
@pytest.mark.parametrize("B,H", [(128, 256), (256, 512)])
@pytest.mark.parametrize("dtype,tol", GEMM_DTYPES)
def test_wgrad_matches_plain(dev, monkeypatch, plan, M, norm_type, B, H, dtype, tol):
    """Both KW forms against wgrad_plain (which reads Bm's rows >= K as
    zero): NaN in those rows must not reach the product; the partials'
    count follows the plan; two launches give equal bytes."""
    _plan_sms(monkeypatch, plan == "one_sm")
    K, Kp = 450, 512
    d = _bwd_inputs(dev, dtype, norm_type, False, 2, K=K, Kp=Kp, M=M, B=B, H=H)
    gen = torch.Generator(device=dev).manual_seed(M + B)
    dy1 = torch.randn((M, Kp, H), generator=gen, device=dev).to(dtype)
    g, z = d["g"].clone(), (d["s2"], d["a2"], d["g2"], d["b2"], norm_type)
    g[:, K:] = float("nan")
    dy1[:, K:] = float("nan")
    forced = WGRAD_PLANS[plan]
    for A, Bm, zz in ((d["c"], g, z), (d["x"], dy1, None)):
        want = tbb.wgrad_plain(A, Bm, K, zz).sum(0)
        part = tbb.tcn_wgrad(A, Bm, K, zz, plan=forced)
        assert _rel_max(part.sum(0), want) <= tol, zz is None
        assert torch.equal(tbb.tcn_wgrad(A, Bm, K, zz, plan=forced), part)
        if dtype == torch.bfloat16:
            splits, cluster = (forced or tbb.wgrad_launch_plan(A, Bm, zz))[:2]
            assert part.shape[0] == splits // cluster
            if plan == "one_sm":
                assert part.shape[0] == 1


# ---------------------------------------------------------------------------
# K1 (tcn_in_gemm) and KB1 (tcn_bwd_dz) on the wgmma pipeline (bf16, modes
# H_IN and H_DZ) and the SIMT tiles (f32), at each of the three tile plans:
# with one CTA counted resident per SM, gemm_plan picks 128 x 256 on a card
# of one SM, 64 x 256 when the 64-row tiles fit one wave, 64 x 128 on a card
# of unbounded SMs.
# ---------------------------------------------------------------------------

IN_WIDTHS = [(128, 256), (128, 512), (128, 1024), (256, 256), (256, 512), (256, 1024)]


def _plans(rows, B, H, io_tiles):
    """{tile: SM count that makes gemm_plan pick it} for the three tiles."""
    sms = {(128, 256): 1, (64, 256): rows // 64 * (H // 256), (64, 128): 10 ** 6}
    for tile, n in sms.items():
        assert tcn_block.gemm_plan(rows, H, B, n, io_tiles=io_tiles) == tile
    return sms


def _each_plan(monkeypatch, dtype, rows, B, H, io_tiles):
    """Yields once per tile plan in bf16 (with _sm_count and the card's
    occupancy patched to force it), once in f32 (the SIMT tiles take no
    plan)."""
    if dtype != torch.bfloat16:
        yield None
        return
    for mod in (tcn_block, tbb):
        monkeypatch.setattr(mod, "_resident", lambda index, mode: ())
    for tile, n in _plans(rows, B, H, io_tiles).items():
        monkeypatch.setattr(tcn_block, "_sm_count", lambda index, n=n: n)
        monkeypatch.setattr(tbb, "_sm_count", lambda index, n=n: n)
        yield tile


@pytest.mark.parametrize("M", [5, 1])
@pytest.mark.parametrize("norm_type", ["gLN", "cLN"])
@pytest.mark.parametrize("B,H", IN_WIDTHS)
@pytest.mark.parametrize("dtype,tol", GEMM_DTYPES)
def test_in_gemm_matches_plain(dev, monkeypatch, M, norm_type, B, H, dtype, tol):
    """K1 against its plain version at every tile plan: y1 (its rows >= K
    stay zero: x's are), the statistics after their sum, into a fresh y1 and
    into a given one; two launches give equal bytes."""
    K, Kp = 300, 384
    in_w, a1 = [a[0] for a in _blocks(1, B=B, H=H, device=dev)][:2]
    gen = torch.Generator(device=dev).manual_seed(M * B + H)
    x = torch.randn((M, Kp, B), generator=gen, device=dev)
    x[:, K:] = 0
    x, in_w = x.to(dtype), in_w.to(dtype)
    red = 1 if norm_type == "gLN" else 2
    y1p, s1p = tcn_block.in_gemm_plain(x, in_w, a1, norm_type)
    for tile in _each_plan(monkeypatch, dtype, M * Kp, B, H, io_tiles=1):
        y1k, s1k = tcn_block.tcn_in_gemm(x, in_w, a1, norm_type)
        assert _rel_max(y1k, y1p) <= tol, tile
        assert torch.all(y1k[:, K:] == 0), tile
        assert _rel_max(s1k.sum(red), s1p.sum(red)) <= tol, tile
        if tile is not None:
            n = Kp // tile[0] * (H // tile[1])
            assert s1k.shape == ((M, n, 2) if norm_type == "gLN" else (M, Kp, H // tile[1], 2))
        given = torch.full_like(y1k, float("nan"))
        y1g, s1g = tcn_block.tcn_in_gemm(x, in_w, a1, norm_type, given)
        assert y1g.data_ptr() == given.data_ptr() and torch.equal(y1g, y1k), tile
        assert torch.equal(s1g, s1k), tile


@pytest.mark.parametrize("M", [5, 1])
@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("gLN", True), ("cLN", False),
                                              ("cLN", True)])
@pytest.mark.parametrize("B,H", IN_WIDTHS)
@pytest.mark.parametrize("dtype,tol", GEMM_DTYPES)
def test_bwd_dz_matches_plain(dev, monkeypatch, M, norm_type, causal, B, H, dtype, tol):
    """KB1 against its plain version at every tile plan, with NaN in the
    rows >= K of g and of c (the saved c's pad rows are not masked): dz
    (those rows exact zeros), the dg2 / db2 column partials and the norm2
    backward partials after their sum; two launches give equal bytes."""
    d = _bwd_inputs(dev, dtype, norm_type, causal, 2, M=M, B=B, H=H)
    K = d["K"]
    red = 1 if norm_type == "gLN" else 2
    out_wt = d["out_w"].t().contiguous()
    g, c = d["g"].clone(), d["c"].clone()
    g[:, K:] = float("nan")
    c[:, K:] = float("nan")
    args = (g, out_wt, c, d["s2"], d["a2"], d["g2"], norm_type, K)
    dzp, colp, gs2p = tbb.bwd_dz_plain(*args)
    for tile in _each_plan(monkeypatch, dtype, g.shape[0] * g.shape[1], B, H, io_tiles=2):
        dzk, colk, gs2k = tbb.tcn_bwd_dz(*args)
        assert _rel_max(dzk, dzp) <= tol, tile
        assert torch.all(dzk[:, K:] == 0), tile
        assert _rel_max(colk.sum(0), colp.sum(0)) <= tol, tile
        assert _rel_max(gs2k.sum(red), gs2p.sum(red)) <= tol, tile
        if tile is not None:
            assert colk.shape == (g.shape[0] * g.shape[1] // tile[0], 2, H)
        again = tbb.tcn_bwd_dz(*args)
        assert all(torch.equal(u, v) for u, v in zip((dzk, colk, gs2k), again)), tile


# ---------------------------------------------------------------------------
# The depthwise kernels at their span limits (ops/kernels/limits.py): KB2's
# span 1024 (X = 10, P = 3, dilation 512) and taps 8, K2's span 4096.
# ---------------------------------------------------------------------------

SPAN_CASES = [(3, 512, True), (8, 128, True), (3, 2048, False)]


@pytest.mark.parametrize("P,dilation,backward", SPAN_CASES)
@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("cLN", True)])
@pytest.mark.parametrize("dtype,tol", GEMM_DTYPES)
def test_dwconv_kernels_at_the_span_limits(dev, P, dilation, backward, norm_type, causal,
                                           dtype, tol):
    """K2 (and its save mode) and, within KB2's limits, KB2 against their
    plain versions at the largest span each takes (KB2 with NaN in the rows
    >= K it never reads, its pad rows zero, two launches equal bytes)."""
    from convtasnet_torch.ops.kernels import limits

    span = (P - 1) * dilation
    assert span <= (limits.BWD_MAX_SPAN if backward else limits.DWCONV_MAX_SPAN)
    M, B, H, K = 2, 128, 256, 2 * span + 100
    Kp = -(-K // 128) * 128
    in_w, a1, g1, b1, w, a2, g2, b2, out_w = [a[0] for a in _blocks(1, B=B, H=H, P=P,
                                                                    device=dev)]
    gen = torch.Generator(device=dev).manual_seed(P * dilation)
    x = torch.randn((M, Kp, B), generator=gen, device=dev)
    x[:, K:] = 0
    x = x.to(dtype)
    red = 1 if norm_type == "gLN" else 2
    y1, s1 = tcn_block.in_gemm_plain(x, in_w.to(dtype), a1, norm_type)
    args = (y1, s1, a1, g1, b1, w, a2, norm_type, dilation, causal, K)
    ek, s2k = tcn_block.tcn_dwconv(*args)
    ep, s2p = tcn_block.dwconv_plain(*args)
    assert _rel_max(ek, ep) <= tol and _rel_max(s2k.sum(red), s2p.sum(red)) <= tol
    _, s2ks, ck = tcn_block.tcn_dwconv(*args, save=True)
    _, s2, c = tcn_block.dwconv_plain(*args, save=True)
    assert _rel_max(ck, c) <= tol and _rel_max(s2ks.sum(red), s2.sum(red)) <= tol
    if not backward:
        return
    g = torch.randn((M, Kp, B), generator=gen, device=dev).to(dtype)
    dz, _, gs2 = tbb.bwd_dz_plain(g, out_w.to(dtype).t().contiguous(), c, s2, a2, g2, norm_type,
                                  K)
    tail = (s1, s2, gs2, a1, g1, b1, w, a2, g2, norm_type, dilation, causal, K)
    # KB2 never reads the rows >= K of y1, c and dz: NaN there
    nargs = (_nan_rows(y1, K), _nan_rows(c, K), _nan_rows(dz, K)) + tail
    dbk, chk, gs1k, da2k = tbb.tcn_bwd_dwconv(*nargs)
    dbp, chp, gs1p, da2p = tbb.bwd_dwconv_plain(y1, c, dz, *tail)
    assert _rel_max(dbk, dbp) <= tol and _rel_max(chk.sum(0), chp.sum(0)) <= tol
    assert torch.all(dbk[:, K:] == 0)
    assert _rel_max(gs1k.sum(red), gs1p.sum(red)) <= tol
    assert _rel_max(da2k.sum(), da2p.sum()) <= max(tol, 2e-3)
    assert all(torch.equal(u, v) for u, v in zip((dbk, chk, gs1k, da2k),
                                                 tbb.tcn_bwd_dwconv(*nargs)))


def test_gemm_occupancy_query(dev):
    """The card's occupancy of every mode and tile of the wgmma template:
    at least one CTA per SM (the plan divides by it)."""
    for mod, modes in ((tcn_block, (tcn_block.H_FOLD, tcn_block.H_UNFOLD, tcn_block.H_IN)),
                       (tbb, (tcn_block.H_DX, tcn_block.H_DZ))):
        for mode in modes:
            res = dict(mod._resident(torch.cuda.current_device(), mode))
            assert set(res) == set(tcn_block.GEMM_TILES) and min(res.values()) >= 1, (mode, res)


# ---------------------------------------------------------------------------
# K2 (both modes), a staged stencil, and KB2, a streaming stencil down strips
# (csrc/tcn_dwconv_sm90.cuh): K2 at every tile its plan can take, KB2 at
# every strip shape, over dilations 1..512 with P in {2, 3, 8}, with K not a
# multiple of the tile's rows or the strip's chunks, NaN in the rows >= K of
# y1, c and dz (never read), and two launches giving equal bytes.
# ---------------------------------------------------------------------------

def _dw_case(dev, dtype, norm_type, P, M=2, Kp=1280, K=1201, H=256, seed=0):
    """y1 (rows >= K NaN) with its norm1 partials, c (rows >= K NaN) and the
    norm2 partials from the plain K2, dz (rows >= K NaN) and KB1's plain
    partials, and the block's f32 parameters."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    in_w, a1, g1, b1, w, a2, g2, b2, out_w = [a[0] for a in _blocks(1, B=128, H=H, P=P,
                                                                    device=dev)]
    x = torch.randn((M, Kp, 128), generator=gen, device=dev)
    x[:, K:] = 0
    y1, s1 = tcn_block.in_gemm_plain(x.to(dtype), in_w.to(dtype), a1, norm_type)
    g = torch.randn((M, Kp, 128), generator=gen, device=dev).to(dtype)
    return dict(y1=y1, s1=s1, a1=a1, g1=g1, b1=b1, w=w, a2=a2, g2=g2, out_wt=out_w.to(dtype).t()
                .contiguous(), g=g, K=K, norm=norm_type)


def _nan_rows(t, K):
    t = t.clone()
    t[:, K:] = float("nan")
    return t


def _check_dw(d, dilation, causal, tol, plan=None, bplan=None, backward=True):
    """K2 (inference and save) and, where KB2 admits the span, KB2 against
    the plain versions at one dilation; returns nothing, asserts."""
    from convtasnet_torch.ops.kernels import limits

    K, norm = d["K"], d["norm"]
    red = 1 if norm == "gLN" else 2
    y1n = _nan_rows(d["y1"], K)
    fargs = (d["y1"], d["s1"], d["a1"], d["g1"], d["b1"], d["w"], d["a2"], norm, dilation,
             causal, K)
    kargs = (y1n,) + fargs[1:]
    ep, s2p, cp = tcn_block.dwconv_plain(*fargs, save=True)
    ek, s2k = tcn_block.tcn_dwconv(*kargs, plan=plan)
    assert _rel_max(ek, ep) <= tol and _rel_max(s2k.sum(red), s2p.sum(red)) <= tol
    eks, s2ks, ck = tcn_block.tcn_dwconv(*kargs, save=True, plan=plan)
    assert torch.equal(eks, ek) and torch.equal(s2ks, s2k)
    assert _rel_max(ck, cp) <= tol
    again = tcn_block.tcn_dwconv(*kargs, save=True, plan=plan)
    assert all(torch.equal(u, v) for u, v in zip((eks, s2ks, ck), again))
    P = d["w"].shape[0]
    if not backward or P > limits.BWD_MAXP or (P - 1) * dilation > limits.BWD_MAX_SPAN:
        return
    _check_kb2(d, cp, s2p, dilation, causal, tol, bplan)


def _check_kb2(d, cp, s2p, dilation, causal, tol, bplan=None):
    """KB2 against bwd_dwconv_plain at one dilation, NaN in the rows >= K
    of y1, c and dz, db's pad rows zero, two launches equal bytes."""
    K, norm = d["K"], d["norm"]
    red = 1 if norm == "gLN" else 2
    dz, _, gs2 = tbb.bwd_dz_plain(d["g"], d["out_wt"], cp, s2p, d["a2"], d["g2"], norm, K)
    tail = (s2p, gs2, d["a1"], d["g1"], d["b1"], d["w"], d["a2"], d["g2"], norm, dilation,
            causal, K)
    want = tbb.bwd_dwconv_plain(d["y1"], cp, dz, d["s1"], *tail)
    bargs = (_nan_rows(d["y1"], K), _nan_rows(cp, K), _nan_rows(dz, K), d["s1"]) + tail
    got = tbb.tcn_bwd_dwconv(*bargs, plan=bplan)
    assert _rel_max(got[0], want[0]) <= tol and torch.all(got[0][:, K:] == 0)
    assert _rel_max(got[1].sum(0), want[1].sum(0)) <= tol
    assert _rel_max(got[2].sum(red), want[2].sum(red)) <= tol
    assert _rel_max(got[3].sum(), want[3].sum()) <= max(tol, 2e-3)
    assert all(torch.equal(u, v) for u, v in zip(got, tbb.tcn_bwd_dwconv(*bargs, plan=bplan)))


DW_DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 1.6e-2)]


@pytest.mark.parametrize("P", [2, 3, 8])
@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("gLN", True), ("cLN", False),
                                              ("cLN", True)])
@pytest.mark.parametrize("dtype,tol", DW_DTYPES)
def test_dwconv_kernels_over_dilations(dev, P, norm_type, causal, dtype, tol):
    """The planned tile and strips at every dilation 1..512 (spans up to
    3,584 rows at P = 8, beyond K = 1,201: the halo reads nothing), K2 and
    KB2."""
    d = _dw_case(dev, dtype, norm_type, P, seed=P)
    for i in range(10):
        _check_dw(d, 2 ** i, causal, tol)


@pytest.mark.parametrize("lanes", [32, 16, 8, 4, 2, 1])
@pytest.mark.parametrize("br", [128, 64, 32, 16])
@pytest.mark.parametrize("dtype,tol", DW_DTYPES)
def test_dwconv_kernels_at_every_tile(dev, br, lanes, dtype, tol):
    """Each tile dw_plan can pick for K2 (rows x lanes), forced, contiguous
    (dilation 3) and disjoint (dilation 2 * br + 1) windows, P = 3 and P = 4,
    gLN and cLN; a persistent CTA walks several tiles through its window
    buffer."""
    it = torch.finfo(dtype).bits // 8
    for P, norm_type, causal in ((3, "gLN", False), (4, "cLN", False), (4, "gLN", True)):
        d = _dw_case(dev, dtype, norm_type, P, Kp=640, K=555, seed=br + lanes)
        for dil in (3, 2 * br + 1):
            plan = tcn_block.dw_tile(P, dil, 256, it, br, lanes)[1]
            if plan.smem > tcn_block.SMEM_LIMIT:  # e.g. 128 rows x 512 bytes, P * 128 staged
                continue
            _check_dw(d, dil, causal, tol, plan=plan, backward=False)


@pytest.mark.parametrize("bands", [1, 3, 7, 20])
@pytest.mark.parametrize("dtype,tol", DW_DTYPES)
def test_kb2_at_every_strip_shape(dev, bands, dtype, tol):
    """KB2 forced through kb2_strip at one strip an item (K_pad rows), a
    few (the last one shorter), and many (strips of one chunk, shorter than
    the span, so a strip's halo reaches past the strip before it), at a
    span inside one chunk (dilation 3) and over several (65), P = 3 and
    P = 4 (even: taps off centre), gLN and cLN, causal or not; K ends
    inside a strip's last chunk."""
    it = torch.finfo(dtype).bits // 8
    for P, norm_type, causal in ((3, "gLN", False), (4, "cLN", False), (4, "gLN", True),
                                 (3, "cLN", True)):
        d = _dw_case(dev, dtype, norm_type, P, Kp=640, K=555, seed=bands)
        for dil in (3, 65):
            bplan = tcn_block.kb2_strip(P, dil, 256, it, 2, 640, bands)[1]
            assert bplan.bands == bands
            args = (d["y1"], d["s1"], d["a1"], d["g1"], d["b1"], d["w"], d["a2"], norm_type,
                    dil, causal, d["K"])
            _, s2p, cp = tcn_block.dwconv_plain(*args, save=True)
            _check_kb2(d, cp, s2p, dil, causal, tol, bplan)


@pytest.mark.parametrize("shape", [(8, 3199, 3200), (8, 3999, 4096)])
@pytest.mark.parametrize("dtype,tol", DW_DTYPES)
def test_kb2_at_the_train_cells_shapes(dev, shape, dtype, tol):
    """KB2's planned strips at the paper and taslp train cells' shapes
    (batch 8, H = 512, P = 3, gLN) at every dilation 1..128 of the chain."""
    M, K, Kp = shape
    d = _dw_case(dev, dtype, "gLN", 3, M=M, Kp=Kp, K=K, H=512, seed=K)
    for i in range(8):
        args = (d["y1"], d["s1"], d["a1"], d["g1"], d["b1"], d["w"], d["a2"], "gLN", 2 ** i,
                False, K)
        _, s2p, cp = tcn_block.dwconv_plain(*args, save=True)
        _check_kb2(d, cp, s2p, 2 ** i, False, tol)


def test_dwconv_plans_are_what_the_wrappers_take(dev):
    """At the paper widths every plan dw_plan returns for dilations 1..128 is
    a tile test_dwconv_kernels_at_every_tile forces, and every strip plan
    kb2_plan returns at the train cells' shapes is kb2_strip's at its band
    count, on this card's SMs."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for it in (2, 4):
        for i in range(8):
            p = tcn_block.dw_plan(3, 2 ** i, 512, it)
            assert p.rows in (128, 64, 32, 16) and p.lanes in (32, 16, 8, 4, 2, 1)
            for Kp in (3200, 4096):
                s = tcn_block.kb2_plan(3, 2 ** i, 512, it, 8, Kp, sms)
                assert s == tcn_block.kb2_strip(3, 2 ** i, 512, it, 8, Kp, s.bands, sms)[1]


# ---- the streaming separator's CUDA graphs ---------------------------------

STREAM_CFG = dict(N=32, L=16, B=32, H=64, P=3, X=3, R=2, C=2, norm_type="cLN", causal=True)
# Relative L2 of graphed vs eager (the same ops) and of streamed vs offline
# in f32 (the matmuls' summation order at another row count): chip_smoke.py's
# TOL_F32.
STREAM_TOL = 1e-4


def _streamed(sep, x, chunk):
    """Streamed output, and each push's output cloned at once (to show that
    a later replay does not overwrite an earlier output)."""
    outs, snaps = [], []
    for i in range(0, x.shape[1], chunk):
        outs.append(sep.push(x[:, i: i + chunk]))
        snaps.append(outs[-1].clone())
    outs.append(sep.flush())
    snaps.append(outs[-1].clone())
    return torch.cat(outs, dim=-1), torch.cat(snaps, dim=-1)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_graphed_separator_matches_eager_and_offline(dev, compute_dtype):
    from convtasnet_torch.config import ConvTasNetConfig
    from convtasnet_torch.models.conv_tasnet import forward, init_params
    from convtasnet_torch.models.streaming import StreamingSeparator

    cfg = ConvTasNetConfig(compute_dtype=compute_dtype, use_kernels=0, **STREAM_CFG)
    params, state = init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    x = torch.randn((3, 640), generator=torch.Generator().manual_seed(1))
    g = StreamingSeparator(cfg, params, batch=3, device=dev)
    e = StreamingSeparator(cfg, params, batch=3, device=dev, graph=False)
    assert g.graphed and not e.graphed
    got, snaps = _streamed(g, x, 64)
    want, _ = _streamed(e, x, 64)
    assert torch.equal(got, snaps)
    assert _rel_l2(got, want) <= STREAM_TOL
    if compute_dtype == "float32":
        off, _ = forward(params, state, cfg, x.to(dev))
        assert _rel_l2(got, off[..., : got.shape[-1]]) <= STREAM_TOL


def test_graphed_reset_zeroes_state_in_place(dev):
    from convtasnet_torch.config import ConvTasNetConfig
    from convtasnet_torch.models.conv_tasnet import init_params
    from convtasnet_torch.models.streaming import StreamingSeparator, state_leaves

    cfg = ConvTasNetConfig(compute_dtype="float32", **STREAM_CFG)
    params, _ = init_params(torch.Generator(device=dev).manual_seed(2), cfg, device=dev)
    gen = torch.Generator().manual_seed(3)
    a, b = torch.randn((2, 320), generator=gen), torch.randn((2, 480), generator=gen)
    sep = StreamingSeparator(cfg, params, batch=2, device=dev)
    first, _ = _streamed(sep, a, 32)
    ptrs = [t.data_ptr() for t in state_leaves(sep.state)]
    sep.reset()
    assert [t.data_ptr() for t in state_leaves(sep.state)] == ptrs
    assert not any(t.any() for t in state_leaves(sep.state))
    second, _ = _streamed(sep, b, 32)
    fresh_a, _ = _streamed(StreamingSeparator(cfg, params, batch=2, device=dev), a, 32)
    fresh_b, _ = _streamed(StreamingSeparator(cfg, params, batch=2, device=dev), b, 32)
    assert torch.equal(first, fresh_a) and torch.equal(second, fresh_b)


# ---- the stream chunk step's block kernel (csrc/tcn_stream_block.cu) ------

STREAM_CAUSAL = dict(N=256, L=20, B=256, H=512, P=3, X=8, R=4, C=2, norm_type="cLN",
                     causal=True)
# Relative L2, bf16: one block's increment x' - x and its new history, the
# kernel against stream_block_plain (the GEMMs' and the norms' f32 sums in
# another order flip a bf16 rounding now and then; H100 readings over 128
# chunks: worst 1.6e-3 and 1.1e-4); the separator's output and state after
# 32 blocks, the kernel against the library ops, and the streamed output
# against the offline causal forward (H100 readings, four seeds: output
# 0.0091-0.0098, worst state leaf 0.0079-0.0132, against offline
# 0.0092-0.0097, where the library ops read 0.0089-0.0098).
STREAM_BLOCK_TOL = 1e-2
STREAM_KERNEL_TOL = 3e-2


def _stream_launches() -> int:
    return ledger.read(("tcn_stream_block",))["tcn_stream_block"]


def _stream_bp(dev):
    """One block's leaves at the causal widths as the separator holds them:
    the weights and slopes in bf16, the norms' affines in f32."""
    one = [a[0] for a in _blocks(1, B=256, H=512, P=3, device=dev)]
    bf = {"in_w", "in_prelu", "dw_w", "dw_prelu", "out_w"}
    return {k: v.to(torch.bfloat16 if k in bf else torch.float32) for k, v in zip(ORDER, one)}


@pytest.mark.parametrize("M", [1, 4])
@pytest.mark.parametrize("Kc", [1, 15, 300])
@pytest.mark.parametrize("dilation", [2 ** i for i in range(8)])
def test_stream_block_kernel_matches_plain(dev, dilation, Kc, M):
    """Two chunks in a row, the history carried: the kernel's output and
    the history it writes in place against stream_block_plain's, the frames
    carried over from the old history bit for bit; one launch a call."""
    from convtasnet_torch.ops.kernels import stream_block as sb

    bp, bf = _stream_bp(dev), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1000 * dilation + 10 * Kc + M)
    span = 2 * dilation
    hist = torch.randn((M, span, 512), generator=gen, device=dev).to(bf)
    want_h = hist.clone()
    for _ in range(2):
        old = hist.clone()
        x = torch.randn((M, Kc, 256), generator=gen, device=dev).to(bf)
        want, want_h = sb.stream_block_plain(x, want_h, bp, dilation, bf)
        before = _stream_launches()
        got, got_h = sb.stream_block(x, hist, bp, dilation, bf)
        torch.cuda.synchronize()
        assert _stream_launches() == before + 1 and got_h is hist
        assert got.shape == x.shape and torch.isfinite(got.float()).all()
        assert _rel_l2(got.float() - x.float(), want.float() - x.float()) <= STREAM_BLOCK_TOL
        assert _rel_l2(got_h, want_h) <= STREAM_BLOCK_TOL
        if Kc < span:
            assert torch.equal(got_h[:, : span - Kc], old[:, Kc:])


def test_stream_block_kernel_casts_f32_leaves_before_it_reads_them(dev):
    """f32 leaves are cast in the wrapper, and the launch then waits for the
    casts (no programmatic dependent launch): the bf16 leaves' bytes."""
    from convtasnet_torch.ops.kernels import stream_block as sb

    bp, bf = _stream_bp(dev), torch.bfloat16
    f32 = {k: v.float() for k, v in bp.items()}
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2, 16, 256), generator=gen, device=dev).to(bf)
    hist = torch.randn((2, 8, 512), generator=gen, device=dev).to(bf)
    h0, h2 = hist.clone(), torch.empty_like(hist)
    want, _ = sb.stream_block(x, hist, bp, 4, bf)
    for _ in range(3):
        h2.copy_(h0)
        got, _ = sb.stream_block(x, h2, f32, 4, bf)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(h2, hist)


def test_stream_block_kernel_refuses_what_it_is_not_built_for(dev):
    """Widths and dtypes it is not built for raise; its shared memory is
    what the plan (limits.stream_smem) counts, at every built width."""
    from convtasnet_torch.ops.kernels import stream_block as sb
    from convtasnet_torch.ops.kernels.limits import STREAM_WIDTHS, stream_smem

    for B, H in STREAM_WIDTHS:
        for d in (1, 8, 128):
            assert sb._lib().tcn_stream_block_smem(B, H, 3, d) == stream_smem(B, H, 3, 2 * d)

    bp = _stream_bp(dev)
    x = torch.zeros((1, 16, 256), device=dev)
    with pytest.raises(ValueError, match="bf16"):
        sb.stream_block(x, torch.zeros((1, 2, 512), device=dev), bp, 1, torch.float32)
    narrow = {k: v if v.dim() == 0 else v[:256] if k == "out_w" else v[..., :256]
              for k, v in bp.items()}
    with pytest.raises(ValueError, match="built for"):
        sb.stream_block(x.to(torch.bfloat16), torch.zeros((1, 2, 256), dtype=torch.bfloat16,
                                                          device=dev), narrow, 1, torch.bfloat16)


def test_stream_kernel_separator_matches_library_and_offline(dev):
    """The causal config in bf16, two streams of 20 ms chunks: the graphed
    separator on the block kernel against its own eager run bit for bit,
    and against the eager one on the library ops (output, and every state
    leaf in state_leaves' order) and the offline causal forward; R * X
    launches every push, eager, capturing or replayed; reset() zeroes every
    ring in place."""
    from convtasnet_torch.config import ConvTasNetConfig
    from convtasnet_torch.models.conv_tasnet import forward, init_params
    from convtasnet_torch.models import graphed
    from convtasnet_torch.models.streaming import StreamingSeparator, block_form, state_leaves

    graphed.reset_counts()
    cfg = ConvTasNetConfig(**STREAM_CAUSAL)
    lib = ConvTasNetConfig(use_kernels=0, **STREAM_CAUSAL)
    assert block_form(cfg, dev) == "kernel" and block_form(lib, dev) == "library"
    params, state = init_params(torch.Generator(device=dev).manual_seed(6), cfg, device=dev)
    x = torch.randn((2, 160 * 30), generator=torch.Generator().manual_seed(7)) * 0.3
    k = StreamingSeparator(cfg, params, batch=2, device=dev)
    e = StreamingSeparator(cfg, params, batch=2, device=dev, graph=False)
    p = StreamingSeparator(lib, params, batch=2, device=dev, graph=False)
    assert k.graphed and not e.graphed
    NB = cfg.R * cfg.X
    got, eager, want, per_push = [], [], [], []
    for i in range(0, x.shape[1], 160):
        before = _stream_launches()
        got.append(k.push(x[:, i:i + 160]))
        per_push.append(_stream_launches() - before)
        eager.append(e.push(x[:, i:i + 160]))
        want.append(p.push(x[:, i:i + 160]))
    assert per_push == [NB] * len(per_push)
    c = graphed.counts()
    assert (c["eager_calls"], c["captures"], c["replays"]) == (2, 1, len(per_push) - 3)
    assert len(state_leaves(k.state)) == len(state_leaves(p.state)) == 2 + NB
    for i, (a, b) in enumerate(zip(state_leaves(k.state), state_leaves(p.state))):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        assert _rel_l2(a, b) <= STREAM_KERNEL_TOL, i
    got = torch.cat(got + [k.flush()], dim=-1)
    assert torch.equal(got, torch.cat(eager + [e.flush()], dim=-1))
    want = torch.cat(want + [p.flush()], dim=-1)
    assert _rel_l2(got, want) <= STREAM_KERNEL_TOL
    off, _ = forward(params, state, lib, x.to(dev))
    assert _rel_l2(got, off[..., : got.shape[-1]]) <= STREAM_KERNEL_TOL
    ptrs = [t.data_ptr() for t in state_leaves(k.state)]
    k.reset()
    assert [t.data_ptr() for t in state_leaves(k.state)] == ptrs
    assert not any(t.any() for t in state_leaves(k.state))


def test_world1_nccl_dp_step_equals_plain_step(dev, tmp_path):
    """The DP train step of a one-rank NCCL mesh (count and bucket
    all-reduces, the hybrid kernels) gives the plain step's loss, norm and
    parameters bit for bit, in two collectives."""
    import torch.distributed as dist

    from convtasnet_torch.config import ConvTasNetConfig
    from convtasnet_torch.models.conv_tasnet import init_params
    from convtasnet_torch.parallel import comm
    from convtasnet_torch.parallel.mesh import make_mesh
    from convtasnet_torch.training.optim import Optimizer, tree_leaves
    from convtasnet_torch.training.solver import make_train_step

    cfg = ConvTasNetConfig(N=64, L=16, B=128, H=256, X=3, R=1, use_kernels="hybrid")
    params, state = init_params(torch.Generator(device=dev).manual_seed(4), cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    src = torch.randn((3, 2, 4000), generator=gen, device=dev) * 0.3
    mix, lens = src.sum(1), torch.tensor([4000, 4000, 3000], device=dev)
    opt = Optimizer("adam", lr=1e-3)
    plain = make_train_step(cfg, opt, 5.0)(params, opt.init(params), state, mix, src, lens)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        step = make_train_step(cfg, opt, 5.0, make_mesh(device=dev))
        comm.reset_counts()
        got = step(params, opt.init(params), state, mix, src, lens)
        torch.cuda.synchronize()
        assert comm.counts()["collectives"] == 2
    finally:
        dist.destroy_process_group()
    assert torch.equal(got[3], plain[3]) and torch.equal(got[4], plain[4])
    for a, b in zip(tree_leaves(got[0]), tree_leaves(plain[0])):
        assert torch.equal(a, b)


def test_profiler_sees_device_time_around_process_groups(dev):
    """torch.profiler records the card's kernels before, inside and after
    an NCCL group (file store and torchrun's variables), after a profile
    of collectives and after two gloo ranks spawned on the same card."""
    from convtasnet_torch.tools import check_profiler

    assert check_profiler.main(["--scenarios", "nccl", "nccl_env",
                                "nccl_profiled_collective", "spawn_gloo2"]) == 0


# ---- the graphed inference programs (models/graphed.py) ---------------------

GRAPH_CFG = dict(N=64, L=16, B=128, H=256, P=3, X=3, R=2, C=2)


@pytest.mark.parametrize("use_kernels", ["auto", "block"])
def test_graphed_forward_gives_the_eager_kernel_forward_bytes(dev, use_kernels):
    """Every kernel sums in a fixed order, so a replay repeats the eager
    forward's bytes, with the eager forward's launches per replay."""
    from convtasnet_torch.config import ConvTasNetConfig
    from convtasnet_torch.models import graphed
    from convtasnet_torch.models.conv_tasnet import forward, init_params

    cfg = ConvTasNetConfig(use_kernels=use_kernels, **GRAPH_CFG)
    params, state = init_params(torch.Generator(device=dev).manual_seed(6), cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    xs = [torch.randn((2, 4000), generator=gen, device=dev) for _ in range(4)]
    with torch.inference_mode():
        fn = lambda mix: forward(params, state, cfg, mix)[0]  # noqa: E731
        tcn_block.reset_counts()
        want = [fn(x) for x in xs]
        torch.cuda.synchronize()
        eager_launches = {k: v // len(xs) for k, v in tcn_block.counts().items()}
        g = graphed.GraphedForward(fn, tag=(cfg.kernel_form(False, dev),))
        got = [g(x) for x in xs[:2]]        # eager, then capture and replay
        tcn_block.reset_counts()
        graphed.reset_counts()
        got += [g(x) for x in xs[2:]]       # replays
        torch.cuda.synchronize()
    assert graphed.counts()["replays"] == 2 and graphed.counts()["eager_calls"] == 0
    assert tcn_block.counts() == {k: 2 * v for k, v in eager_launches.items()}
    assert eager_launches["tcn_in_gemm"] == cfg.R * cfg.X
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_graphed_keys_sharing_a_pool_replay_in_any_order(dev):
    """The graphs of one wrapper share a memory pool: replaying the keys in
    turn, in an order other than their captures', repeats each key's eager
    bytes."""
    from convtasnet_torch.config import ConvTasNetConfig
    from convtasnet_torch.models import graphed
    from convtasnet_torch.models.conv_tasnet import forward, init_params

    cfg = ConvTasNetConfig(use_kernels="auto", **GRAPH_CFG)
    params, state = init_params(torch.Generator(device=dev).manual_seed(6), cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    xs = [torch.randn(shape, generator=gen, device=dev) for shape in ((2, 4000), (3, 6000))]
    with torch.inference_mode():
        fn = lambda mix: forward(params, state, cfg, mix)[0]  # noqa: E731
        want = [fn(x) for x in xs]
        g = graphed.GraphedForward(fn, tag=(cfg.kernel_form(False, dev),))
        for x in xs:
            g(x), g(x)                      # eager, then capture and replay
        got = [(i, g(xs[i])) for i in (0, 1, 1, 0, 0, 1)]
        torch.cuda.synchronize()
    assert len(g.graphs()) == 2
    for i, out in got:
        assert torch.equal(out, want[i]), i


def test_a_capture_that_synchronises_the_host_raises(dev):
    """A function that reads a value to the host cannot be captured: the
    capture raises GraphError naming the key. In a fresh process, since a
    failed capture can leave the CUDA context unusable."""
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from convtasnet_torch.models import graphed\n"
        "g = graphed.GraphedForward(lambda x: x * float(x.sum()), tag=('whole_tcn',))\n"
        "x = torch.ones(8, device='cuda')\n"
        "g(x)\n"
        "try:\n"
        "    g(x)\n"
        "except graphed.GraphError as e:\n"
        "    print('raised', e)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert "raised capture of key" in out.stdout and "whole_tcn" in out.stdout, (
        out.stdout + out.stderr)


def test_graphed_outputs_survive_the_next_replay(dev):
    from convtasnet_torch.models import graphed

    g = graphed.GraphedForward(lambda a, b: (a + b, a * b))
    xs = [torch.full((1024,), float(v), device=dev) for v in range(5)]
    two = torch.full((1024,), 2.0, device=dev)
    held = [g(x, two) for x in xs]
    torch.cuda.synchronize()
    assert graphed.counts()["graphs"] >= 1 and len(g.graphs()) == 1
    for x, (s, p) in zip(xs, held):
        assert torch.equal(s, x + 2) and torch.equal(p, x * 2)


def _graph_step_runs(dev, n, cap, use_kernels="hybrid", lr_at=None, mesh=None):
    """n Adam steps (of `mesh`'s rank, if given) through a GraphedStep with
    graphed.MAX_GRAPHS = cap (0: every call eager), halving the rate
    (set_lr) before call lr_at; returns (the step, losses, parameters
    before the last call)."""
    from convtasnet_torch.config import ConvTasNetConfig
    from convtasnet_torch.models import graphed
    from convtasnet_torch.models.conv_tasnet import init_params
    from convtasnet_torch.training.optim import Optimizer, set_lr, tree_leaves
    from convtasnet_torch.training.solver import GraphedStep, make_train_step

    cfg = ConvTasNetConfig(use_kernels=use_kernels, **GRAPH_CFG)
    params, state = init_params(torch.Generator(device=dev).manual_seed(6), cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    batches = []
    for _ in range(2):
        src = torch.randn((3, 2, 4000), generator=gen, device=dev) * 0.3
        batches.append((src.sum(1), src, torch.tensor([4000, 3900, 3000], device=dev,
                                                      dtype=torch.int32)))
    opt = Optimizer("adam", lr=1e-3)
    o = opt.init(params)
    step = GraphedStep(make_train_step(cfg, opt, 5.0, mesh), params, o, state,
                       tag=(cfg.kernel_form(True, dev),))
    saved, graphed.MAX_GRAPHS = graphed.MAX_GRAPHS, cap
    p, s, losses, before = params, state, [], None
    try:
        for i in range(n):
            if i == lr_at:
                o = set_lr(o, float(o.lr) / 2)
            before = [t.clone() for t in tree_leaves(p)]
            mix, src, lens = batches[i % 2]
            p, o, s, loss, _ = step(p, o, s, mix, src, lens)
            losses.append(loss)
        torch.cuda.synchronize()
    finally:
        graphed.MAX_GRAPHS = saved
    return step, losses, before


def test_graphed_train_step_gives_the_eager_steps_bytes(dev):
    """Five hybrid steps (eager, capture, three replays) repeat the eager
    steps' losses, parameters and moments bit for bit, one update per call
    and the eager launches per step."""
    from convtasnet_torch.ops.kernels import tcn_block_bwd
    from convtasnet_torch.training.optim import tree_leaves

    e = _graph_step_runs(dev, 5, 0)
    tcn_block.reset_counts()
    tcn_block_bwd.reset_counts()
    g = _graph_step_runs(dev, 5, 16)
    NB = GRAPH_CFG["R"] * GRAPH_CFG["X"]
    assert g[0].graphed.stats()["replays"] == 3 and int(g[0].opt_state.step) == 5
    assert tcn_block.counts()["tcn_dwconv_save"] == 5 * NB
    assert tcn_block_bwd.counts()["tcn_bwd_dwconv"] == 5 * NB
    assert torch.equal(torch.stack(g[1]), torch.stack(e[1]))
    for tree in (lambda s: s.params, lambda s: s.opt_state.mu, lambda s: s.opt_state.nu):
        for a, b in zip(tree_leaves(tree(g[0])), tree_leaves(tree(e[0]))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["paper", "taslp"])
def test_graphed_hybrid_step_gradients_match_eager_autograd(dev, name):
    """A replayed graphed hybrid step (KB2 on its strip plans at every
    dilation 1..128) at the paper and taslp configs, batch 2 x 1 s: each
    gradient leaf of the replay (mu_3 - m * mu_2 of SGD with momentum m, no
    clipping) against eager autograd's (use_kernels 0) at the replay's
    parameters and batch, relative L2 per leaf.

    Paper, f32: 1e-3; H100 readings at seeds 3, 5, 7 up to 4.9e-4, and
    3.5e-2 with KB2's db of one 32-row chunk of one item and channel tile
    read one row late. Taslp, bf16 (its skip modes run bf16 only): 1e-1;
    readings up to 0.093, because bf16 rounding flips compound over 24
    blocks, and 0.106 with that fault. Against the chain's plain stages,
    which round where the kernels do, the readings are as wide (up to
    0.082), so at taslp this mainly checks that the replay runs and agrees
    roughly; KB2's own checks at the taslp shape are
    test_kb2_at_the_train_cells_shapes and chip_smoke.py's KB2 train-cell
    phase."""
    from convtasnet_torch.config import ConvTasNetConfig
    from convtasnet_torch.models import graphed
    from convtasnet_torch.models.conv_tasnet import init_params
    from convtasnet_torch.ops.loss import cal_loss
    from convtasnet_torch.training.optim import Optimizer, tree_leaves, tree_map
    from convtasnet_torch.training.solver import GraphedStep, _forward_fn, make_train_step

    kw, tol = {"paper": (dict(compute_dtype="float32"), 1e-3),
               "taslp": (dict(N=512, L=16, B=128, Sc=128, R=3, encoder_relu=False,
                              input_norm="gLN", mask_nonlinear="sigmoid",
                              compute_dtype="bfloat16"), 1e-1)}[name]
    cfg = ConvTasNetConfig(use_kernels="hybrid", **kw)
    assert cfg.kernel_form(True, dev) == "whole_tcn_train"
    params, state = init_params(torch.Generator(device=dev).manual_seed(3), cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    src = torch.randn((2, 2, 8000), generator=gen, device=dev) * 0.3
    mix, lens = src.sum(1), torch.tensor([8000, 7000], device=dev, dtype=torch.int32)
    momentum = 0.5
    opt = Optimizer("sgd", lr=1e-4, momentum=momentum)
    o = opt.init(params)
    step = GraphedStep(make_train_step(cfg, opt, 1e9), params, o, state,
                       tag=(cfg.kernel_form(True, dev),))
    saved, graphed.MAX_GRAPHS = graphed.MAX_GRAPHS, 16
    try:
        p, s = params, state
        for _ in range(2):  # eager, then captured
            p, o, s, _, _ = step(p, o, s, mix, src, lens)
        before = tree_map(lambda t: t.clone(), p)
        mu2 = [t.clone() for t in tree_leaves(o.mu)]
        p, o, s, _, _ = step(p, o, s, mix, src, lens)  # replayed
        torch.cuda.synchronize()
    finally:
        graphed.MAX_GRAPHS = saved
    assert step.graphed.stats()["replays"] == 1
    got = [m3 - momentum * m2 for m3, m2 in zip(tree_leaves(o.mu), mu2)]
    eager = ConvTasNetConfig(use_kernels=0, **kw)
    leaves_tree = tree_map(lambda t: t.detach().requires_grad_(True), before)
    est, _ = _forward_fn(eager, None, True)(leaves_tree, state, mix)
    loss, *_ = cal_loss(src, est, lens)
    want = torch.autograd.grad(loss, tree_leaves(leaves_tree))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _rel_l2(a, b.float()) <= tol, (i, tuple(b.shape))


def test_graphed_train_step_reads_the_lr_set_in_place(dev):
    """set_lr between two replays: the next replay steps at the halved rate,
    as the eager step does, and half as far as at the full rate."""
    from convtasnet_torch.training.optim import tree_leaves

    runs = [_graph_step_runs(dev, 4, cap, lr_at=lr_at) for cap, lr_at in
            ((16, 3), (0, 3), (16, None))]
    assert runs[0][0].graphed.stats()["replays"] == 2
    deltas = [torch.cat([(a - b).flatten() for a, b in zip(tree_leaves(r[0].params), r[2])])
              for r in runs]
    assert torch.equal(deltas[0], deltas[1])
    assert abs(float(deltas[0].norm() / deltas[2].norm()) - 0.5) < 1e-3


def test_graphed_dp_step_over_nccl_at_world_1(dev, tmp_path):
    """One NCCL rank: the DP hybrid step through a GraphedStep (eager,
    capture, three replays) repeats the eager DP steps and the graphed
    plain steps bit for bit, with the all-reduces recorded in the graph
    and 2 collectives per call, replays included."""
    from convtasnet_torch.parallel import comm, distributed
    from convtasnet_torch.parallel.mesh import make_mesh, steps_graphable
    from convtasnet_torch.training.optim import tree_leaves

    distributed.initialize(f"file://{tmp_path}/store", 1, 0)
    try:
        mesh = make_mesh(1, 1, 1)
        assert steps_graphable(mesh)
        e = _graph_step_runs(dev, 5, 0, mesh=mesh)
        comm.reset_counts()
        g = _graph_step_runs(dev, 5, 16, mesh=mesh)
        assert comm.counts()["collectives"] == 2 * 5
        stats = g[0].graphed.stats()
        assert (stats["captures"], stats["replays"]) == (1, 3)
        assert next(iter(g[0].graphed.graphs().values()))["launches"]["collectives"] == 2
    finally:
        distributed.shutdown()
    plain = _graph_step_runs(dev, 5, 16)
    for other in (e, plain):
        assert torch.equal(torch.stack(g[1]), torch.stack(other[1]))
        for tree in (lambda s: s.params, lambda s: s.opt_state.mu, lambda s: s.opt_state.nu):
            for a, b in zip(tree_leaves(tree(g[0])), tree_leaves(tree(other[0]))):
                assert torch.equal(a, b)


def test_gloo_on_the_card_keeps_the_steps_eager(dev, tmp_path):
    """gloo stages its collectives through the host: a DP mesh over gloo on
    cuda:0 is no mesh for graphed steps."""
    from convtasnet_torch.parallel import distributed
    from convtasnet_torch.parallel.mesh import make_mesh, steps_graphable

    distributed.initialize(f"file://{tmp_path}/store", 1, 0, backend="gloo")
    try:
        assert not steps_graphable(make_mesh(1, 1, 1))
    finally:
        distributed.shutdown()


# ---------------------------------------------------------------------------
# The skip modes (a block with a skip path, the paper's final version) at the
# taslp widths: M = 8 items of K = 3,999 frames (4 s at L = 16), B = 128,
# H = 512, Sc = 128; K3 fold / unfold, KB1 and KW z against their plain
# versions at every GEMM tile plan, KFW and KF, the training op and the
# launch counters.
# ---------------------------------------------------------------------------

def _skip_plans(monkeypatch):
    """Yields with the card's own GEMM plan, then with gemm_plan forced to
    its largest tiles (a card of one SM) and its smallest (unbounded SMs)."""
    yield "card"
    for mod in (tcn_block, tbb):
        monkeypatch.setattr(mod, "_resident", lambda index, mode: ())
    for n in (1, 10 ** 6):
        monkeypatch.setattr(tcn_block, "_sm_count", lambda index, n=n: n)
        monkeypatch.setattr(tbb, "_sm_count", lambda index, n=n: n)
        yield n


def _skip_inputs(dev, norm_type="gLN", causal=False, M=8, Kp=4096, K=3999, B=128, H=512,
                 Sc=128, dilation=2):
    d = _bwd_inputs(dev, torch.bfloat16, norm_type, causal, dilation, K=K, Kp=Kp, M=M, B=B,
                    H=H)
    gen = torch.Generator(device=dev).manual_seed(Sc)
    s = torch.randn((M, Kp, Sc), generator=gen, device=dev)
    s[:, K:] = 0
    gs = torch.randn((M, Kp, Sc), generator=gen, device=dev).to(torch.bfloat16)
    skip_w = torch.randn((H, Sc), generator=gen, device=dev) * 0.1
    e, s2e = tcn_block.dwconv_plain(d["y1"], d["s1"], d["a1"], d["g1"], d["b1"], d["w"],
                                    d["a2"], norm_type, dilation, causal, K)
    return dict(d, s=s.to(torch.bfloat16), gs=gs, skip_w=skip_w, e=e, s2e=s2e)


@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("cLN", True)])
@pytest.mark.parametrize("B,H,Sc", [(128, 512, 128), (256, 512, 128), (128, 256, 256)])
def test_out_gemm_skip_matches_plain(dev, monkeypatch, norm_type, causal, B, H, Sc):
    """K3's skip mode, fold and unfold, at every tile plan: x' and the skip
    sum s' (in place) against the plain version, rows >= K exact zeros in
    both, two launches equal bytes, and the skip counters."""
    d = _skip_inputs(dev, norm_type, causal, B=B, H=H, Sc=Sc)
    K, dt = d["K"], torch.bfloat16
    out_w = d["out_w"].float()
    for fold in (True, False):
        if fold:
            wmat, va, vb = tcn_block.fold_weights(out_w, d["g2"], d["b2"], dt, d["skip_w"])
        else:
            wmat, va, vb = tcn_block.out_weights(out_w, d["skip_w"]).to(dt), d["g2"], d["b2"]
        sp = d["s"].clone()
        want = tcn_block.out_gemm_plain(d["e"], d["s2e"], d["x"], wmat, va, vb, norm_type, K,
                                        fold, skip=sp)
        for tile in _skip_plans(monkeypatch):
            sk = d["s"].clone()
            tcn_block.reset_counts()
            got = tcn_block.tcn_out_gemm(d["e"], d["s2e"], d["x"], wmat, va, vb, norm_type,
                                         K, fold, skip=sk)
            name = "tcn_out_gemm_" + ("fold" if fold else "unfold")
            assert tcn_block.counts()[name + "_skip"] == 1 and tcn_block.counts()[name] == 0
            assert _rel_max(got, want) <= 1.6e-2 and _rel_max(sk, sp) <= 1.6e-2, (fold, tile)
            assert torch.all(got[:, K:] == 0) and torch.all(sk[:, K:] == 0)
            sk2 = d["s"].clone()
            assert torch.equal(tcn_block.tcn_out_gemm(d["e"], d["s2e"], d["x"], wmat, va, vb,
                                                      norm_type, K, fold, skip=sk2), got)
            assert torch.equal(sk2, sk)


@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("cLN", True)])
@pytest.mark.parametrize("B,H,Sc", [(128, 512, 128), (256, 512, 128)])
def test_bwd_dz_skip_matches_plain(dev, monkeypatch, norm_type, causal, B, H, Sc):
    """KB1's skip mode (a depth of B + Sc from g, then g_s) at every tile
    plan, with NaN in the rows >= K of g, g_s and c."""
    d = _skip_inputs(dev, norm_type, causal, B=B, H=H, Sc=Sc)
    K = d["K"]
    red = 1 if norm_type == "gLN" else 2
    wt = tcn_block.out_weights(d["out_w"].float(), d["skip_w"]).t().contiguous().to(torch.bfloat16)
    g, gs, c = d["g"].clone(), d["gs"].clone(), d["c"].clone()
    for t in (g, gs, c):
        t[:, K:] = float("nan")
    args = (g, wt, c, d["s2"], d["a2"], d["g2"], norm_type, K)
    dzp, colp, gs2p = tbb.bwd_dz_plain(*args, gs=gs)
    for tile in _skip_plans(monkeypatch):
        tbb.reset_counts()
        dzk, colk, gs2k = tbb.tcn_bwd_dz(*args, gs=gs)
        assert tbb.counts()["tcn_bwd_dz_skip"] == 1 and tbb.counts()["tcn_bwd_dz"] == 0
        assert _rel_max(dzk, dzp) <= 1.6e-2 and torch.all(dzk[:, K:] == 0), tile
        assert _rel_max(colk.sum(0), colp.sum(0)) <= 1.6e-2, tile
        assert _rel_max(gs2k.sum(red), gs2p.sum(red)) <= 1.6e-2, tile
        again = tbb.tcn_bwd_dz(*args, gs=gs)
        assert all(torch.equal(u, v) for u, v in zip((dzk, colk, gs2k), again)), tile


@pytest.mark.parametrize("plan", ["auto", "one_sm", "splits8_cluster4"])
@pytest.mark.parametrize("norm_type", ["gLN", "cLN"])
@pytest.mark.parametrize("B,H,Sc", [(128, 512, 128), (256, 512, 256)])
def test_wgrad_out_skip_matches_plain(dev, monkeypatch, plan, norm_type, B, H, Sc):
    """KW z's skip mode: d[out_w | skip_w] = z^T [g | g_s], NaN in the rows
    >= K of both cotangents kept out; tiles never straddle the seam."""
    _plan_sms(monkeypatch, plan == "one_sm")
    d = _skip_inputs(dev, norm_type, False, B=B, H=H, Sc=Sc)
    K = d["K"]
    g, gs = d["g"].clone(), d["gs"].clone()
    g[:, K:] = float("nan")
    gs[:, K:] = float("nan")
    z = (d["s2"], d["a2"], d["g2"], d["b2"], norm_type)
    want = tbb.wgrad_plain(d["c"], g, K, z, gs=gs).sum(0)
    forced = WGRAD_PLANS[plan]
    tbb.reset_counts()
    part = tbb.tcn_wgrad(d["c"], g, K, z, plan=forced, gs=gs)
    assert tbb.counts()["tcn_wgrad_out_skip"] == 1 and tbb.counts()["tcn_wgrad_out"] == 0
    assert part.shape[1:] == (H, B + Sc)
    assert _rel_max(part.sum(0), want) <= 1.6e-2
    assert torch.equal(tbb.tcn_wgrad(d["c"], g, K, z, plan=forced, gs=gs), part)
    assert B % tbb.wgrad_launch_plan(d["c"], g, z, gs).bn == 0


def test_fold_weights_skip_matches_plain(dev):
    """KFW's skip kernel over [out_w | skip_w] at the taslp widths: wp bit
    for bit, the folded vectors to f32 order, its own counter."""
    NB, H, B, Sc = 24, 512, 128, 128
    gen = torch.Generator(device=dev).manual_seed(3)
    out_w, skip_w = (torch.randn((NB, H, n), generator=gen, device=dev) * 0.1 for n in (B, Sc))
    g2, b2 = (torch.randn((NB, H), generator=gen, device=dev) for _ in range(2))
    tcn_block.reset_counts()
    got = tcn_block.tcn_fold_weights(out_w, g2, b2, torch.bfloat16, skip_w)
    want = tcn_block.fold_weights(out_w, g2, b2, torch.bfloat16, skip_w)
    assert tcn_block.counts()["tcn_fold_weights_skip"] == 1
    assert tcn_block.counts()["tcn_fold_weights"] == 0
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _skip_params(dev, NB, B, H, Sc, P=3):
    params = _blocks(NB, B=B, H=H, P=P, device=dev)
    gen = torch.Generator(device=dev).manual_seed(NB)
    return params, torch.randn((NB, H, Sc), generator=gen, device=dev) * 0.1


def _train_errors(dev, params, skip_w, x, g, gs, norm_type, causal, X, K):
    """Relative L2 of the training op's kernels against its plain stages:
    [out, dx, the nine block gradients] (+ [s, d skip_w] with skip_w)."""
    res = []
    for plain in (True, False):
        leaves = [p.clone().requires_grad_(True) for p in params]
        sw = None if skip_w is None else skip_w.clone().requires_grad_(True)
        xin = x.clone().requires_grad_(True)
        out, s = whole_tcn_train(xin, *leaves, norm_type, causal, X, valid_k=K, plain=plain,
                                 skip_w=sw)
        if sw is None:
            out.backward(g)
            res.append([out, xin.grad] + [p.grad for p in leaves])
        else:
            torch.autograd.backward((out, s), (g, gs))
            res.append([out, xin.grad] + [p.grad for p in leaves] + [s, sw.grad])
    return [_rel_l2(a.detach(), b.detach()) for a, b in zip(res[1], res[0])]


@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("cLN", True)])
def test_skip_chain_forms_match_plain(dev, norm_type, causal):
    """The whole-TCN fold form (KFW and K3 fold skip) and the training op
    (K3 unfold skip forward; KB1, KW z and KF skip backward) against their
    plain stages at the taslp widths, 8 blocks of batch 2 x 3,999 frames:
    x and the skip sum within 2e-2; in training every output within 3e-2,
    or within twice what the first version's kernels (the same blocks
    without the skip path) read against their own plain stages, where bf16
    rounding carried through 8 blocks' backward reads more (dx)."""
    NB, X, M, K, Kp = 8, 8, 2, 3999, 4096
    params, skip_w = _skip_params(dev, NB, 128, 512, 128)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((M, Kp, 128), generator=gen, device=dev)
    x[:, K:] = 0
    x = x.to(torch.bfloat16)
    with torch.no_grad():
        got = whole_tcn(x, *params, norm_type, causal, X, valid_k=K, skip_w=skip_w)
        want = whole_tcn_reference(x, *params, norm_type, causal, X, valid_k=K, skip_w=skip_w)
    for a, b in zip(got, want):
        assert _rel_l2(a, b) < 2e-2
    g = torch.randn((M, Kp, 128), generator=gen, device=dev).to(torch.bfloat16)
    gs = torch.randn((M, Kp, 128), generator=gen, device=dev).to(torch.bfloat16)
    tbb.reset_counts()
    skip = _train_errors(dev, params, skip_w, x, g, gs, norm_type, causal, X, K)
    c = tbb.counts()
    assert c["tcn_bwd_dz_skip"] == c["tcn_wgrad_out_skip"] == NB and c["tcn_bwd_finish_skip"] >= 1
    assert c["tcn_bwd_dz"] == c["tcn_wgrad_out"] == c["tcn_bwd_finish"] == 0
    first = _train_errors(dev, params, None, x, g, None, norm_type, causal, X, K)
    bound = [max(3e-2, 2 * e) for e in first] + [3e-2, 3e-2]
    assert all(e < b for e, b in zip(skip, bound)), (skip, first)


def test_skip_counters_leave_the_first_versions_alone(dev):
    """A hybrid step of a skip config counts its skip launches under their
    own names; an Sc = 0 step counts exactly the names and numbers it
    always has, and no skip launch."""
    from convtasnet_torch.config import ConvTasNetConfig
    from convtasnet_torch.models.conv_tasnet import forward, init_params
    from convtasnet_torch.ops.loss import cal_loss

    skip_names = ("tcn_out_gemm_unfold_skip", "tcn_out_gemm_fold_skip", "tcn_fold_weights_skip",
                  "tcn_bwd_dz_skip", "tcn_wgrad_out_skip", "tcn_bwd_finish_skip")
    for Sc in (0, 128):
        cfg = ConvTasNetConfig(N=64, L=16, B=128, H=256, P=3, X=3, R=2, C=2, Sc=Sc,
                               use_kernels="hybrid")
        params, _ = init_params(torch.Generator(device=dev).manual_seed(2), cfg, device=dev)
        leaves = []

        def req(t):
            if isinstance(t, dict):
                return {k: req(v) for k, v in t.items()}
            leaves.append(t.requires_grad_(True))
            return t
        params = req(params)
        src = torch.randn((2, 2, 4000), device=dev)
        tcn_block.reset_counts()
        tbb.reset_counts()
        est, _ = forward(params, {}, cfg, src.sum(1), train=True)
        cal_loss(src, est, torch.full((2,), 4000, device=dev))[0].backward()
        counts = {k: v for k, v in {**tcn_block.counts(), **tbb.counts()}.items() if v}
        NB = cfg.R * cfg.X
        moved = {"tcn_in_gemm": 2 * NB, "tcn_dwconv_save": NB, "tcn_bwd_dwconv": NB,
                 "tcn_bwd_dx": NB, "tcn_wgrad_in": NB}
        if Sc:
            moved.update(tcn_out_gemm_unfold_skip=NB, tcn_bwd_dz_skip=NB,
                         tcn_wgrad_out_skip=NB, tcn_bwd_finish_skip=1)
        else:
            moved.update(tcn_out_gemm_unfold=NB, tcn_bwd_dz=NB, tcn_wgrad_out=NB,
                         tcn_bwd_finish=1)
        assert counts == moved, (Sc, counts)
        assert all(t.grad is not None for t in leaves)
        assert not Sc or not any(counts.get(k) for k in skip_names[1:3])
