"""KF (tcn_bwd_finish), the backward of one block into stacked gradients,
and the chain-level training ops, on the CPU (f32, small widths).

- bwd_finish_plain (and the KF wrapper, which takes it on a CPU tensor)
  against the `.sum`s it replaces, bit for bit, on random partials of
  each layout;
- block_bwd writing row nb of stacked gradients against the sums of its
  stages' partials, bit for bit, the other rows untouched;
- whole_tcn_train (hybrid) and whole_chain_train (whole) against the JAX
  package's whole_tcn_train and its scan over whole_block_train (Pallas in
  interpret mode), and against the per-block op they replace;
- one train step with use_kernels "whole" against the JAX step through
  training/solver.make_train_step;
- on meta tensors, with a stand-in kernel library: the kernel path's
  launches per block, and that neither backward runs any torch op but
  views and allocations inside its per-block loop.

Tolerances: rtol 5e-4 / atol 5e-5 on forwards and losses, rtol 2e-3 /
atol 5e-4 on gradients (tests/test_pallas_tcn.py's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import convtasnet_tpu
from convtasnet_torch.config import ConvTasNetConfig
from convtasnet_torch.models import conv_tasnet as tm
from convtasnet_torch.ops.kernels import tcn_block as tb
from convtasnet_torch.ops.kernels import tcn_block_bwd as tbb
from convtasnet_torch.ops.kernels.whole_block_vjp import whole_block_train, whole_chain_train
from convtasnet_torch.ops.kernels.whole_tcn_hybrid import (chain_bwd, chain_forward,
                                                           whole_tcn_bwd, whole_tcn_train)
from convtasnet_torch.training import optim as to
from convtasnet_torch.training.solver import make_train_step
from convtasnet_tpu.ops.pallas import whole_block_vjp as j_vjp
from convtasnet_tpu.ops.pallas import whole_tcn_hybrid as j_tcn
from convtasnet_tpu.training import optim as jo
from convtasnet_tpu.training.solver import make_train_step as j_make_train_step
from test_torch_gemm_plan import meta_lib  # noqa: F401 (fixture)

torch.set_num_threads(1)
FWD = dict(rtol=5e-4, atol=5e-5)
GRAD = dict(rtol=2e-3, atol=5e-4)
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


def _inputs(seed, NB, K, Kp, M=2):
    rng = np.random.default_rng(seed)
    ps = _params(rng, NB)
    x = np.zeros((M, Kp, B), np.float32)
    x[:, :K] = rng.normal(size=(M, K, B)) * 0.5
    g = np.zeros((M, Kp, B), np.float32)
    g[:, :K] = rng.normal(size=(M, K, B))
    return ps, x, g


def _nan_grads(NB):
    """Stacked gradients (tbb.GRAD_ORDER) full of NaN."""
    shapes = [(NB, B, H), (NB,), (NB, H), (NB, H), (NB, P, H), (NB,), (NB, H), (NB, H),
              (NB, H, B)]
    return [torch.full(s, float("nan")) for s in shapes]


# ---------------------------------------------------------------------------
# KF's plain version and block_bwd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", [tbb.bwd_finish_plain, tbb.tcn_bwd_finish])
@pytest.mark.parametrize("n_kw,n_tile", [(1, 1), (7, 125), (28, 3)])
def test_bwd_finish_plain_is_the_sums_it_replaces(fn, n_kw, n_tile):
    """A group of three slots of random partials of each layout (KW z /
    din, KB2's chpart and da2part, KB1's colpart, KB3's da1part), the
    slots holding fewer KB2 partials than the buffers (as a dilation with
    a taller tile writes): rows nb0 ... nb0 + 2 hold exactly the `.sum`s
    of each slot's partials, every other row is untouched."""
    rng = np.random.default_rng(n_kw * 1000 + n_tile)
    cap = tbb.PartCounts(n_kw, n_kw, n_tile + 2, n_tile + 1, n_tile + 2, 4 * n_tile + 3)
    slots = tbb.FinishSlots.alloc(4, cap, B, H, P, "cpu")
    for t in slots:
        t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)))
    counts = [cap, cap._replace(nch=n_tile, nda2=4 * n_tile), cap._replace(nch=1, nda2=1)]
    NB, nb0 = 5, 1
    grads = _nan_grads(NB)
    fn(slots, counts, grads, nb0)
    for j, n in enumerate(counts):
        wz, win, chpart, colpart, da1p, da2p = slots.slot(j, n)
        chs, cols = chpart.sum(0), colpart.sum(0)
        want = [win.sum(0), da1p.sum(), chs[P], chs[P + 1], chs[:P], da2p.sum(), cols[0],
                cols[1], wz.sum(0)]
        for name, got, w in zip(tbb.GRAD_ORDER, grads, want):
            assert torch.equal(got[nb0 + j], w), (name, j)
    for name, got in zip(tbb.GRAD_ORDER, grads):
        assert torch.isnan(got[:nb0]).all() and torch.isnan(got[nb0 + 3:]).all(), name


def test_finish_group_fills_the_cap():
    """Blocks per KF launch: as many slots as fit FINISH_SLOTS_CAP, at most
    NB and the kernel's FIN_MAX_GROUP; the paper config's partials (batch
    5 x 4 s, bf16, an H100's plans) take one group of 32 blocks."""
    paper = tbb.PartCounts(7, 7, 125, 125, 125, 500)
    nbytes = tbb.slot_bytes(paper, 256, 512, 3)
    assert 8e6 < nbytes < 10e6
    assert tbb.finish_group(32, nbytes) == 32
    assert tbb.finish_group(60, 4 * nbytes) == tbb.FINISH_SLOTS_CAP // (4 * nbytes) < 60
    assert tbb.finish_group(200, 1) == tbb.FIN_MAX_GROUP
    assert tbb.finish_group(5, 10 ** 12) == 1


@pytest.mark.parametrize("norm_type,causal", NORM_CAUSAL)
def test_block_bwd_writes_row_nb_of_the_stacked_gradients(norm_type, causal):
    """block_bwd with the plain stages: dx and row nb of the stacked
    gradients equal, bit for bit, the stages' outputs with their partials
    summed (what block_bwd returned before KF); the other rows untouched."""
    K, Kp, d = 200, 256, 2
    ps, x, g = _inputs(7 + causal, 1, K, Kp)
    in_w, a1, g1, b1, w, a2, g2, b2, out_w = [torch.from_numpy(np.array(p[0])) for p in ps]
    x, g = torch.from_numpy(x), torch.from_numpy(g)
    y1, s1 = tb.in_gemm_plain(x, in_w, a1, norm_type)
    _, s2, c = tb.dwconv_plain(y1, s1, a1, g1, b1, w, a2, norm_type, d, causal, K, save=True)
    in_wt, out_wt = in_w.t().contiguous(), out_w.t().contiguous()
    dz, colpart, gs2 = tbb.bwd_dz_plain(g, out_wt, c, s2, a2, g2, norm_type, K)
    wz = tbb.wgrad_plain(c, g, K, (s2, a2, g2, b2, norm_type))
    db, chpart, gs1, da2p = tbb.bwd_dwconv_plain(y1, c, dz, s1, s2, gs2, a1, g1, b1, w, a2,
                                                 g2, norm_type, d, causal, K)
    dx, dy1, da1p = tbb.bwd_dx_plain(db, y1, in_wt, g, s1, gs1, a1, g1, norm_type, K)
    win = tbb.wgrad_plain(x, dy1, K)
    chs, cols = chpart.sum(0), colpart.sum(0)
    want = [win.sum(0), da1p.sum(), chs[P], chs[P + 1], chs[:P], da2p.sum(), cols[0],
            cols[1], wz.sum(0)]
    NB, nb = 4, 2
    grads = _nan_grads(NB)
    got_dx = tbb.block_bwd(g, x, y1, s1, c, s2, in_wt, a1, g1, b1, w, a2, g2, b2, out_wt,
                           norm_type, d, causal, K, grads, nb, tbb.PLAIN_BWD)
    assert torch.equal(got_dx, dx)
    assert float(got_dx[:, K:].abs().max()) == 0.0
    for name, got, v in zip(tbb.GRAD_ORDER, grads, want):
        assert torch.equal(got[nb], v), name
        assert torch.isnan(got[:nb]).all() and torch.isnan(got[nb + 1:]).all(), name


# ---------------------------------------------------------------------------
# The chain ops against the JAX package and against the per-block op
# ---------------------------------------------------------------------------

def _jax_grads(fn, x, ps, g):
    out, vjp = jax.vjp(fn, jnp.asarray(x), *[jnp.asarray(p) for p in ps])
    return np.asarray(out), [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _torch_grads(fn, x, ps, g):
    leaves = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in [x] + list(ps)]
    out = fn(*leaves)
    return out.detach().numpy(), [v.numpy() for v in
                                  torch.autograd.grad(out, leaves, torch.from_numpy(g))]


def _jax_whole_chain(x, *ps, norm_type, causal, X, vk):
    """The JAX model's whole form: whole_block_train block after block, as
    its scan over the repeats runs it (models/conv_tasnet.py:317-392)."""
    for nb in range(ps[0].shape[0]):
        x = j_vjp.whole_block_train(x, *[p[nb] for p in ps], norm_type, 2 ** (nb % X),
                                    causal, True, vk)
    return x


@pytest.mark.parametrize("form", ["hybrid", "whole"])
@pytest.mark.parametrize("norm_type,causal", NORM_CAUSAL)
def test_chain_ops_match_jax(form, norm_type, causal):
    """Forward output and the ten gradients of the port's chain op for
    `form` (X=2, R=2: four blocks, two repeats) against the JAX op."""
    X, NB, Kp = 2, 4, 256
    K = 200 if causal else 256
    ps, x, g = _inputs(31 + 2 * causal + (norm_type == "cLN"), NB, K, Kp)
    vk = K if K != Kp else None
    if form == "hybrid":
        jfn = lambda *a: j_tcn.whole_tcn_train(*a, norm_type, causal, X, True, vk)  # noqa: E731
        tfn = lambda *a: whole_tcn_train(*a, norm_type, causal, X, valid_k=K)[0]  # noqa: E731
    else:
        jfn = lambda x, *p: _jax_whole_chain(x, *p, norm_type=norm_type,  # noqa: E731
                                             causal=causal, X=X, vk=vk)
        tfn = lambda *a: whole_chain_train(*a, norm_type, causal, X, valid_k=K)  # noqa: E731
    want, wgrads = _jax_grads(jfn, x, ps, g)
    got, ggrads = _torch_grads(tfn, x, ps, g)
    np.testing.assert_allclose(got, want, **FWD)
    names = ("dx",) + tbb.GRAD_ORDER
    assert len(ggrads) == len(wgrads) == 10
    for name, a, b in zip(names, ggrads, wgrads):
        np.testing.assert_allclose(a.reshape(b.shape), b, **GRAD, err_msg=name)


@pytest.mark.parametrize("group", [1, 3, 4])
@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("cLN", True)])
def test_grouped_finish_matches_jax(group, norm_type, causal):
    """The whole-TCN backward with KF's plain form finishing groups of 1,
    3 (two groups, the last of one block) and NB = 4 blocks: dx and the
    nine stacked gradients against the JAX op's VJP (Pallas in interpret
    mode), and the same bits whatever the group."""
    X, NB, Kp, K = 2, 4, 256, 200
    ps, x, g = _inputs(51 + causal, NB, K, Kp)
    jfn = lambda *a: j_tcn.whole_tcn_train(*a, norm_type, causal, X, True, K)  # noqa: E731
    _, wgrads = _jax_grads(jfn, x, ps, g)
    tx = torch.from_numpy(x)
    params = [torch.from_numpy(np.array(p)) for p in ps]
    _, x_res, c_res, s2 = chain_forward(tx, *params, norm_type, causal, X, K)
    got = whole_tcn_bwd(torch.from_numpy(g), x_res, c_res, s2, *params, norm_type, causal, X,
                        K, group=group)
    for name, a, b in zip(("dx",) + tbb.GRAD_ORDER, got, wgrads):
        np.testing.assert_allclose(a.numpy().reshape(b.shape), b, **GRAD, err_msg=name)
    one = whole_tcn_bwd(torch.from_numpy(g), x_res, c_res, s2, *params, norm_type, causal, X,
                        K, group=1)
    assert all(torch.equal(a, b) for a, b in zip(got, one))


@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("cLN", True)])
def test_whole_chain_matches_the_per_block_ops(norm_type, causal):
    """The chain op against the NB per-block Functions the model ran
    before it (views of the stacked leaves), on the same leaves."""
    X, NB, Kp, K = 2, 4, 256, 200
    ps, x, g = _inputs(41, NB, K, Kp)

    def per_block(x, *leaves):
        for nb in range(NB):
            x = whole_block_train(x, *[a[nb] for a in leaves], norm_type, 2 ** (nb % X),
                                  causal, valid_k=K)
        return x

    want, wgrads = _torch_grads(per_block, x, ps, g)
    got, ggrads = _torch_grads(
        lambda *a: whole_chain_train(*a, norm_type, causal, X, valid_k=K), x, ps, g)
    np.testing.assert_allclose(got, want, **FWD)
    for a, b in zip(ggrads, wgrads):
        np.testing.assert_allclose(a, b, **FWD)


# ---------------------------------------------------------------------------
# One train step, use_kernels "whole", against JAX
# ---------------------------------------------------------------------------

SMALL = dict(N=16, L=4, B=128, H=128, P=3, X=2, R=2, C=2, compute_dtype="float32")


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)


@pytest.mark.parametrize("norm_type", ["gLN", "cLN"])
def test_whole_train_step_matches_jax(norm_type):
    """Loss, gradient norm and the SGD update of one step with
    use_kernels "whole" (two repeats of two blocks) against JAX's
    make_train_step with use_pallas "whole"; the model takes the chain op."""
    assert ConvTasNetConfig(norm_type=norm_type, use_kernels="whole", **SMALL).kernel_form(
        True, "cpu") == "whole_block_train"
    jcfg = convtasnet_tpu.ConvTasNetConfig(norm_type=norm_type, use_pallas="whole", **SMALL)
    params, state = convtasnet_tpu.init_params(jax.random.key(3), jcfg)
    rng = np.random.default_rng(3)
    M, T = 2, 402
    src = (rng.normal(size=(M, 2, T)) * 0.3).astype(np.float32)
    mix = src.sum(1)
    lens = np.array([T, T - 61], np.int32)
    tp, ts = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                jax.tree_util.tree_map(np.asarray, state), "cpu")
    jopt = jo.Optimizer("sgd", lr=0.1, momentum=0.9)
    jstep = j_make_train_step(convtasnet_tpu.ConvTasNet(jcfg), jopt, max_norm=5.0)
    jp, _, _, jl, jgn = jstep(params, jopt.init(params), state, jnp.asarray(mix),
                              jnp.asarray(src), jnp.asarray(lens))
    cfg = ConvTasNetConfig(norm_type=norm_type, use_kernels="whole", **SMALL)
    topt = to.Optimizer("sgd", lr=0.1, momentum=0.9)
    step = make_train_step(cfg, topt, max_norm=5.0)
    new_p, _, _, tl, tgn = step(tp, topt.init(tp), ts, torch.from_numpy(mix),
                                torch.from_numpy(src), torch.from_numpy(lens))
    np.testing.assert_allclose(float(tl), float(jl), **FWD)
    np.testing.assert_allclose(float(tgn), float(jgn), **GRAD)
    for want, got in zip(_leaves(jp), _leaves(new_p)):
        np.testing.assert_allclose(got, want, **FWD)


# ---------------------------------------------------------------------------
# The kernel path on meta tensors: launches and torch ops per block
# ---------------------------------------------------------------------------

# Torch ops that launch nothing on a card: views and allocations.
NO_LAUNCH = ("aten::view", "aten::_unsafe_view", "aten::select", "aten::slice",
             "aten::reshape", "aten::alias", "aten::empty", "aten::empty_like",
             "aten::unsqueeze", "aten::detach", "aten::as_strided", "aten::squeeze",
             "aten::lift_fresh")


class _Log(TorchDispatchMode):
    """Records every torch op, in order with the stand-in's launches."""

    def __init__(self, events):
        super().__init__()
        self.events = events

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.events.append(("op", func._schema.name))
        return func(*args, **(kwargs or {}))


def _meta_chain(meta_lib, form, NB, dt, group=None):
    """The kernel path of `form` on meta tensors: (forward events, backward
    events), each a list of ("op", name) and ("launch", name); `group`
    forces the blocks per KF launch."""
    X, M, Kp, K = 2, 2, 384, 300
    f32 = dict(dtype=torch.float32, device="meta")
    shapes = [(NB, B, H), (NB,), (NB, H), (NB, H), (NB, P, H), (NB,), (NB, H), (NB, H),
              (NB, H, B)]
    params = [torch.empty(s, **f32) for s in shapes]
    x = torch.empty((M, Kp, B), dtype=dt, device="meta")
    g = torch.empty((M, Kp, B), dtype=torch.float32, device="meta")
    events = []
    calls = meta_lib.calls
    seen = len(calls)

    def drain():
        nonlocal seen
        events.extend(("launch", name) for name, _ in calls[seen:])
        seen = len(calls)

    class Log(_Log):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            drain()
            return super().__torch_dispatch__(func, types, args, kwargs)

    save = form == "hybrid"
    with Log(events):
        _, x_res, c_res, s2 = chain_forward(x, *params, "gLN", False, X, K, save=save)
    drain()
    fwd, events[:] = list(events), []
    with Log(events):
        res = chain_bwd(g, x_res, c_res, s2, params, "gLN", False,
                        [2 ** (nb % X) for nb in range(NB)], K, group=group)
    drain()
    assert res[0].shape == x.shape and [r.shape for r in res[1:]] == [p.shape for p in params]
    return fwd, list(events)


PER_BLOCK = {
    ("hybrid", "fwd"): ["tcn_in_gemm", "tcn_dwconv", "tcn_out_gemm"],
    ("whole", "fwd"): ["tcn_in_gemm", "tcn_dwconv", "tcn_out_gemm"],
    ("hybrid", "bwd"): ["tcn_in_gemm", "tcn_bwd_dz", "tcn_wgrad", "tcn_bwd_dwconv",
                        "tcn_bwd_dx", "tcn_wgrad"],
    ("whole", "bwd"): ["tcn_in_gemm", "tcn_dwconv", "tcn_bwd_dz", "tcn_wgrad",
                       "tcn_bwd_dwconv", "tcn_bwd_dx", "tcn_wgrad"],
}


def _want_launches(form, side, NB, group):
    """The kernels per block, NB times, and on the backward one KF after
    each group's last block (groups of `group` from block NB-1 down; None:
    one group, the meta shapes' slots being far under the cap)."""
    per = PER_BLOCK[(form, side)]
    if side == "fwd":
        return per * NB
    G = group or NB
    want = []
    for nb in range(NB - 1, -1, -1):
        want += per
        if (NB - 1 - nb) % G == G - 1 or nb == 0:
            want.append("tcn_bwd_finish")
    return want


@pytest.mark.parametrize("form", ["hybrid", "whole"])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [None, 3])
def test_per_block_loops_launch_only_the_kernels(meta_lib, form, dt, group):
    """Forward and backward of each chain op: the hand-written kernels in
    order, NB times, and KF once per group of blocks (one group; or groups
    of three, the last one short); between the first launch and the last
    only views and allocations (no reduction, stack, cast, transpose or
    copy); before the first launch the same torch ops whatever NB (the
    once-per-call casts, transposes and copies, and the slots' buffers)."""
    heads = {}
    for NB in (2, 4):
        for side, events in zip(("fwd", "bwd"), _meta_chain(meta_lib, form, NB, dt, group)):
            launches = [n for kind, n in events if kind == "launch"]
            assert launches == _want_launches(form, side, NB, group), (side, launches)
            first = next(i for i, e in enumerate(events) if e[0] == "launch")
            last = max(i for i, e in enumerate(events) if e[0] == "launch")
            loop_ops = {n for kind, n in events[first:last] if kind == "op"}
            assert loop_ops <= set(NO_LAUNCH), (side, loop_ops - set(NO_LAUNCH))
            head = [n for kind, n in events[:first] if n not in NO_LAUNCH]
            heads.setdefault(side, []).append(head)
    for side, (h2, h4) in heads.items():
        assert h2 == h4, side


@pytest.mark.parametrize("norm_type", ["gLN", "cLN"])
@pytest.mark.parametrize("d,itemsize", [(1, 2), (64, 2), (128, 4)])
def test_dwconv_stats_shape_is_what_k2_returns(meta_lib, norm_type, d, itemsize):
    """chain_forward preallocates every block's K2 partials by
    dwconv_stats_shape: the shape tcn_dwconv gives its plan, and the plain
    version's."""
    M, Kp = 5, 3200
    dt = torch.bfloat16 if itemsize == 2 else torch.float32
    f32 = dict(dtype=torch.float32, device="meta")
    s1 = torch.empty((M, 1, 2) if norm_type == "gLN" else (M, Kp, 1, 2), **f32)
    v, a = torch.empty(512, **f32), torch.empty(1, **f32)
    _, stats = tb.tcn_dwconv(torch.empty((M, Kp, 512), dtype=dt, device="meta"), s1, a, v, v,
                             torch.empty((3, 512), **f32), a, norm_type, d, False, 3199)
    assert stats.shape == tb.dwconv_stats_shape(M, Kp, 512, 3, d, itemsize, norm_type, False)
    y1 = torch.zeros((M, 256, 128))
    s1 = tb.in_gemm_plain(y1, torch.zeros(128, 128), torch.zeros(1), norm_type)[1]
    _, plain = tb.dwconv_plain(y1, s1, torch.zeros(1), *[torch.zeros(128)] * 2,
                               torch.zeros(3, 128), torch.zeros(1), norm_type, d, False, 200)
    assert plain.shape == tb.dwconv_stats_shape(M, 256, 128, 3, d, 4, norm_type, True)
