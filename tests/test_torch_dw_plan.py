"""Tile plan and staged-window arithmetic of the depthwise kernels K2
(tcn_dwconv) and KB2 (tcn_bwd_dwconv), csrc/tcn_dwconv_sm90.cuh, on the CPU.

`dw_plan` is plain Python. The window arithmetic (which row each staged
slot holds, which slot each tap reads) is mirrored here tile by tile in
PyTorch and held against the plain versions, so the indexing the kernels
share with `dw_window` / `dw_stride` / `dw_slot_of` is checked without a
card. The wrappers run on meta tensors up to a recorded launch."""

import itertools

import numpy as np
import pytest
import torch

from convtasnet_torch.ops.kernels import limits
from convtasnet_torch.ops.kernels import tcn_block as tb
from convtasnet_torch.ops.kernels import tcn_block_bwd as tbb
from test_torch_gemm_plan import meta_lib  # noqa: F401 (fixture)

WIDTHS = list(range(128, 1025, 128))
F32 = torch.float32


def _spans(max_span, taps):
    for P in taps:
        for d in (2 ** i for i in range(13)):
            if (P - 1) * d <= max_span:
                yield P, d


FWD_GRID = list(_spans(limits.DWCONV_MAX_SPAN, (1, 2, 3, 4, 5, 8, 9, 17, 33, 257)))
BWD_GRID = list(_spans(limits.BWD_MAX_SPAN, range(1, limits.BWD_MAXP + 1)))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("H", WIDTHS)
def test_plan_fits_shared_memory_wherever_the_limits_admit(H, backward, itemsize):
    """Every (P, dilation) the limits admit gets a tile: shared memory within
    the 227 KB a CTA may use, rows dividing any K_pad, whole 16-byte vectors
    across H, at most DW_MAX_STAGES stages of boxes covering the window."""
    for P, d in (BWD_GRID if backward else FWD_GRID):
        p = tb.dw_plan(P, d, H, itemsize, backward)
        assert p.smem <= tb.SMEM_LIMIT < 227 * 1024, (P, d, p)
        assert tb.ROW_ALIGN % p.rows == 0 and H % p.cols == 0, (P, d, p)
        assert p.cols == p.lanes * 16 // itemsize
        boxes = -(-p.staged // tb.DW_BOX)
        assert 1 <= p.stages <= tb.DW_MAX_STAGES and p.chunk * p.stages >= boxes
        assert p.chunk * (p.stages - 1) < boxes
        span = (P - 1) * d
        assert p.contiguous == (d <= p.rows)
        assert p.staged == (p.rows + span if p.contiguous else P * p.rows) <= P * p.rows


def test_paper_plans():
    """bf16, H=512, P=3: 128 rows x 128 channels (256-byte rows) at every
    dilation of the chain, for K2 and KB2."""
    for bw in (False, True):
        for d in (1, 2, 4, 8, 16, 32, 64, 128):
            p = tb.dw_plan(3, d, 512, 2, bw)
            assert (p.rows, p.cols) == (128, 128) and p.contiguous, (bw, d, p)


@pytest.mark.parametrize("P,d", [(3, 1), (3, 64), (2, 200), (8, 128), (3, 2048), (4097, 1)])
def test_plan_is_the_least_cost_tile_that_fits(P, d):
    """dw_plan picks the tile of least cost key among those that fit."""
    for bw in (False, True):
        if bw and (P > limits.BWD_MAXP or (P - 1) * d > limits.BWD_MAX_SPAN):
            continue
        got = tb.dw_plan(P, d, 512, 2, bw)
        tiles = [tb.dw_tile(P, d, 512, 2, bw, br, lanes)
                 for br, lanes in itertools.product(tb.DW_ROW_TILES, tb.DW_LANES)]
        assert got == min(t for t in tiles if t[1].smem <= tb.SMEM_LIMIT)[1]
        assert (P, d) != (4097, 1) or got.lanes <= 4  # 4,224 staged rows


def test_tile_refuses_a_width_it_does_not_divide():
    with pytest.raises(ValueError, match="no tile"):
        tb.dw_tile(3, 1, 128, 2, False, 128, 32)  # 256 channels over H=128
    with pytest.raises(ValueError, match="no depthwise tile"):
        tb.dw_plan(3, 1, 100, 2)


# ---------------------------------------------------------------------------
# The staged-window arithmetic, mirrored tile by tile against the plain versions
# ---------------------------------------------------------------------------

def _rng_inputs(M, Kp, K, H, P, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.normal(size=shape) * scale + shift).astype(np.float32))

    y1 = t(M, Kp, H)
    y1[:, K:] = float("nan")  # rows past K are never read
    x = dict(y1=y1, a1=torch.full((1,), 0.25), g1=t(H, scale=0.1, shift=1.0), b1=t(H, scale=0.1),
             w=t(P, H, scale=0.3), a2=torch.full((1,), 0.25), g2=t(H, scale=0.1, shift=1.0))
    return x


def _norm_stats(v, norm):
    return tb._sums(v, (1, 2))[:, None, :] if norm == "gLN" else tb._sums(v, -1)[:, :, None, :]


def _mirror_dwconv(y1, s1, a1, g1, b1, w, a2, norm, d, causal, K, plan):
    """K2 as the kernel computes it: per tile, the slots of dw_window staged
    as b (zero outside [0, K)), each output row's taps read at r + p*stride."""
    M, Kp, H = y1.shape
    P = w.shape[0]
    span = (P - 1) * d
    left = span if causal else span // 2
    mean, inv = tbb._norm_terms(s1, norm, K, H)
    mean, inv = mean.expand(M, Kp, 1), inv.expand(M, Kp, 1)
    e = torch.empty_like(y1)
    c = torch.empty_like(y1)
    br, bc, stride = plan.rows, plan.cols, tb.dw_stride(plan, d)
    parts = []
    for m in range(M):
        for k0 in range(0, Kp, br):
            for c0 in range(0, H, bc):
                ch = slice(c0, c0 + bc)
                win = torch.zeros(plan.staged, bc)
                for s, j in enumerate(tb.dw_window(plan, k0 - left, d)):
                    if 0 <= j < K:
                        a = tb._prelu_f32(y1[m, j, ch], a1)
                        win[s] = g1[ch] * ((a - mean[m, j]) * inv[m, j]) + b1[ch]
                acc = torch.zeros(br, bc)
                for p in range(P):
                    acc = acc + win[[r + p * stride for r in range(br)]] * w[p, ch]
                e[m, k0:k0 + br, ch] = tb._prelu_f32(acc, a2)
                c[m, k0:k0 + br, ch] = acc
                ev = e[m, k0:k0 + br, ch] * (torch.arange(k0, k0 + br) < K)[:, None]
                parts.append((m, k0, c0, ev))
    ev = torch.zeros_like(e)
    for m, k0, c0, v in parts:
        ev[m, k0:k0 + br, c0:c0 + bc] = v
    return e, _norm_stats(ev, norm), c


def _mirror_bwd(y1, c, dz, s1, s2, gs2, a1, g1, b1, w, a2, g2, norm, d, causal, K, plan):
    """KB2 as the kernel computes it: per tile, the slots of the dc window
    (base k0 + left - span) staged as dc; db and dw from the same taps at
    r + (P-1-p)*stride, dw over the own rows' b; d_alpha2 from the own rows
    found in the window, or by dw_slot_of's -1 from their own c and dz."""
    M, Kp, H = y1.shape
    P = w.shape[0]
    span = (P - 1) * d
    left = span if causal else span // 2
    m1, i1 = (t.expand(M, Kp, 1) for t in tbb._norm_terms(s1, norm, K, H))
    m2, i2 = (t.expand(M, Kp, 1) for t in tbb._norm_terms(s2, norm, K, H))
    sa, sb = (t.expand(M, Kp, 1) for t in tbb._grad_means(gs2, norm, K, H))
    ehat = (tb._prelu_f32(c, a2) - m2) * i2
    de_all = i2 * (dz * g2 - sa - ehat * sb)
    dc_all = de_all * torch.where(c >= 0, 1.0, a2)
    da2_all = de_all * torch.clamp(c, max=0.0)
    br, bc, stride = plan.rows, plan.cols, tb.dw_stride(plan, d)
    db = torch.zeros_like(y1)
    dw, dg1, db1 = torch.zeros(P, H), torch.zeros(H), torch.zeros(H)
    da2 = torch.zeros(())
    dbg_a, dbg_b = torch.zeros(M, Kp, H), torch.zeros(M, Kp, H)
    for m in range(M):
        for k0 in range(0, Kp, br):
            base = k0 + left - span
            rows = tb.dw_window(plan, base, d)
            own_seen = set()
            for c0 in range(0, H, bc):
                ch = slice(c0, c0 + bc)
                win = torch.zeros(plan.staged, bc)
                for s, j in enumerate(rows):
                    if 0 <= j < K:
                        win[s] = dc_all[m, j, ch]
                        if k0 <= j < k0 + br:
                            da2 = da2 + da2_all[m, j, ch].sum()
                            own_seen.add((j, c0))
                for r in range(br):
                    k = k0 + r
                    if k >= K:
                        continue
                    s = tb.dw_slot_of(plan, base, d, P, k)
                    assert (s >= 0) == ((k, c0) in own_seen)
                    assert s < 0 or rows[s] == k
                    if s < 0:
                        da2 = da2 + da2_all[m, k, ch].sum()
                    ahat = (tb._prelu_f32(y1[m, k, ch], a1) - m1[m, k]) * i1[m, k]
                    bb = g1[ch] * ahat + b1[ch]
                    acc = torch.zeros(bc)
                    for p in range(P):
                        tap = win[r + (P - 1 - p) * stride]
                        acc = acc + w[p, ch] * tap
                        dw[p, ch] += bb * tap
                    db[m, k, ch] = acc
                    dg1[ch] += acc * ahat
                    db1[ch] += acc
                    dbg_a[m, k, ch] = acc * g1[ch]
                    dbg_b[m, k, ch] = acc * g1[ch] * ahat
    chpart = torch.cat([dw, dg1[None], db1[None]])[None]
    return db, chpart, tbb._pair_sums(dbg_a, dbg_b, norm), da2.reshape(1)


def _all_close(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        if a.shape != b.shape:
            a, b = a.sum(0), b.sum(0)
        # sums in another order: f32 rounding of the largest term, relative
        err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        assert err <= 1e-5, (what, i, err)


# (P, dilation): P odd and even; spans below and above (P - 1) * br for br = 16
MIRROR_CASES = [(3, 1), (3, 8), (3, 32), (2, 5), (2, 24), (4, 3), (4, 40), (1, 1)]


@pytest.mark.parametrize("P,d", MIRROR_CASES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("norm", ["gLN", "cLN"])
def test_staged_windows_reproduce_the_plain_versions(P, d, causal, norm):
    """K2 (both modes) and KB2 through the kernels' window arithmetic at a
    tile of 16 rows x 16 channels, contiguous below a span of (P - 1) * 16
    and disjoint above, against dwconv_plain and bwd_dwconv_plain (f32).
    K is not a multiple of the tile's rows; y1's rows >= K are NaN."""
    M, Kp, K, H = 2, 128, 101, 32
    x = _rng_inputs(M, Kp, K, H, P, seed=P * 100 + d)
    y1 = x["y1"]
    s1 = _norm_stats(tb._prelu_f32(torch.nan_to_num(y1, 0.0), x["a1"]), norm)
    fargs = (y1, s1, x["a1"], x["g1"], x["b1"], x["w"], x["a2"], norm, d, causal, K)
    plan = tb.dw_tile(P, d, H, 4, False, 16, 4)[1]   # 16 channels of f32
    assert plan.contiguous == (d <= 16)
    e, s2, c = tb.dwconv_plain(*fargs, save=True)
    me, ms2, mc = _mirror_dwconv(*fargs, plan)
    valid = torch.arange(Kp) < K
    assert torch.equal(me[:, valid], e[:, valid]) and torch.equal(mc[:, valid], c[:, valid])
    _all_close((ms2,), (s2,), "K2 statistics")
    rng = np.random.default_rng(d)
    dz = torch.from_numpy(rng.normal(size=(M, Kp, H)).astype(np.float32))
    gs2 = _norm_stats(dz, norm) * 0.01
    c = c.clone()
    c[:, K:] = float("nan")  # the saved c's pad rows are never read
    bplan = tb.dw_tile(P, d, H, 4, True, 16, 4)[1]
    bargs = (y1, c, dz, s1, s2, gs2, x["a1"], x["g1"], x["b1"], x["w"], x["a2"], x["g2"], norm,
             d, causal, K)
    want = tbb.bwd_dwconv_plain(torch.nan_to_num(y1, 0.0), torch.nan_to_num(c, 0.0), *bargs[2:])
    got = _mirror_bwd(torch.nan_to_num(y1, 0.0), torch.nan_to_num(c, 0.0), *bargs[2:], bplan)
    assert torch.equal(got[0], want[0].float())
    _all_close(got[1:], want[1:], "KB2 partials")


@pytest.mark.parametrize("P,d", [(2, 24), (4, 40), (2, 40)])
def test_own_rows_outside_every_window_exist_only_for_even_taps(P, d):
    """Non-causal, P even, dilation > br: some own rows lie in no window, and
    dw_slot_of says so (KB2 then loads their c and dz for d_alpha2); odd P
    or causal: every own row is in the window."""
    plan = tb.dw_tile(P, d, 32, 4, True, 16, 4)[1]
    for causal in (False, True):
        span = (P - 1) * d
        left = span if causal else span // 2
        base = 64 + left - span
        missing = [k for k in range(64, 80) if tb.dw_slot_of(plan, base, d, P, k) < 0]
        assert bool(missing) == (not causal and P % 2 == 0 and left % d != 0)
    odd = tb.dw_tile(3, d, 32, 4, True, 16, 4)[1]
    assert all(tb.dw_slot_of(odd, 64 + d - 2 * d, d, 3, k) >= 0 for k in range(64, 80))


# ---------------------------------------------------------------------------
# The wrappers pass the plan and shape the partials the consumers read
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("norm", ["gLN", "cLN"])
@pytest.mark.parametrize("d", [1, 64, 128])
@pytest.mark.parametrize("save", [False, True])
def test_k2_launches_its_plan_and_shapes_its_statistics(meta_lib, norm, d, save):
    M, Kp, H, B = 8, 3200, 512, 256
    plan = tb.dw_plan(3, d, H, 2)
    s1 = _meta(M, 7, 2, dtype=F32) if norm == "gLN" else _meta(M, Kp, 2, 2, dtype=F32)
    v = _meta(H, dtype=F32)
    out = tb.tcn_dwconv(_meta(M, Kp, H), s1, _meta(1, dtype=F32), v, v, _meta(3, H, dtype=F32),
                        _meta(1, dtype=F32), norm, d, False, 3199, save=save)
    name, args = meta_lib.calls[-1]
    assert name == "tcn_dwconv" and args[-7:-1] == (plan.rows, plan.lanes, plan.staged,
                                                    plan.chunk, plan.stages, plan.smem)
    nct = H // plan.cols
    stats = out[1]
    assert stats.shape == ((M, Kp // plan.rows * nct, 2) if norm == "gLN" else (M, Kp, nct, 2))
    # K3 and KB1 read whatever count of partials the tile gave
    tb.tcn_out_gemm(out[0], stats, _meta(M, Kp, B), _meta(H, B), v, v, norm, 3199, False)
    assert meta_lib.calls[-1][1][5] == stats.shape[1 if norm == "gLN" else 2]
    tbb.tcn_bwd_dz(_meta(M, Kp, B), _meta(B, H), _meta(M, Kp, H), stats, _meta(1, dtype=F32), v,
                   norm, 3199)
    assert meta_lib.calls[-1][1][6] == stats.shape[1 if norm == "gLN" else 2]


@pytest.mark.parametrize("norm", ["gLN", "cLN"])
@pytest.mark.parametrize("d", [1, 16, 128])
def test_kb2_launches_its_plan_and_shapes_its_partials(meta_lib, norm, d):
    M, Kp, H, B, P = 5, 3200, 512, 256, 3
    plan = tb.dw_plan(P, d, H, 2, backward=True)
    s = _meta(M, 9, 2, dtype=F32) if norm == "gLN" else _meta(M, Kp, 4, 2, dtype=F32)
    v = _meta(H, dtype=F32)
    a = _meta(1, dtype=F32)
    db, chpart, gs1, da2 = tbb.tcn_bwd_dwconv(_meta(M, Kp, H), _meta(M, Kp, H), _meta(M, Kp, H),
                                              s, s, s, a, v, v, _meta(P, H, dtype=F32), a, v,
                                              norm, d, False, 3199)
    name, args = meta_lib.calls[-1]
    assert name == "tcn_bwd_dwconv" and args[-7:-1] == (plan.rows, plan.lanes, plan.staged,
                                                        plan.chunk, plan.stages, plan.smem)
    nct = H // plan.cols
    ntile = M * Kp // plan.rows
    assert db.shape == (M, Kp, H) and chpart.shape == (ntile, P + 2, H)
    assert da2.shape == (ntile * nct,)
    assert gs1.shape == ((M, Kp // plan.rows * nct, 2) if norm == "gLN" else (M, Kp, nct, 2))
    tbb.tcn_bwd_dx(db, _meta(M, Kp, H), _meta(H, B), _meta(M, Kp, B), s, gs1, a, v, norm, 3199)
    assert meta_lib.calls[-1][1][9] == gs1.shape[1 if norm == "gLN" else 2]


def test_wrappers_take_a_forced_tile_and_refuse_one_that_does_not_fit(meta_lib):
    M, Kp, H = 2, 384, 256
    s1, v, a = _meta(M, 1, 2, dtype=F32), _meta(H, dtype=F32), _meta(1, dtype=F32)
    forced = tb.dw_tile(3, 4, H, 2, False, 32, 2)[1]
    tb.tcn_dwconv(_meta(M, Kp, H), s1, a, v, v, _meta(3, H, dtype=F32), a, "gLN", 4, False, 300,
                  plan=forced)
    assert meta_lib.calls[-1][1][-7] == 32
    big = tb.dw_tile(4097, 1, H, 2, False, 128, 32)[1]  # 4,224 rows of 512 bytes
    assert big.smem > tb.SMEM_LIMIT
    with pytest.raises(ValueError, match="does not fit"):
        tb.tcn_dwconv(_meta(M, Kp, H), s1, a, v, v, _meta(4097, H, dtype=F32), a, "gLN", 1,
                      False, 300, plan=big)
