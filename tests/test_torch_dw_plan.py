"""Plans and index arithmetic of the depthwise kernels K2 (tcn_dwconv), a
staged stencil, and KB2 (tcn_bwd_dwconv), a streaming stencil down strips
of rows, csrc/tcn_dwconv_sm90.cuh, on the CPU.

`dw_plan` and `kb2_plan` are plain Python. K2's window arithmetic (which
row each staged slot holds, which slot each tap reads) and KB2's strip and
ring arithmetic (which rows each load chunk brings, which ring row each tap
of each own row reads) are mirrored here in PyTorch, tile by tile and
strip by strip, and held against the plain versions, so the indexing the
kernels share with `dw_window` / `dw_stride` and `kb2_load_rows` /
`kb2_tap_slots` is checked without a card. The wrappers run on meta
tensors up to a recorded launch."""

import itertools

import numpy as np
import pytest
import torch

from convtasnet_torch.ops.kernels import limits
from convtasnet_torch.ops.kernels import tcn_block as tb
from convtasnet_torch.ops.kernels import tcn_block_bwd as tbb
from test_torch_gemm_plan import H100_SMS, meta_lib  # noqa: F401 (fixture)

WIDTHS = list(range(128, 1025, 128))
F32 = torch.float32


def _spans(max_span, taps):
    for P in taps:
        for d in (2 ** i for i in range(13)):
            if (P - 1) * d <= max_span:
                yield P, d


FWD_GRID = list(_spans(limits.DWCONV_MAX_SPAN, (1, 2, 3, 4, 5, 8, 9, 17, 33, 257)))
BWD_GRID = list(_spans(limits.BWD_MAX_SPAN, range(1, limits.BWD_MAXP + 1)))
# (M, K_pad): the train cells' (paper, taslp), the card tests', one item of
# one row tile
BWD_SHAPES = [(8, 3200), (8, 4096), (5, 3200), (2, 1280), (1, 128)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("H", WIDTHS)
def test_plan_fits_shared_memory_wherever_the_limits_admit(H, backward, itemsize):
    """Every (P, dilation) the limits admit gets a plan. K2's tile: shared
    memory within the 227 KB a CTA may use, rows dividing any K_pad, whole
    16-byte vectors across H, at most DW_MAX_STAGES stages of boxes covering
    the window. KB2's strips (P 1..8, span <= 1,024), at each shape of
    BWD_SHAPES: shared memory for the load stages, the dc ring (the span in
    chunks, plus one) and the f32 taps within a CTA's 227 KB, whole 16-byte vectors
    across H, chunks that divide K_pad and that every row group shares
    evenly, strips that cover the item, the last one ending at K_pad."""
    if not backward:
        for P, d in FWD_GRID:
            p = tb.dw_plan(P, d, H, itemsize)
            assert p.smem <= tb.SMEM_LIMIT < 227 * 1024, (P, d, p)
            assert tb.ROW_ALIGN % p.rows == 0 and H % p.cols == 0, (P, d, p)
            assert p.cols == p.lanes * 16 // itemsize
            boxes = -(-p.staged // tb.DW_BOX)
            assert 1 <= p.stages <= tb.DW_MAX_STAGES and p.chunk * p.stages >= boxes
            assert p.chunk * (p.stages - 1) < boxes
            span = (P - 1) * d
            assert p.contiguous == (d <= p.rows)
            assert p.staged == (p.rows + span if p.contiguous else P * p.rows) <= P * p.rows
        return
    for (P, d), (M, Kp) in itertools.product(BWD_GRID, BWD_SHAPES):
        p = tb.kb2_plan(P, d, H, itemsize, M, Kp, H100_SMS)
        span = (P - 1) * d
        groups = tb.KB2_CONSUMERS // tb.KB2_VECS
        assert p.smem <= tb.SMEM_LIMIT < 227 * 1024, (P, d, p)
        assert p.cols == tb.KB2_VECS * 16 // itemsize and H % p.cols == 0
        assert p.chunk % groups == 0 and Kp % p.chunk == 0 and p.strip % p.chunk == 0
        assert p.ring == -(-span // p.chunk) + 1 and p.ring * p.chunk >= span + p.chunk
        assert p.bands == -(-Kp // p.strip) and (p.bands - 1) * p.strip < Kp <= p.bands * p.strip
        assert p.grid == M * p.bands * (H // p.cols)
        assert (p.chunk, p.stages) == (tb.KB2_CHUNK, tb.KB2_STAGES) == (32, 2)
        assert p.smem == (tb.DW_HEAD + (3 * p.stages + p.ring) * p.chunk * tb.KB2_VECS * 16
                          + P * p.cols * 4)  # the stages, the dc ring, the f32 taps


def test_paper_plans():
    """K2, bf16, H=512, P=3: 128 rows x 128 channels (256-byte rows) at
    every dilation of the chain."""
    for d in (1, 2, 4, 8, 16, 32, 64, 128):
        p = tb.dw_plan(3, d, 512, 2)
        assert (p.rows, p.cols) == (128, 128) and p.contiguous, (d, p)


@pytest.mark.parametrize("Kp", [3200, 4096])
def test_kb2_train_cell_plans(Kp):
    """KB2 at the train cells' shapes (batch 8, bf16, H=512, P=3; paper
    K_pad 3,200, taslp 4,096) on 132 SMs: rows of 128 bytes (64
    channels), chunks of 32 rows, two stages, six strips an item, 384 CTAs
    (three an SM) at every dilation 1..128, the ring growing with the
    span."""
    for d in (1, 2, 4, 8, 16, 32, 64, 128):
        p = tb.kb2_plan(3, d, 512, 2, 8, Kp, H100_SMS)
        assert (p.cols, p.chunk, p.stages, p.bands, p.grid) == (64, 32, 2, 6, 384), (d, p)
        assert p.strip == -(-Kp // (6 * 32)) * 32 and p.ring == -(-2 * d // 32) + 1
        assert tb.kb2_resident(3, p.smem) == 3


@pytest.mark.parametrize("P,d", [(3, 1), (3, 64), (2, 200), (8, 128), (3, 2048), (4097, 1)])
def test_plan_is_the_least_cost_tile_that_fits(P, d):
    """dw_plan picks the K2 tile of least cost key among those that fit."""
    got = tb.dw_plan(P, d, 512, 2)
    tiles = [tb.dw_tile(P, d, 512, 2, br, lanes)
             for br, lanes in itertools.product(tb.DW_ROW_TILES, tb.DW_LANES)]
    assert got == min(t for t in tiles if t[1].smem <= tb.SMEM_LIMIT)[1]
    assert (P, d) != (4097, 1) or got.lanes <= 4  # 4,224 staged rows


@pytest.mark.parametrize("P,d", [(3, 1), (3, 64), (2, 200), (8, 128), (3, 512), (1, 1)])
def test_kb2_plan_is_the_least_cost_strip_that_fits(P, d):
    """kb2_plan picks the band count of least cost, the most strips among
    equal costs, among those with at most twice the CTAs the card holds at
    once (or one strip an item); the halo the strips load twice is in the
    cost, so where it outweighs a fuller card fewer strips win."""
    M, Kp = 8, 3200
    got = tb.kb2_plan(P, d, 512, 2, M, Kp, H100_SMS)
    cands = []
    for bands in range(1, Kp // tb.KB2_CHUNK + 1):
        cost, plan = tb.kb2_strip(P, d, 512, 2, M, Kp, bands, H100_SMS)
        held = H100_SMS * tb.kb2_resident(P, plan.smem)
        if plan.bands == bands and (bands == 1 or plan.grid <= 2 * held):
            cands.append((cost, -bands, plan))
    assert got == min(cands)[2] and got.smem <= tb.SMEM_LIMIT
    # one item of 1,280 rows at span 512: fewer strips than a full card
    # holds, each strip's halo being 16 chunks
    small = tb.kb2_plan(3, 256, 512, 2, 1, 1280, H100_SMS)
    assert small.grid < H100_SMS * tb.kb2_resident(3, small.smem) and small.bands < 1280 // 32


def test_tile_refuses_a_width_it_does_not_divide():
    with pytest.raises(ValueError, match="no tile"):
        tb.dw_tile(3, 1, 128, 2, 128, 32)  # 256 channels over H=128
    with pytest.raises(ValueError, match="no depthwise tile"):
        tb.dw_plan(3, 1, 100, 2)


def test_kb2_strip_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="no strip"):
        tb.kb2_strip(3, 1, 32, 2, 1, 128, 1)       # 64 channels over H=32
    with pytest.raises(ValueError, match="no strip"):
        tb.kb2_strip(3, 1, 512, 2, 1, 144, 1)      # K_pad not whole chunks
    with pytest.raises(ValueError, match="no strip"):
        tb.kb2_strip(3, 1, 512, 2, 1, 128, 0)      # no strip an item
    with pytest.raises(ValueError, match="no strip plan"):
        tb.kb2_plan(9, 1, 512, 2, 1, 128, H100_SMS)       # compiled for 1..8 taps


# ---------------------------------------------------------------------------
# K2's staged windows and KB2's strips, mirrored against the plain versions
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


def _mirror_kb2(y1, c, dz, s1, s2, gs2, a1, g1, b1, w, a2, g2, norm, d, causal, K, plan):
    """KB2 as the kernel computes it, CTA by CTA in launch order (item,
    strip, channel tile): the load chunks of kb2_load_rows converted into
    dc ring rows (q mod ring) * chunk + x, rows outside [0, K) zero; each
    own row's taps read at kb2_tap_slots (asserted to hold row k + left -
    p*d); d_alpha2 of the converted rows inside the strip; one partial of
    each kind per CTA, in the kernel's layouts."""
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
    bc, ch, pre = plan.cols, plan.chunk, plan.ring - 1
    nct = H // bc
    db = torch.zeros_like(y1)
    chpart = torch.zeros(M * plan.bands, P + 2, H)
    da2part = torch.zeros(plan.grid)
    W = tb.KB2_WARPS
    gs1 = torch.zeros((M, plan.bands * nct, 2) if norm == "gLN" else (M, Kp, nct * W, 2))
    cta = 0
    for m in range(M):
        for band in range(plan.bands):
            k_begin = band * plan.strip
            k_end = min(Kp, k_begin + plan.strip)
            loads = tb.kb2_load_rows(plan, Kp, band, left, span)
            assert len(loads) == (k_end - k_begin) // ch + pre
            for ct in range(nct):
                chs = slice(ct * bc, ct * bc + bc)
                ring = torch.full((plan.ring * ch, bc), float("nan"))
                held = [None] * (plan.ring * ch)
                dw, dg1, db1 = torch.zeros(P, bc), torch.zeros(bc), torch.zeros(bc)
                da2 = ts = tss = 0.0
                for q, (jq, yq) in enumerate(loads):
                    for x in range(ch):
                        j, slot = jq + x, (q % plan.ring) * ch + x
                        ring[slot] = dc_all[m, j, chs] if 0 <= j < K else 0.0
                        held[slot] = j
                        if 0 <= j < K and k_begin <= j < k_end:
                            da2 = da2 + da2_all[m, j, chs].sum()
                    if yq is None:
                        continue
                    i = q - pre
                    assert yq == k_begin + i * ch
                    for r in range(ch):
                        k = yq + r
                        slots = tb.kb2_tap_slots(plan, d, span, P, i, r)
                        assert [held[s] for s in slots] == [k + left - p * d for p in range(P)]
                        acc = torch.zeros(bc)
                        for p in range(P):
                            acc = acc + w[p, chs] * ring[slots[p]]
                        if k >= K:
                            continue
                        ahat = (tb._prelu_f32(y1[m, k, chs], a1) - m1[m, k]) * i1[m, k]
                        bb = g1[chs] * ahat + b1[chs]
                        for p in range(P):
                            dw[p] += bb * ring[slots[p]]
                        db[m, k, chs] = acc
                        dg1 += acc * ahat
                        db1 += acc
                        dbg = acc * g1[chs]
                        if norm == "gLN":
                            ts, tss = ts + dbg.sum(), tss + (dbg * ahat).sum()
                        else:  # a pair per warp's quarter of the tile's channels
                            for wq in range(W):
                                qs = slice(wq * bc // W, (wq + 1) * bc // W)
                                gs1[m, k, ct * W + wq] = torch.stack(
                                    [dbg[qs].sum(), (dbg * ahat)[qs].sum()])
                row = m * plan.bands + band
                chpart[row, :P, chs] = dw
                chpart[row, P, chs] = dg1
                chpart[row, P + 1, chs] = db1
                da2part[cta] = da2
                if norm == "gLN":
                    gs1[m, band * nct + ct] = torch.stack([torch.as_tensor(ts),
                                                           torch.as_tensor(tss)])
                cta += 1
    assert cta == plan.grid
    return db, chpart, gs1, da2part


def _close(a, b, what):
    """Sums in another order: f32 rounding of the largest term, relative."""
    err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    assert err <= 1e-5, (what, err)


def _bwd_inputs(P, d, causal, norm, M=2, Kp=128, K=101, H=64):
    """y1 (rows >= K NaN) and the plain K2's c and norm2 partials at one
    dilation, dz and KB1-like partials, the block parameters (f32)."""
    x = _rng_inputs(M, Kp, K, H, P, seed=P * 100 + d)
    y1 = x["y1"]
    s1 = _norm_stats(tb._prelu_f32(torch.nan_to_num(y1, 0.0), x["a1"]), norm)
    fargs = (y1, s1, x["a1"], x["g1"], x["b1"], x["w"], x["a2"], norm, d, causal, K)
    return x, s1, fargs


# (P, dilation): P odd and even; spans below, at and above a chunk and a strip
MIRROR_CASES = [(3, 1), (3, 8), (3, 32), (2, 5), (2, 24), (4, 3), (4, 40), (1, 1)]


@pytest.mark.parametrize("P,d", MIRROR_CASES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("norm", ["gLN", "cLN"])
def test_staged_windows_reproduce_the_plain_versions(P, d, causal, norm):
    """K2 (both modes) through the kernel's window arithmetic at a tile of
    16 rows x 16 channels, contiguous below a span of (P - 1) * 16 and
    disjoint above, against dwconv_plain (f32). K is not a multiple of the
    tile's rows; y1's rows >= K are NaN."""
    M, Kp, K, H = 2, 128, 101, 32
    x = _rng_inputs(M, Kp, K, H, P, seed=P * 100 + d)
    y1 = x["y1"]
    s1 = _norm_stats(tb._prelu_f32(torch.nan_to_num(y1, 0.0), x["a1"]), norm)
    fargs = (y1, s1, x["a1"], x["g1"], x["b1"], x["w"], x["a2"], norm, d, causal, K)
    plan = tb.dw_tile(P, d, H, 4, 16, 4)[1]   # 16 channels of f32
    assert plan.contiguous == (d <= 16)
    e, s2, c = tb.dwconv_plain(*fargs, save=True)
    me, ms2, mc = _mirror_dwconv(*fargs, plan)
    valid = torch.arange(Kp) < K
    assert torch.equal(me[:, valid], e[:, valid]) and torch.equal(mc[:, valid], c[:, valid])
    _close(ms2.sum(0), s2.sum(0), "K2 statistics")


# (K_pad, bands) at H = 64 in f32 (two channel tiles of 32), K = 101: four
# strips of one 32-row chunk (K inside the last); two strips of 96 and 64
# rows (K inside the second, shorter one)
STRIP_CASES = [(128, 4), (160, 2)]


@pytest.mark.parametrize("P,d", MIRROR_CASES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("norm", ["gLN", "cLN"])
def test_strip_rings_reproduce_the_plain_version(P, d, causal, norm):
    """KB2 through the kernel's strip and ring arithmetic against
    bwd_dwconv_plain (f32) at two strip shapes: db bit for bit (the taps
    summed in the same order), every partial's total; strips shorter than
    the span (their halo reaches strips back), a last strip shorter than
    the others, K inside a strip, y1's, c's and dz's rows >= K NaN and
    never read."""
    K = 101
    red = 1 if norm == "gLN" else 2
    for Kp, bands in STRIP_CASES:
        x, s1, fargs = _bwd_inputs(P, d, causal, norm, Kp=Kp, K=K)
        M, _, H = x["y1"].shape
        _, s2, c = tb.dwconv_plain(*fargs, save=True)
        rng = np.random.default_rng(d)
        dz = torch.from_numpy(rng.normal(size=(M, Kp, H)).astype(np.float32))
        gs2 = _norm_stats(dz, norm) * 0.01
        c, dz = c.clone(), dz.clone()
        c[:, K:] = dz[:, K:] = float("nan")
        tail = (s1, s2, gs2, x["a1"], x["g1"], x["b1"], x["w"], x["a2"], x["g2"], norm, d,
                causal, K)
        clean = [torch.nan_to_num(t, 0.0) for t in (x["y1"], c, dz)]
        want = tbb.bwd_dwconv_plain(*clean, *tail)
        plan = tb.kb2_strip(P, d, H, 4, M, Kp, bands)[1]
        assert plan.bands == bands
        db, chpart, gs1, da2 = _mirror_kb2(x["y1"], c, dz, *tail, plan)
        assert torch.equal(db, want[0].float()), plan
        _close(chpart.sum(0), want[1].sum(0), "KB2 channel partials")
        _close(gs1.sum(red), want[2].sum(red), "KB2 norm1 sums")
        _close(da2.sum(), want[3].sum(), "KB2 d_alpha2")


@pytest.mark.parametrize("P,d", [(2, 24), (4, 40), (2, 40), (8, 128), (3, 512)])
@pytest.mark.parametrize("bands", [1, 2, 7])
def test_the_ring_holds_every_tap_until_it_is_read(P, d, bands):
    """A consumer warp converts load chunk q + 1 into its dc ring only after
    the taps of own chunk q - pre: for every own chunk, its taps' ring rows
    hold the rows they name, and the ring rows the next load chunk
    overwrites hold only rows that no later own chunk reads; causal or not,
    at every strip of an item."""
    plan = tb.kb2_strip(P, d, 512, 2, 1, 2048, bands)[1]
    chunk, span = plan.chunk, (P - 1) * d
    pre, R = plan.ring - 1, plan.ring * chunk
    for causal in (False, True):
        left = span if causal else span // 2
        for band in range(plan.bands):
            loads = tb.kb2_load_rows(plan, 2048, band, left, span)
            held = {}
            for q, (jq, yq) in enumerate(loads):
                for x in range(chunk):
                    held[(q % plan.ring) * chunk + x] = jq + x
                if yq is None:
                    continue
                i = q - pre
                for r in range(chunk):
                    slots = tb.kb2_tap_slots(plan, d, span, P, i, r)
                    assert all(0 <= s < R for s in slots)
                    assert [held[s] for s in slots] == [yq + r + left - p * d for p in range(P)]
                lowest_later = yq + chunk + left - span  # own chunk i + 1's lowest tap
                nxt = {((q + 1) % plan.ring) * chunk + x for x in range(chunk)}
                assert all(held[s] < lowest_later for s in nxt if s in held), (band, q)


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
    """KB2 passes kb2_plan's strip plan and returns one channel-partial row
    per strip, one d_alpha2 partial per CTA and one norm1 pair per CTA
    (gLN) or per row and consumer warp's quarter of a channel tile (cLN);
    KB3 reads that count, and part_counts (KF's slots) gives the same
    counts."""
    M, Kp, H, B, P = 8, 3200, 512, 256, 3
    plan = tb.kb2_plan(P, d, H, 2, M, Kp, H100_SMS)
    s = _meta(M, 9, 2, dtype=F32) if norm == "gLN" else _meta(M, Kp, 4, 2, dtype=F32)
    v = _meta(H, dtype=F32)
    a = _meta(1, dtype=F32)
    db, chpart, gs1, da2 = tbb.tcn_bwd_dwconv(_meta(M, Kp, H), _meta(M, Kp, H), _meta(M, Kp, H),
                                              s, s, s, a, v, v, _meta(P, H, dtype=F32), a, v,
                                              norm, d, False, 3199)
    name, args = meta_lib.calls[-1]
    assert name == "tcn_bwd_dwconv" and args[-7:-1] == (plan.chunk, plan.stages, plan.ring,
                                                        plan.strip, plan.bands, plan.smem)
    nct = H // plan.cols
    assert db.shape == (M, Kp, H) and chpart.shape == (M * plan.bands, P + 2, H)
    assert da2.shape == (plan.grid,) == (M * plan.bands * nct,)
    assert gs1.shape == ((M, plan.bands * nct, 2) if norm == "gLN"
                         else (M, Kp, nct * tb.KB2_WARPS, 2))
    tbb.tcn_bwd_dx(db, _meta(M, Kp, H), _meta(H, B), _meta(M, Kp, B), s, gs1, a, v, norm, 3199)
    assert meta_lib.calls[-1][1][9] == gs1.shape[1 if norm == "gLN" else 2]
    n = tbb.part_counts(M, Kp, B, H, P, d, torch.float32, False, 0)
    f32 = tb.kb2_plan(P, d, H, 4, M, Kp, H100_SMS)
    assert (n.nch, n.nda2) == (M * f32.bands, f32.grid)


def test_wrappers_take_a_forced_tile_and_refuse_one_that_does_not_fit(meta_lib):
    M, Kp, H = 2, 384, 256
    s1, v, a = _meta(M, 1, 2, dtype=F32), _meta(H, dtype=F32), _meta(1, dtype=F32)
    forced = tb.dw_tile(3, 4, H, 2, 32, 2)[1]
    tb.tcn_dwconv(_meta(M, Kp, H), s1, a, v, v, _meta(3, H, dtype=F32), a, "gLN", 4, False, 300,
                  plan=forced)
    assert meta_lib.calls[-1][1][-7] == 32
    big = tb.dw_tile(4097, 1, H, 2, 128, 32)[1]  # 4,224 rows of 512 bytes
    assert big.smem > tb.SMEM_LIMIT
    with pytest.raises(ValueError, match="does not fit"):
        tb.tcn_dwconv(_meta(M, Kp, H), s1, a, v, v, _meta(4097, H, dtype=F32), a, "gLN", 1,
                      False, 300, plan=big)


def test_kb2_takes_a_forced_strip_plan_and_refuses_one_that_does_not_fit(meta_lib):
    """A plan forced through kb2_strip reaches the launch and shapes the
    partials; one made for another shape (fewer rows, or other items) is
    refused before any launch."""
    M, Kp, H, P = 2, 384, 256, 3
    s, v, a = _meta(M, 1, 2, dtype=F32), _meta(H, dtype=F32), _meta(1, dtype=F32)
    args = (_meta(M, Kp, H), _meta(M, Kp, H), _meta(M, Kp, H), s, s, s, a, v, v,
            _meta(P, H, dtype=F32), a, v, "gLN")
    forced = tb.kb2_strip(P, 4, H, 2, M, Kp, 3)[1]
    _, chpart, _, da2 = tbb.tcn_bwd_dwconv(*args, 4, False, 300, plan=forced)
    assert meta_lib.calls[-1][1][-7:-1] == (32, 2, forced.ring, 128, 3, forced.smem)
    assert chpart.shape[0] == M * 3 and da2.shape == (M * 3 * 4,)
    short = tb.kb2_strip(P, 4, H, 2, M, 256, 2)[1]   # made for 256 rows
    with pytest.raises(ValueError, match="does not fit"):
        tbb.tcn_bwd_dwconv(*args, 4, False, 300, plan=short)
    other = tb.kb2_strip(P, 4, H, 2, 5, Kp, 3)[1]    # made for 5 items
    with pytest.raises(ValueError, match="does not fit"):
        tbb.tcn_bwd_dwconv(*args, 4, False, 300, plan=other)
