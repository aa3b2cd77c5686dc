"""Launch planning of the bf16 wgmma kernels (K1 tcn_in_gemm, K3
tcn_out_gemm, KB1 tcn_bwd_dz, KB3 tcn_bwd_dx) and the wrappers' refusals,
on the CPU.

`gemm_plan` is plain Python: it picks the rows and columns per CTA from the
row count. The refusals run before any device work, so they are exercised
with meta tensors (the same code path as CUDA tensors)."""

import pytest
import torch

from convtasnet_torch.ops.kernels import tcn_block as tb
from convtasnet_torch.ops.kernels import tcn_block_bwd as tbb

H100_SMS = 132
# CTAs resident per SM on an H100 (cudaOccupancyMaxActiveBlocksPerMultiprocessor
# at each kernel's shared memory, chip_smoke.py): one for every tile of every
# mode but K1's 64 x 128, whose ring holds y1 and leaves room for two.
H100_RESIDENT = {tb.H_IN: (((64, 128), 2),)}


@pytest.mark.parametrize("batch,split,want", [
    (8, True, (128, 256)),    # 200 row tiles, two waves
    (5, True, (128, 256)),    # 125 row tiles, one wave
    (3, True, (128, 256)),
    (2, True, (64, 256)),     # 100 CTAs of 64 rows beat 50 of 128
    (1, True, (64, 128)),     # 100 CTAs: full width would leave 82 SMs idle
    (1, False, (64, 256)),    # KB3: never split the columns
    (8, False, (128, 256)),
])
def test_plan_at_the_paper_widths(batch, split, want):
    assert tb.gemm_plan(batch * 3200, 256, 512, H100_SMS, split=split) == want


@pytest.mark.parametrize("rows,ncols,sms,want", [
    (1152, 128, H100_SMS, (64, 128)),   # M=3, K_pad=384 at the test width
    (1152, 128, 1, (128, 128)),         # one SM: the larger tile, fewer CTAs
    (1152, 256, 1, (128, 256)),
    (1152, 256, 10 ** 6, (64, 128)),    # one wave whatever the tile: the smallest
    (256, 512, H100_SMS, (64, 128)),    # B=512: four column tiles
    (256, 384, H100_SMS, (64, 128)),    # B=384 is not a multiple of 256
])
def test_plan_follows_rows_and_columns(rows, ncols, sms, want):
    bm, bn = tb.gemm_plan(rows, ncols, 512, sms)
    assert (bm, bn) == want
    assert rows % bm == 0 and ncols % bn == 0


def test_plan_without_split_keeps_256_columns():
    """KB3 at B=512: two column tiles of 256; only the first stores dy1."""
    assert tb.gemm_plan(256, 512, 512, H100_SMS, split=False) == (64, 256)


def test_plan_is_a_function_of_the_shape():
    """Same shape, same plan: the launch (and the partials' layout) repeats."""
    plans = {tb.gemm_plan(r, 256, 512, H100_SMS) for r in [25600] * 3}
    assert len(plans) == 1


@pytest.mark.parametrize("rows,ncols", [(128, 96), (100, 256), (0, 256)])
def test_plan_refuses_untileable_shapes(rows, ncols):
    with pytest.raises(ValueError):
        tb.gemm_plan(rows, ncols, 512, H100_SMS)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_out_gemm_refuses_an_unsupported_width():
    e = _meta(1, 128, 512)
    with pytest.raises(ValueError, match="multiples of 128"):
        tb.tcn_out_gemm(e, _meta(1, 1, 2, dtype=torch.float32), _meta(1, 128, 96),
                        _meta(512, 96), _meta(96, dtype=torch.float32),
                        _meta(96, dtype=torch.float32), "gLN", 128, True)


def test_out_gemm_refuses_a_hidden_width_beyond_the_staged_vectors():
    H = 2 * tb.GEMM_MAX_H
    e = _meta(1, 128, H)
    with pytest.raises(ValueError, match="bf16 GEMM kernels"):
        tb.tcn_out_gemm(e, _meta(1, 1, 2, dtype=torch.float32), _meta(1, 128, 128),
                        _meta(H, 128), _meta(H, dtype=torch.float32),
                        _meta(H, dtype=torch.float32), "gLN", 128, False)


def test_bwd_dx_refuses_a_hidden_width_beyond_the_staged_vectors():
    H = 2 * tb.GEMM_MAX_H
    f32 = torch.float32
    with pytest.raises(ValueError, match="bf16 GEMM kernels"):
        tbb.tcn_bwd_dx(_meta(1, 128, H), _meta(1, 128, H), _meta(H, 128), _meta(1, 128, 128),
                       _meta(1, 1, 2, dtype=f32), _meta(1, 1, 2, dtype=f32),
                       _meta(1, dtype=f32), _meta(H, dtype=f32), "gLN", 128)


def test_bwd_dx_refuses_an_unsupported_width():
    f32 = torch.float32
    with pytest.raises(ValueError, match="multiples of 128"):
        tbb.tcn_bwd_dx(_meta(1, 128, 512), _meta(1, 128, 512), _meta(512, 96),
                       _meta(1, 128, 96), _meta(1, 1, 2, dtype=f32), _meta(1, 1, 2, dtype=f32),
                       _meta(1, dtype=f32), _meta(512, dtype=f32), "gLN", 128)


# ---------------------------------------------------------------------------
# K1 (tcn_in_gemm, epilogue tile y1) and KB1 (tcn_bwd_dz, tiles c and dz)
# on the same pipeline: [rows, 256] @ [256, 512] at the paper widths.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,mode,want", [
    (8, tb.H_IN, (64, 128)),     # K1: two CTAs per SM, 1,600 of them in 7 waves
    (5, tb.H_IN, (64, 128)),
    (1, tb.H_IN, (64, 128)),
    (8, tb.H_DZ, (128, 256)),    # KB1: 400 CTAs in 4 waves, two warpgroups each
    (5, tb.H_DZ, (128, 256)),    # 250 CTAs, two waves
    (1, tb.H_DZ, (64, 256)),     # 100 CTAs, one wave: the smaller of equal costs
])
def test_k1_kb1_plans_at_the_paper_widths(batch, mode, want):
    io_tiles = 1 if mode == tb.H_IN else 2
    resident = H100_RESIDENT.get(mode, ())
    assert tb.gemm_plan(batch * 3200, 512, 256, H100_SMS, io_tiles=io_tiles,
                        resident=resident) == want


def test_the_plan_counts_resident_ctas():
    """K1's 64 x 128 tile, two CTAs per SM, against the same kernel counted
    at one per SM: 7 waves of 264 CTAs beat 13 of 132 (and 4 of 128 x 256)."""
    assert tb.gemm_plan(25600, 512, 256, H100_SMS, io_tiles=1) == (128, 256)
    assert tb.gemm_plan(25600, 512, 256, H100_SMS, io_tiles=1,
                        resident=(((64, 128), 2),)) == (64, 128)
    # a failed occupancy query (-1) counts one CTA per SM
    assert tb.gemm_plan(25600, 512, 256, H100_SMS, io_tiles=1,
                        resident=(((64, 128), -1),)) == (128, 256)


def test_the_epilogue_tiles_weigh_in_the_plan():
    """One SM: the cost is CTAs times bytes per CTA, so the larger tile
    wins whatever the epilogue; many SMs (one wave for every tile): the
    smallest tile, whose bytes are least."""
    for io in (1, 2):
        assert tb.gemm_plan(25600, 512, 256, 1, io_tiles=io) == (128, 256)
        assert tb.gemm_plan(25600, 512, 256, 10 ** 6, io_tiles=io) == (64, 128)


class _Lib:
    """Stands in for the compiled library: records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def meta_lib(monkeypatch):
    """The wrappers on meta tensors, up to a recorded launch (the checks of
    device and contiguity accept meta tensors; KW's card query of resident
    clusters and KFW's of resident CTAs answer nothing)."""
    lib = _Lib()

    def check_meta(*ts, dtype=None):
        for t in ts:
            tb._require(t.device.type == "meta" and t.is_contiguous(), "meta tensors expected")
            if dtype is not None:
                tb._require(t.dtype == dtype, f"expected {dtype}, got {t.dtype}")

    for mod in (tb, tbb):
        monkeypatch.setattr(mod, "_lib", lambda: lib)
        monkeypatch.setattr(mod, "_check_cuda", check_meta)
        monkeypatch.setattr(mod, "_sm_count", lambda index: H100_SMS)
        monkeypatch.setattr(mod, "_stream", lambda t: 0)
        monkeypatch.setattr(mod, "_resident", lambda index, mode: H100_RESIDENT.get(mode, ()))
    monkeypatch.setattr(tbb, "_max_clusters", lambda index, n_cols: ())
    monkeypatch.setattr(tb, "_fold_resident", lambda index, code: 0)
    return lib


F32 = torch.float32


@pytest.mark.parametrize("norm", ["gLN", "cLN"])
@pytest.mark.parametrize("batch", [8, 5, 1])
def test_k1_launches_its_plan_and_shapes_its_partials(meta_lib, batch, norm):
    """bf16 K1 passes gemm_plan's tile (y1 the one epilogue tile) and gets
    one statistics pair per row and column tile (cLN) or per CTA (gLN)."""
    Kp, B, H = 3200, 256, 512
    bm, bn = tb.gemm_plan(batch * Kp, H, B, H100_SMS, io_tiles=1,
                          resident=H100_RESIDENT[tb.H_IN])
    y1, stats = tb.tcn_in_gemm(_meta(batch, Kp, B), _meta(B, H), _meta(1, dtype=F32), norm)
    name, args = meta_lib.calls[-1]
    assert name == "tcn_in_gemm" and args[-3:-1] == (bm, bn)
    assert y1.shape == (batch, Kp, H)
    want = (batch, Kp // bm * (H // bn), 2) if norm == "gLN" else (batch, Kp, H // bn, 2)
    assert stats.shape == want


@pytest.mark.parametrize("norm", ["gLN", "cLN"])
@pytest.mark.parametrize("batch", [8, 5, 1])
def test_kb1_launches_its_plan_and_shapes_its_partials(meta_lib, batch, norm):
    """bf16 KB1 passes gemm_plan's tile (c and dz the two epilogue tiles),
    with one colpart row per row tile and the norm2-backward partials per
    row and column tile (cLN) or per CTA (gLN)."""
    Kp, B, H = 3200, 256, 512
    bm, bn = tb.gemm_plan(batch * Kp, H, B, H100_SMS)
    s2 = _meta(batch, 1, 2, dtype=F32) if norm == "gLN" else _meta(batch, Kp, 1, 2, dtype=F32)
    dz, colpart, npart = tbb.tcn_bwd_dz(_meta(batch, Kp, B), _meta(B, H), _meta(batch, Kp, H),
                                        s2, _meta(1, dtype=F32), _meta(H, dtype=F32), norm, 3199)
    name, args = meta_lib.calls[-1]
    assert name == "tcn_bwd_dz" and args[-3:-1] == (bm, bn)
    assert dz.shape == (batch, Kp, H) and colpart.shape == (batch * Kp // bm, 2, H)
    want = (batch, Kp // bm * (H // bn), 2) if norm == "gLN" else (batch, Kp, H // bn, 2)
    assert npart.shape == want


def test_f32_k1_kb1_keep_the_simt_tiles(meta_lib):
    Kp, B, H = 384, 128, 256
    _, stats = tb.tcn_in_gemm(_meta(2, Kp, B, dtype=F32), _meta(B, H, dtype=F32),
                              _meta(1, dtype=F32), "gLN")
    assert meta_lib.calls[-1][1][-3:-1] == (tb.BM, tb.BN)
    assert stats.shape == (2, Kp // tb.BM * (H // tb.BN), 2)
    _, colpart, _ = tbb.tcn_bwd_dz(_meta(2, Kp, B, dtype=F32), _meta(B, H, dtype=F32),
                                   _meta(2, Kp, H, dtype=F32), _meta(2, 1, 2, dtype=F32),
                                   _meta(1, dtype=F32), _meta(H, dtype=F32), "gLN", 300)
    assert meta_lib.calls[-1][1][-3:-1] == (tb.BM, tb.BN)
    assert colpart.shape == (2 * Kp // tb.BM, 2, H)


@pytest.mark.parametrize("what,args,match", [
    ("x width", ((1, 128, 96), (96, 512)), "multiples of 128"),
    ("H width", ((1, 128, 256), (256, 96)), "multiples of 128"),
    ("in_w shape", ((1, 128, 256), (128, 512)), "in_w shape"),
    ("K_pad", ((1, 100, 256), (256, 512)), "K_pad=100"),
])
def test_k1_refuses(meta_lib, what, args, match):
    with pytest.raises(ValueError, match=match):
        tb.tcn_in_gemm(_meta(*args[0]), _meta(*args[1]), _meta(1, dtype=F32), "gLN")
    assert not meta_lib.calls


def test_k1_refuses_a_y1_scratch_of_another_shape(meta_lib):
    with pytest.raises(ValueError, match="y1 scratch"):
        tb.tcn_in_gemm(_meta(1, 128, 256), _meta(256, 512), _meta(1, dtype=F32), "gLN",
                       y1=_meta(1, 128, 256))
    assert not meta_lib.calls


@pytest.mark.parametrize("what,g,wt,c,valid_k,match", [
    ("width", (1, 128, 96), (96, 512), (1, 128, 512), 100, "multiples of 128"),
    ("out_w^T", (1, 128, 256), (512, 256), (1, 128, 512), 100, "KB1 operand shapes"),
    ("c", (1, 128, 256), (256, 512), (1, 128, 256), 100, "KB1 operand shapes"),
    ("valid_k", (1, 128, 256), (256, 512), (1, 128, 512), 129, "valid_k=129"),
])
def test_kb1_refuses(meta_lib, what, g, wt, c, valid_k, match):
    with pytest.raises(ValueError, match=match):
        tbb.tcn_bwd_dz(_meta(*g), _meta(*wt), _meta(*c), _meta(1, 1, 2, dtype=F32),
                       _meta(1, dtype=F32), _meta(wt[1], dtype=F32), "gLN", valid_k)
    assert not meta_lib.calls
