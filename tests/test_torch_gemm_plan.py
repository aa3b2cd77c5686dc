"""Launch planning of the bf16 wgmma kernels (K3 tcn_out_gemm, KB3
tcn_bwd_dx) and the wrappers' refusals, on the CPU.

`gemm_plan` is plain Python: it picks the rows and columns per CTA from the
row count. The refusals run before any device work, so they are exercised
with meta tensors (the same code path as CUDA tensors)."""

import pytest
import torch

from convtasnet_torch.ops.kernels import tcn_block as tb
from convtasnet_torch.ops.kernels import tcn_block_bwd as tbb

H100_SMS = 132


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
