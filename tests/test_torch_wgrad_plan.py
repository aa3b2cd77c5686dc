"""Launch planning of the bf16 KW kernel (tcn_wgrad) and its refusals, and
the plain version's masking of Bm's rows >= K, on the CPU.

`wgrad_plan` is plain Python: it picks the row splits and the cluster size
from the shape and the card. The refusals run before any device work, so
they are exercised with meta tensors (the same code path as CUDA tensors)."""

import numpy as np
import pytest
import torch

from convtasnet_torch.ops.kernels import tcn_block_bwd as tbb

H100_SMS = 132
# cudaOccupancyMaxActiveClusters of the kernel (about 200 KB of shared
# memory a CTA) on an H100 80GB HBM3: clusters of 2, 4 and 8 CTAs.
H100_CLUSTERS = ((2, 66), (4, 30), (8, 15))
KP, B, H = 3200, 256, 512


@pytest.mark.parametrize("batch,want", [
    (8, (28, 4, 7)),     # 400 slices: 15 each, 7 partials
    (5, (28, 4, 7)),     # 250 slices: 8-9 each
    (1, (12, 4, 3)),     # 50 slices: at least 4 each
])
@pytest.mark.parametrize("form", ["dout_w", "din_w"])
def test_plan_at_the_paper_widths(batch, want, form):
    """Both forms put the 512-wide operand on wgmma's M side: 4 tiles of
    128 x 256, about one wave of CTAs, every cluster resident at once."""
    plan = tbb.wgrad_plan(batch * KP, KP, H, B, H100_SMS, H100_CLUSTERS)
    assert (plan.splits, plan.cluster, plan.parts) == want
    assert (plan.bn, plan.tiles) == (256, 4)
    assert plan.tiles * plan.splits <= H100_SMS
    assert plan.tiles * plan.splits // plan.cluster <= dict(H100_CLUSTERS)[plan.cluster]


@pytest.mark.parametrize("batch", [8, 5, 1])
def test_plan_without_the_cards_cluster_limits(batch):
    """Without the card's counts, clusters are limited by SMs alone."""
    plan = tbb.wgrad_plan(batch * KP, KP, H, B, H100_SMS)
    assert plan.splits % plan.cluster == 0 and plan.tiles * plan.splits <= H100_SMS
    assert plan.parts == plan.splits // plan.cluster


def test_plan_on_one_sm_is_one_split():
    assert tbb.wgrad_plan(5 * KP, KP, H, B, 1) == (1, 1, 256, 4, 1)


@pytest.mark.parametrize("rows,kpad,m_cols,n_cols,sms", [
    (16000, 3200, 512, 256, H100_SMS),
    (3200, 3200, 512, 256, H100_SMS),
    (2560, 512, 256, 128, H100_SMS),   # the card tests' width: 128-column N tiles
    (768, 384, 256, 128, H100_SMS),
    (768, 384, 256, 128, 1),
    (25600, 3200, 512, 256, 10 ** 6),  # a huge card: at least 4 slices a split
])
def test_splits_are_whole_slices_covering_every_row_once(rows, kpad, m_cols, n_cols, sms):
    plan = tbb.wgrad_plan(rows, kpad, m_cols, n_cols, sms, H100_CLUSTERS)
    ranges = tbb.wgrad_split_rows(rows, plan.splits)
    covered = np.zeros(rows, dtype=int)
    for lo, hi in ranges:
        assert lo % tbb.WGRAD_SLICE == 0 and hi % tbb.WGRAD_SLICE == 0 and hi > lo
        covered[lo:hi] += 1
    assert np.all(covered == 1)
    assert plan.splits % plan.cluster == 0 and plan.cluster in tbb.WGRAD_CLUSTERS
    assert max(hi - lo for lo, hi in ranges) >= tbb.WGRAD_MIN_SLICES * tbb.WGRAD_SLICE or \
        plan.splits == 1


def test_plan_is_a_function_of_the_shape():
    """Same shape, same plan: the partials' count and sums repeat."""
    plans = {tbb.wgrad_plan(16000, KP, H, B, H100_SMS, H100_CLUSTERS) for _ in range(3)}
    assert len(plans) == 1


@pytest.mark.parametrize("rows,kpad,m_cols,n_cols", [
    (16000, 3000, 512, 256),   # K_pad not whole 64-row slices
    (16100, 3200, 512, 256),   # rows not whole items
    (16000, 3200, 512, 96),    # width not a multiple of 128
    (0, 3200, 512, 256),
])
def test_plan_refuses_untileable_shapes(rows, kpad, m_cols, n_cols):
    with pytest.raises(ValueError):
        tbb.wgrad_plan(rows, kpad, m_cols, n_cols, H100_SMS)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("plan", [(3, 2), (8, 3), (0, 1), (51, 1)])
def test_wgrad_refuses_a_plan_that_does_not_tile(plan):
    """50 slices at M=1: splits must be 1..50 and a multiple of the
    cluster size, the cluster one of 1, 2, 4, 8; refused before a launch."""
    with pytest.raises(ValueError, match="does not tile"):
        tbb.tcn_wgrad(_meta(1, KP, B), _meta(1, KP, H), 3199, plan=plan)


def test_wgrad_refuses_an_unsupported_width():
    with pytest.raises(ValueError, match="multiples of 128"):
        tbb.tcn_wgrad(_meta(1, 128, 96), _meta(1, 128, 256), 100)


@pytest.mark.parametrize("zform", [True, False])
def test_plain_reads_bms_rows_beyond_k_as_zero(zform):
    """wgrad_plain with NaN in Bm's rows >= K equals the same call with
    zeros there: the kernel's masking is held against this."""
    rng = np.random.default_rng(0)
    M, Kp, K, n1, n2 = 2, 128, 100, 128, 256
    A = torch.from_numpy(rng.normal(size=(M, Kp, n1)).astype(np.float32))
    Bm = torch.from_numpy(rng.normal(size=(M, Kp, n2)).astype(np.float32))
    z = None
    if zform:
        stats = torch.from_numpy(np.stack([rng.normal(size=(M, 1)) * 10,
                                           np.abs(rng.normal(size=(M, 1))) * 1e4 + 1e4],
                                          -1).astype(np.float32))
        z = (stats, torch.full((1,), 0.25), torch.ones(n1) * 1.1, torch.ones(n1) * 0.1, "gLN")
    zero, nan = Bm.clone(), Bm.clone()
    zero[:, K:] = 0.0
    nan[:, K:] = float("nan")
    got = tbb.wgrad_plain(A, nan, K, z)
    assert torch.isfinite(got).all()
    assert torch.equal(got, tbb.wgrad_plain(A, zero, K, z))
