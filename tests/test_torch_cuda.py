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
    got = whole_tcn(x, *args, norm_type, causal, 2)
    assert tcn_block.counts()["tcn_out_gemm_fold"] == 4
    want = whole_tcn_reference(x, *args, norm_type, causal, 2)
    assert got.shape == x.shape and torch.isfinite(got.float()).all()
    assert _rel_l2(got, want) <= tol


@pytest.mark.parametrize("dilation", [1, 8])
def test_whole_block_kernels_match_plain(dev, dilation):
    one = [a[0] for a in _blocks(1, device=dev)]
    x = torch.randn((3, 256, 128), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    got = whole_block(x, *one, "gLN", dilation, False)
    want = whole_block_reference(x, *one, "gLN", dilation, False)
    assert _rel_l2(got, want) <= 1e-5


def test_kernels_repeat_bit_for_bit(dev):
    """Partial sums reduce in a fixed order: no run-to-run drift."""
    args = _blocks(2, device=dev)
    x = torch.randn((2, 256, 128), generator=torch.Generator(device=dev).manual_seed(2),
                    device=dev).to(torch.bfloat16)
    a = whole_tcn(x, *args, "gLN", False, 2)
    b = whole_tcn(x, *args, "gLN", False, 2)
    assert torch.equal(a, b)


def test_unsupported_width_raises(dev):
    x = torch.zeros((1, 128, 96), device=dev)
    with pytest.raises(ValueError, match="multiples of 128"):
        tcn_block.tcn_in_gemm(x, torch.zeros((96, 128), device=dev),
                              torch.zeros(1, device=dev), "gLN")
