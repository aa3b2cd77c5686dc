"""Configuration dataclasses for the PyTorch/CUDA Conv-TasNet port.

Field names and defaults follow the JAX package's config (the paper config:
N=256, L=20, B=256, H=512, P=3, X=8, R=4, C=2, gLN, non-causal, relu,
bf16 activations). `use_kernels` takes the place of the JAX `use_pallas`
switch and selects how the TCN chain runs:

  "auto"  -> the whole-TCN form: per block the three Hopper kernels of
             csrc/tcn_block.cu with norm2 folded into the out_w product;
  "block" -> the whole-block form: the same kernels, norm2 unfolded;
  0       -> the eager op-by-op chain (always the case for BN).

A CPU tensor takes each kernel's plain PyTorch version.
"""

from __future__ import annotations

import dataclasses

import torch

# Reference numerical epsilon (conv_tasnet.py:10, pit_criterion.py:9).
EPS = 1e-8

USE_KERNELS_CHOICES = ("auto", "block", "0")

# Keys a JAX checkpoint header carries that have no meaning here.
_JAX_ONLY_KEYS = ("use_pallas", "remat", "scan_unroll")


@dataclasses.dataclass(frozen=True)
class ConvTasNetConfig:
    """Model hyperparameters (reference naming, conv_tasnet.py:16-28):

      N: encoder/decoder basis filters     L: filter length (stride L // 2)
      B: bottleneck channels               H: channels inside each block
      P: depthwise kernel size             X: blocks per repeat (d = 2**x)
      R: repeats                           C: speakers
      norm_type: "gLN" | "cLN" | "BN"      causal: left-only padding
      mask_nonlinear: "relu" | "softmax"
    """

    N: int = 256
    L: int = 20
    B: int = 256
    H: int = 512
    P: int = 3
    X: int = 8
    R: int = 4
    C: int = 2
    norm_type: str = "gLN"
    causal: bool = False
    mask_nonlinear: str = "relu"
    # Activation dtype; parameters and norm statistics stay f32.
    compute_dtype: str = "bfloat16"
    # xavier-normal on the [1, ch, 1] gLN/cLN affines, as the reference's
    # init loop does (conv_tasnet.py:41-43).
    reference_norm_init: bool = True
    use_kernels: object = "auto"

    def __post_init__(self):
        if self.norm_type not in ("gLN", "cLN", "BN"):
            raise ValueError(f"unsupported norm_type: {self.norm_type}")
        if self.mask_nonlinear not in ("relu", "softmax"):
            raise ValueError(f"unsupported mask_nonlinear: {self.mask_nonlinear}")
        if self.L % 2 != 0:
            raise ValueError("L must be even (stride is L // 2)")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unsupported compute_dtype: {self.compute_dtype}")
        if str(self.use_kernels).lower() not in USE_KERNELS_CHOICES + ("false",):
            raise ValueError(f"unsupported use_kernels: {self.use_kernels!r}")

    @property
    def stride(self) -> int:
        return self.L // 2

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def kernel_form(self) -> str:
        """"whole_tcn", "whole_block" or "eager" (BN is always eager)."""
        flag = str(self.use_kernels).lower()
        if self.norm_type == "BN" or flag in ("0", "false"):
            return "eager"
        return "whole_block" if flag == "block" else "whole_tcn"

    def num_frames(self, T: int) -> int:
        """K = (T - L) // (L/2) + 1 (conv_tasnet.py:113)."""
        return (T - self.L) // self.stride + 1

    @classmethod
    def from_header(cls, model_config: dict) -> "ConvTasNetConfig":
        """Build from a checkpoint header written by either package."""
        kw = {k: v for k, v in model_config.items() if k not in _JAX_ONLY_KEYS}
        return cls(**kw)

    def header_dict(self) -> dict:
        """The model_config a checkpoint header stores: the keys both
        packages read (the kernel switch is a run-time choice)."""
        d = dataclasses.asdict(self)
        d.pop("use_kernels")
        return d


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    model_path: str = ""
    data_dir: str = ""
    cal_sdr: bool = False
    sample_rate: int = 8000
    batch_size: int = 1
