"""Configuration dataclasses for the PyTorch/CUDA Conv-TasNet port.

Field names and defaults follow the JAX package's config (the paper config:
N=256, L=20, B=256, H=512, P=3, X=8, R=4, C=2, gLN, non-causal, relu,
bf16 activations). `use_kernels` takes the place of the JAX `use_pallas`
switch and selects how the TCN chain runs (`ConvTasNetConfig.kernel_form`,
the rules of convtasnet_tpu/models/conv_tasnet.py:182-233):

  inference (train=False)
    "auto", "hybrid", "whole" -> the whole-TCN form: per block the three
             Hopper kernels of csrc/tcn_block.cu, norm2 folded into out_w;
    "block" -> the whole-block form: the same kernels, norm2 unfolded;
  training (train=True)
    "auto", "block" -> the eager chain under autograd (as the JAX package
             keeps training on XLA for use_pallas=True);
    "hybrid" -> the whole-TCN training op (residual-saving forward,
             backward kernels of csrc/tcn_block_bwd.cu), or the per-block
             hybrid op when its residuals exceed the memory gate
             (models/conv_tasnet.py);
    "whole"  -> the per-block recompute op (whole_block_vjp.py);
  0 -> the eager op-by-op chain. BN is always eager, and off the CPU so
  is every config beyond a launch limit of a kernel the form runs
  (ops/kernels/limits.py: widths not multiples of 128, bf16 H > 1024, the
  conv span of the largest dilation, KB2's taps and span in training).

A CPU tensor takes each kernel's plain PyTorch version.
"""

from __future__ import annotations

import dataclasses

import torch

from .ops.kernels.limits import kernel_limit

# Reference numerical epsilon (conv_tasnet.py:10, pit_criterion.py:9).
EPS = 1e-8

USE_KERNELS_CHOICES = ("auto", "block", "hybrid", "whole", "0")

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

    def kernel_form(self, train: bool = False, device=None) -> str:
        """How the TCN chain runs for a forward with `train` on `device`
        (default CUDA, the entry points' default): "eager", the inference
        forms "whole_tcn" / "whole_block", or the training forms
        "whole_tcn_train" (use_kernels="hybrid") / "whole_block_train"
        ("whole"). Decided from the config before any launch: on a card a
        config beyond the launch limits of the form's kernels runs eager
        (the CPU's plain versions take any config)."""
        flag = str(self.use_kernels).lower()
        if self.norm_type == "BN" or flag in ("0", "false"):
            return "eager"
        if not train:
            form = "whole_block" if flag == "block" else "whole_tcn"
        else:
            form = {"hybrid": "whole_tcn_train", "whole": "whole_block_train"}.get(flag, "eager")
        on_card = device is None or torch.device(device).type != "cpu"
        if form != "eager" and on_card and kernel_limit(
                self.B, self.H, self.P, self.X, self.compute_dtype == "bfloat16", train):
            return "eager"
        return form

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


# TrainConfig fields whose non-default values wait for a later slice.
_LATER = {"dp": 1, "tp": 1, "cp": 1, "visualize": False}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer knobs (convtasnet_tpu/config.py:106-143, the reference's
    train.py:53-98)."""

    epochs: int = 30
    half_lr: bool = True
    early_stop: bool = True
    max_norm: float = 5.0  # global grad-norm clip (solver.py:184-185)
    batch_size: int = 3
    optimizer: str = "adam"  # "adam" | "sgd"
    lr: float = 1e-3
    momentum: float = 0.0
    l2: float = 0.0  # weight decay, coupled as in torch
    sample_rate: int = 8000
    segment: float = 4.0  # seconds; < 0 means full utterances
    cv_maxlen: float = 8.0  # seconds
    shuffle: bool = False
    save_folder: str = "exp/temp"
    checkpoint: bool = False  # per-epoch checkpoints
    # Every N train steps write latest.ckpt with (epoch, step_in_epoch) and
    # the running sums; resume replays the loader order and skips them.
    save_every_steps: int = 0
    continue_from: str = ""
    model_path: str = "final.ckpt"
    print_freq: int = 10
    seed: int = 0
    visualize: bool = False
    dp: int = 1
    tp: int = 1
    cp: int = 1

    def __post_init__(self):
        if self.optimizer not in ("adam", "sgd"):
            raise ValueError(f"unsupported optimizer: {self.optimizer}")
        for k, default in _LATER.items():
            if getattr(self, k) != default:
                raise NotImplementedError(
                    f"TrainConfig.{k}={getattr(self, k)!r} is not ported yet "
                    "(waits for a later slice of the port)")
