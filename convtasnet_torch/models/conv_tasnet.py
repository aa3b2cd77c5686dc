"""Conv-TasNet in PyTorch, with the JAX package's layout and numerics.

Counterpart of convtasnet_tpu/models/conv_tasnet.py. Activations are
time-major channels-last [M, K, ch], so every 1x1 conv is one
[M*K, in] @ [in, out] product; parameters are f32 nested dicts with the
JAX package's leaf names and shapes (block weights stacked [R, X, ...]),
so a JAX pytree converts leaf for leaf (`params_from_jax`).

Rounding points kept from the JAX forward: each pointwise output is cast
to the compute dtype before PReLU, the mask stays in the compute dtype,
decode runs in f32 and the output is zero-padded back to T.

The TCN chain runs in one of three forms (cfg.kernel_form): the
whole-TCN kernels (ops/kernels/whole_tcn.py), the whole-block kernels
(ops/kernels/whole_block.py), or the eager `_temporal_block` chain, which
BN always takes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ConvTasNetConfig
from ..ops.activations import prelu
from ..ops.conv import depthwise_dilated, pointwise
from ..ops.framing import frame_signal, overlap_and_add
from ..ops.kernels.tcn_block import ROW_ALIGN
from ..ops.kernels.whole_block import whole_block
from ..ops.kernels.whole_tcn import alloc_scratch, whole_tcn
from ..ops.norms import apply_norm
from ..utils.initializers import xavier_normal

Params = Dict[str, Any]
State = Dict[str, Any]

_BLOCK_ORDER = ("in_w", "in_prelu", "in_gamma", "in_beta", "dw_w", "dw_prelu",
                "dw_gamma", "dw_beta", "out_w")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names the
    CPU. Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: ConvTasNetConfig,
                device=None) -> Tuple[Params, State]:
    """Parameters with the reference's init distribution: xavier-normal on
    every torch parameter with ndim > 1, including the [1, ch, 1] gLN/cLN
    affines under cfg.reference_norm_init; PReLU slopes 0.25; BN affines
    1 / 0. `generator` must live on `device` (CPU by default)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    N, L, B, H, P, X, R, C = (cfg.N, cfg.L, cfg.B, cfg.H, cfg.P, cfg.X,
                              cfg.R, cfg.C)

    def xn(torch_shape, out_shape):
        return xavier_normal(generator, torch_shape, out_shape, device=dev)

    def norm_init(ch, norm_type):
        if norm_type in ("gLN", "cLN") and cfg.reference_norm_init:
            return xn((1, ch, 1), (ch,)), xn((1, ch, 1), (ch,))
        return torch.ones(ch, device=dev), torch.zeros(ch, device=dev)

    def stack(fn):
        return torch.stack([torch.stack([fn() for _ in range(X)]) for _ in range(R)])

    enc_U = xn((N, 1, L), (L, N))
    dec_V = xn((L, N), (N, L))
    ln_gamma, ln_beta = norm_init(N, "cLN")  # the input norm is always cLN
    blocks = {
        "in_w": stack(lambda: xn((H, B, 1), (B, H))),
        "in_prelu": torch.full((R, X), 0.25, device=dev),
        "dw_w": stack(lambda: xn((H, 1, P), (P, H))),
        "dw_prelu": torch.full((R, X), 0.25, device=dev),
        "out_w": stack(lambda: xn((B, H, 1), (H, B))),
    }
    for site in ("in", "dw"):
        pairs = [[norm_init(H, cfg.norm_type) for _ in range(X)] for _ in range(R)]
        blocks[f"{site}_gamma"] = torch.stack([torch.stack([g for g, _ in r]) for r in pairs])
        blocks[f"{site}_beta"] = torch.stack([torch.stack([b for _, b in r]) for r in pairs])
    params: Params = {
        "encoder": {"U": enc_U},
        "separator": {
            "ln": {"gamma": ln_gamma, "beta": ln_beta},
            "bottleneck": {"w": xn((B, N, 1), (N, B))},
            "blocks": blocks,
            "mask": {"w": xn((C * N, B, 1), (B, C * N))},
        },
        "decoder": {"V": dec_V},
    }
    state: State = {}
    if cfg.norm_type == "BN":
        state = {"blocks": {
            "in_mean": torch.zeros((R, X, H), device=dev),
            "in_var": torch.ones((R, X, H), device=dev),
            "dw_mean": torch.zeros((R, X, H), device=dev),
            "dw_var": torch.ones((R, X, H), device=dev),
        }}
    return params, state


def params_from_jax(params_np, state_np, device=None) -> Tuple[Params, State]:
    """Turn the JAX package's parameter / state pytrees (nested dicts with
    numpy or array leaves) into this package's f32 tensors on `device`."""
    dev = torch.device("cpu") if device is None else torch.device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return torch.from_numpy(np.array(tree, dtype=np.float32)).to(dev)

    return conv(params_np), conv(state_np or {})


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def encode(params: Params, cfg: ConvTasNetConfig, mixture: torch.Tensor) -> torch.Tensor:
    """Learned analysis basis: [M, T] -> nonnegative [M, K, N] (compute dtype)."""
    frames = frame_signal(mixture, cfg.L, cfg.stride)  # [M, K, L]
    w = pointwise(frames, params["encoder"]["U"], cfg.dtype)
    return torch.relu(w).to(cfg.dtype)


def _temporal_block(x: torch.Tensor, bp: Dict[str, torch.Tensor],
                    bstate: Optional[Dict[str, torch.Tensor]],
                    cfg: ConvTasNetConfig, dilation: int, train: bool
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One residual block, op by op (conv_tasnet.py:212-272): 1x1 -> PReLU
    -> norm -> dilated depthwise -> PReLU -> norm -> 1x1, + residual."""
    dt = cfg.dtype
    y = pointwise(x, bp["in_w"], dt).to(dt)
    y = prelu(y, bp["in_prelu"])
    s_in = None if bstate is None else {"mean": bstate["in_mean"], "var": bstate["in_var"]}
    y, s_in = apply_norm(cfg.norm_type, y, {"gamma": bp["in_gamma"],
                                            "beta": bp["in_beta"]}, s_in, train)
    y = depthwise_dilated(y, bp["dw_w"], dilation, cfg.causal)
    y = prelu(y, bp["dw_prelu"])
    s_dw = None if bstate is None else {"mean": bstate["dw_mean"], "var": bstate["dw_var"]}
    y, s_dw = apply_norm(cfg.norm_type, y, {"gamma": bp["dw_gamma"],
                                            "beta": bp["dw_beta"]}, s_dw, train)
    new_state = None
    if bstate is not None:
        new_state = {"in_mean": s_in["mean"], "in_var": s_in["var"],
                     "dw_mean": s_dw["mean"], "dw_var": s_dw["var"]}
    y = pointwise(y, bp["out_w"], dt).to(dt)
    return x + y, new_state


def _kernel_chain(x: torch.Tensor, blocks: Params, cfg: ConvTasNetConfig) -> torch.Tensor:
    """The TCN chain through ops/kernels: K is padded to ROW_ALIGN once here
    (pad rows exact zeros, statistics over the true K frames)."""
    M, K, _ = x.shape
    Kp = -(-K // ROW_ALIGN) * ROW_ALIGN
    x = F.pad(x, (0, 0, 0, Kp - K))
    bp = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in blocks.items()}
    if cfg.kernel_form == "whole_tcn":
        x = whole_tcn(x, *[bp[k] for k in _BLOCK_ORDER], cfg.norm_type,
                      cfg.causal, cfg.X, valid_k=K)
    else:
        scratch = (alloc_scratch(M, Kp, cfg.H, x.dtype, x.device)
                   if x.is_cuda else None)
        in_w = bp["in_w"].to(cfg.dtype)
        out_w = bp["out_w"].to(cfg.dtype)
        for nb in range(cfg.R * cfg.X):
            x = whole_block(x, in_w[nb], bp["in_prelu"][nb], bp["in_gamma"][nb],
                            bp["in_beta"][nb], bp["dw_w"][nb], bp["dw_prelu"][nb],
                            bp["dw_gamma"][nb], bp["dw_beta"][nb], out_w[nb],
                            cfg.norm_type, 2 ** (nb % cfg.X), cfg.causal,
                            valid_k=K, scratch=scratch)
    return x[:, :K]


def separate(params: Params, state: State, cfg: ConvTasNetConfig,
             mixture_w: torch.Tensor, train: bool = False
             ) -> Tuple[torch.Tensor, State]:
    """Mask estimation TCN: [M, K, N] -> ([M, K, C, N] mask, new_state)."""
    sp = params["separator"]
    dt = cfg.dtype
    M, K, N = mixture_w.shape
    # The input norm is always cLN whatever norm_type (conv_tasnet.py:167).
    x, _ = apply_norm("cLN", mixture_w, sp["ln"], None, train)
    x = pointwise(x, sp["bottleneck"]["w"], dt).to(dt)  # [M, K, B]

    new_state = state
    if cfg.kernel_form != "eager":
        x = _kernel_chain(x, sp["blocks"], cfg)
    else:
        has_bn = cfg.norm_type == "BN"
        block_state = state.get("blocks") if has_bn else None
        new_bs: Dict[str, list] = {}
        for r in range(cfg.R):
            for xi in range(cfg.X):
                bp = {k: v[r, xi] for k, v in sp["blocks"].items()}
                bs = ({k: v[r, xi] for k, v in block_state.items()}
                      if block_state is not None else None)
                x, nbs = _temporal_block(x, bp, bs, cfg, 2 ** xi, train)
                for k, v in (nbs or {}).items():
                    new_bs.setdefault(k, []).append(v)
        if has_bn:
            new_state = {"blocks": {k: torch.stack(v).reshape(cfg.R, cfg.X, -1)
                                    for k, v in new_bs.items()}}

    score = pointwise(x, sp["mask"]["w"], dt).reshape(M, K, cfg.C, N)  # f32
    if cfg.mask_nonlinear == "softmax":
        mask = torch.softmax(score, dim=2)
    else:
        mask = torch.relu(score)
    return mask.to(dt), new_state


def decode(params: Params, cfg: ConvTasNetConfig, mixture_w: torch.Tensor,
           est_mask: torch.Tensor) -> torch.Tensor:
    """Masked synthesis + overlap-add: -> [M, C, (K-1)*S + L] float32.

    JAX multiplies in the compute dtype and contracts with
    preferred_element_type=f32; here the rounded product is up-cast and
    the contraction runs in f32 (same rounding points)."""
    dt = cfg.dtype
    source_w = (mixture_w[:, :, None, :] * est_mask).to(dt)  # [M, K, C, N]
    V = params["decoder"]["V"].to(dt).float()
    est_frames = torch.matmul(source_w.float().permute(0, 2, 1, 3), V)  # [M, C, K, L]
    return overlap_and_add(est_frames, cfg.stride)


def forward(params: Params, state: State, cfg: ConvTasNetConfig,
            mixture: torch.Tensor, train: bool = False) -> Tuple[torch.Tensor, State]:
    """Full model: [M, T] -> ([M, C, T] float32 estimates, new_state)."""
    mixture_w = encode(params, cfg, mixture)
    est_mask, new_state = separate(params, state, cfg, mixture_w, train)
    est_source = decode(params, cfg, mixture_w, est_mask)
    T, T_conv = mixture.shape[-1], est_source.shape[-1]
    return F.pad(est_source, (0, T - T_conv)), new_state


# --------------------------------------------------------------------------
# nn.Module wrapper
# --------------------------------------------------------------------------

def _to_module(tree) -> nn.Module:
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            m.add_module(k, _to_module(v))
        else:
            m.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return m


def _from_module(m: nn.Module) -> Params:
    tree = {k: p for k, p in m.named_parameters(recurse=False)}
    tree.update({k: _from_module(c) for k, c in m.named_children()})
    return tree


class ConvTasNet(nn.Module):
    """nn.Module over the functional model: parameters registered under the
    JAX leaf names (e.g. `separator.blocks.in_w`), BN running stats as
    buffers. forward(mixture [M, T]) -> estimates [M, C, T] float32."""

    def __init__(self, cfg: ConvTasNetConfig, params: Optional[Params] = None,
                 state: Optional[State] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        if params is None:
            gen = generator or torch.Generator(device=dev).manual_seed(0)
            params, state = init_params(gen, cfg, device=dev)
        for k, v in params.items():
            self.add_module(k, _to_module(v))
        for k, v in (state or {}).get("blocks", {}).items():
            self.register_buffer(f"bn_{k}", v)

    def params(self) -> Params:
        return {k: _from_module(c) for k, c in self.named_children()}

    def state(self) -> State:
        bs = {k[3:]: v for k, v in self.named_buffers() if k.startswith("bn_")}
        return {"blocks": bs} if bs else {}

    def forward(self, mixture: torch.Tensor) -> torch.Tensor:
        est, new_state = forward(self.params(), self.state(), self.cfg, mixture,
                                 train=self.training)
        for k, v in new_state.get("blocks", {}).items():
            getattr(self, f"bn_{k}").copy_(v)
        return est

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
