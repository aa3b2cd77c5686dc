"""Conv-TasNet in PyTorch, with the JAX package's layout and numerics.

Counterpart of convtasnet_tpu/models/conv_tasnet.py. Activations are
time-major channels-last [M, K, ch], so every 1x1 conv is one
[M*K, in] @ [in, out] product; parameters are f32 nested dicts with the
JAX package's leaf names and shapes (block weights stacked [R, X, ...]),
so a JAX pytree converts leaf for leaf (`params_from_jax`).

Rounding points kept from the JAX forward: each pointwise output is cast
to the compute dtype before PReLU, the mask stays in the compute dtype,
decode runs in f32 and the output is zero-padded back to T.

The TCN chain runs in the form cfg.kernel_form(train, device) names: for
inference the whole-TCN kernels (ops/kernels/whole_tcn.py) or the
whole-block kernels (ops/kernels/whole_block.py); for training the
whole-TCN training op (ops/kernels/whole_tcn_hybrid.py; past the memory
gate below, the recompute chain of ops/kernels/whole_block_vjp.py) or
that recompute chain itself; else the eager
`_temporal_block` chain under autograd, which BN always takes. The
stacked [R, X, ...] block parameters reach the ops as [NB, ...] views, so
their gradients flow back to the leaves.

The paper's final version (ConvTasNetConfig's Sc, encoder_relu,
input_norm; the authors' utility/models.py) changes three places: a
linear encoder, a gLN input norm, and a skip path. With Sc > 0 every
block adds e @ skip_w (blocks/skip_w [R, X, H, Sc]) into a skip sum s
[M, K, Sc], stored in the compute dtype and rounded after each add as x
is, and the mask is mask_nonlinear(PReLU(s) @ mask/w) with mask/w
[Sc, C*N] and mask/prelu one slope, instead of mask_nonlinear(x_last @
mask/w). The kernel forms carry s through every block (whole_tcn.py,
whole_tcn_hybrid.py); TP, CP and streaming run the first version's design
only and refuse the others.

`par` (parallel/comm.ParallelContext, default None) carries the process
groups of a parallel run. Under TP (its model group) every rank holds the
pieces parallel/mesh._TP_RULES cut: the input cLN runs on the whole w and
is then cut over N, the bottleneck is row-parallel over N (one
all-reduce), each block is column-parallel over H into PReLU, the norms
(statistics all-reduced) and the depthwise conv, and row-parallel out of
it (one all-reduce), the mask is cut over N inside each speaker, and the
decoder contracts its N piece (one all-reduce). Under CP (its context
group) the frames are cut (parallel/context.py): gLN statistics reduce
over the group and the depthwise convs exchange halos. Either runs the
eager chain, as the JAX package does under TP and CP. Its data group
only reaches BN (batch statistics over the global batch); without TP or
CP the path, the dispatch and the kernel launches are the single-card
ones.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..config import ConvTasNetConfig, remat_mode
from ..ops.activations import prelu
from ..ops.conv import depthwise_dilated, pointwise
from ..ops.framing import frame_signal, overlap_and_add
from ..ops.kernels.tcn_block import ROW_ALIGN
from ..ops.kernels.whole_block import whole_block
from ..ops.kernels.whole_block_vjp import whole_chain_train
from ..ops.kernels.whole_tcn import alloc_scratch, whole_tcn
from ..ops.kernels.whole_tcn_hybrid import whole_tcn_train
from ..ops.norms import apply_norm
from ..parallel.comm import ParallelContext, copy_to, group_rank, group_size, reduce_from
from ..utils.initializers import xavier_normal

Params = Dict[str, Any]
State = Dict[str, Any]

_BLOCK_ORDER = ("in_w", "in_prelu", "in_gamma", "in_beta", "dw_w", "dw_prelu",
                "dw_gamma", "dw_beta", "out_w")

# Memory gate of use_kernels="hybrid" in training, a fact of the card's
# HBM. The whole-TCN training op holds every block's input x_nb and conv
# output c_nb until the backward: NB * M * K_pad * (B + H) activation
# elements (786 MB at the paper config, batch 5 x 4 s, bf16). It runs when
# they fit a quarter of the card's memory (20 GB of an 80 GB H100), leaving
# the rest to the weights, the optimizer state and the backward's
# [M, K_pad, H] temporaries; otherwise the `whole` chain runs
# (whole_block_vjp.whole_chain_train), which saves x_nb alone, NB * M *
# K_pad * B elements (a third of the whole-TCN op's at the paper widths, a
# fifth at H = 1024), and recomputes y1 and c per block in its backward.
# The JAX package falls back to its per-block hybrid form instead
# (convtasnet_tpu/models/conv_tasnet.py:280-296, `tcn_vmem_need`): that is
# a fact of the TPU's VMEM, whose budget the whole-TCN kernel exceeds, not
# of HBM; the per-block hybrid form holds x_nb, y1_nb and c_nb, more than
# the op it would replace here. On the CPU the budget is a fixed 8 GiB.
RESIDUAL_SHARE_OF_DEVICE = 0.25
CPU_RESIDUAL_BUDGET = 8 << 30


def residual_budget(device) -> int:
    """Bytes the whole-TCN training op may hold in residuals on `device`."""
    dev = torch.device(device)
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
        return int(RESIDUAL_SHARE_OF_DEVICE * total)
    return CPU_RESIDUAL_BUDGET


def _chain_bytes(cfg: ConvTasNetConfig, M: int, K_pad: int, width: int) -> int:
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    return cfg.R * cfg.X * M * K_pad * width * itemsize


def residual_bytes(cfg: ConvTasNetConfig, M: int, K_pad: int) -> int:
    """Bytes of the whole-TCN training op's residuals x_nb and c_nb, and
    its one skip-sum buffer [M, K_pad, Sc]."""
    skip = M * K_pad * cfg.Sc * torch.empty((), dtype=cfg.dtype).element_size()
    return _chain_bytes(cfg, M, K_pad, cfg.B + cfg.H) + skip


def fallback_bytes(cfg: ConvTasNetConfig, M: int, K_pad: int) -> int:
    """Bytes of the memory gate's fallback's residuals: the `whole`
    chain's block inputs x_nb."""
    return _chain_bytes(cfg, M, K_pad, cfg.B)


def chain_form(cfg: ConvTasNetConfig, train: bool, M: int, K: int, device) -> str:
    """The form the TCN chain of a forward of M rows of K frames takes on
    `device`: cfg.kernel_form, with "whole_tcn_train" turned into the
    `whole` chain, "whole_block_train", when its residuals exceed the
    memory gate; a skip config goes to the eager chain there instead, as
    kernel_form sends its "whole" training (the recompute chain has no skip
    path)."""
    form = cfg.kernel_form(train, device)
    Kp = -(-K // ROW_ALIGN) * ROW_ALIGN
    if form == "whole_tcn_train" and residual_bytes(cfg, M, Kp) > residual_budget(device):
        return "eager" if cfg.Sc else "whole_block_train"
    return form


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
    1 / 0. `generator` must live on `device` (CPU by default). With Sc > 0
    also blocks/skip_w [R, X, H, Sc] and mask/prelu, drawn after the
    first version's leaves; mask/w is then [Sc, C*N]."""
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

    head = cfg.Sc or B  # the mask's input: the skip sum, or the last block's output
    enc_U = xn((N, 1, L), (L, N))
    dec_V = xn((L, N), (N, L))
    ln_gamma, ln_beta = norm_init(N, cfg.input_norm)
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
            "mask": {"w": xn((C * N, head, 1), (head, C * N))},
        },
        "decoder": {"V": dec_V},
    }
    if cfg.Sc:
        blocks["skip_w"] = stack(lambda: xn((cfg.Sc, H, 1), (H, cfg.Sc)))
        params["separator"]["mask"]["prelu"] = torch.tensor(0.25, device=dev)
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
    """Learned analysis basis: [M, T] -> [M, K, N] (compute dtype),
    nonnegative under cfg.encoder_relu, else linear."""
    frames = frame_signal(mixture, cfg.L, cfg.stride)  # [M, K, L]
    w = pointwise(frames, params["encoder"]["U"], cfg.dtype)
    return (torch.relu(w) if cfg.encoder_relu else w).to(cfg.dtype)


def _temporal_block(x: torch.Tensor, s: Optional[torch.Tensor], bp: Dict[str, torch.Tensor],
                    bstate: Optional[Dict[str, torch.Tensor]],
                    cfg: ConvTasNetConfig, dilation: int, train: bool,
                    par: ParallelContext):
    """One residual block, op by op (conv_tasnet.py:212-272): 1x1 -> PReLU
    -> norm -> dilated depthwise -> PReLU -> norm -> 1x1, + residual; with
    a skip path (s not None) also s + norm2 output @ skip_w. Returns (x,
    s, new BN state or None)."""
    dt = cfg.dtype
    tp = par.model
    a1, a2 = bp["in_prelu"], bp["dw_prelu"]
    xin = x
    if tp is not None:  # replicated x and slopes feed the H-cut work
        xin, a1, a2 = copy_to(x, tp), copy_to(a1, tp), copy_to(a2, tp)
    groups = par.norm_groups(cfg.norm_type)
    y = pointwise(xin, bp["in_w"], dt).to(dt)
    y = prelu(y, a1)
    s_in = None if bstate is None else {"mean": bstate["in_mean"], "var": bstate["in_var"]}
    y, s_in = apply_norm(cfg.norm_type, y, {"gamma": bp["in_gamma"],
                                            "beta": bp["in_beta"]}, s_in, train, groups)
    y = depthwise_dilated(y, bp["dw_w"], dilation, cfg.causal, par.context)
    y = prelu(y, a2)
    s_dw = None if bstate is None else {"mean": bstate["dw_mean"], "var": bstate["dw_var"]}
    y, s_dw = apply_norm(cfg.norm_type, y, {"gamma": bp["dw_gamma"],
                                            "beta": bp["dw_beta"]}, s_dw, train, groups)
    new_state = None
    if bstate is not None:
        new_state = {"in_mean": s_in["mean"], "in_var": s_in["var"],
                     "dw_mean": s_dw["mean"], "dw_var": s_dw["var"]}
    if s is not None:
        s = s + pointwise(y, bp["skip_w"], dt).to(dt)
    y = pointwise(y, bp["out_w"], dt)
    if tp is not None:
        y = reduce_from(y, tp)
    return x + y.to(dt), s, new_state


_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the matmul outputs, recompute everything else (JAX's
    dots_saveable). A pointwise's 3-D @ 2-D torch.matmul reaches the
    dispatcher as aten.mm on a [M*K, cin] view."""
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _repeat(x: torch.Tensor, s: Optional[torch.Tensor], blocks_r: Params,
            state_r: Optional[State], cfg: ConvTasNetConfig, train: bool, par: ParallelContext,
            mode: str):
    """The X blocks of one repeat (leaves [X, ...]), each checkpointed
    under mode "block" / "dots" -> (x, s, the repeat's new BN state [X, H]
    or None)."""
    new: Dict[str, list] = {}
    for xi in range(cfg.X):
        bp = {k: v[xi] for k, v in blocks_r.items()}
        bs = None if state_r is None else {k: v[xi] for k, v in state_r.items()}
        args = (x, s, bp, bs, cfg, 2 ** xi, train, par)
        if mode == "block":
            x, s, nbs = checkpoint(_temporal_block, *args, use_reentrant=False)
        elif mode == "dots":
            x, s, nbs = checkpoint(_temporal_block, *args, use_reentrant=False,
                                   context_fn=_dots_context)
        else:
            x, s, nbs = _temporal_block(*args)
        for k, v in (nbs or {}).items():
            new.setdefault(k, []).append(v)
    return x, s, ({k: torch.stack(v) for k, v in new.items()} if state_r is not None else None)


def _eager_chain(x: torch.Tensor, blocks: Params, block_state: Optional[State],
                 cfg: ConvTasNetConfig, train: bool, par: ParallelContext):
    """The R x X `_temporal_block` chain under cfg.remat (the JAX scan body,
    conv_tasnet.py:346-370): "repeat" checkpoints each repeat, "block" and
    "dots" each block (torch.utils.checkpoint, non-reentrant: the block
    parameters reach it inside dicts). A recompute's outputs are dropped,
    so BN's running statistics are the first forward's and advance once;
    under TP / CP it issues the block's collectives again in backward.
    Without autograd (inference) nothing is checkpointed. Returns (x, the
    skip sum s [M, K, Sc] or None, new BN block state [R, X, H] or None)."""
    mode = remat_mode(cfg.remat) if torch.is_grad_enabled() else "none"
    s = x.new_zeros(x.shape[:2] + (cfg.Sc,)) if cfg.Sc else None
    new: Dict[str, list] = {}
    for r in range(cfg.R):
        blocks_r = {k: v[r] for k, v in blocks.items()}
        state_r = None if block_state is None else {k: v[r] for k, v in block_state.items()}
        if mode == "repeat":
            x, s, nbs = checkpoint(_repeat, x, s, blocks_r, state_r, cfg, train, par, "none",
                                   use_reentrant=False)
        else:
            x, s, nbs = _repeat(x, s, blocks_r, state_r, cfg, train, par, mode)
        for k, v in (nbs or {}).items():
            new.setdefault(k, []).append(v)
    if block_state is None:
        return x, s, None
    return x, s, {k: torch.stack(v) for k, v in new.items()}


def _kernel_chain(x: torch.Tensor, blocks: Params, cfg: ConvTasNetConfig,
                  form: str):
    """The TCN chain through ops/kernels in `form` (cfg.kernel_form): K is
    padded to ROW_ALIGN once here (pad rows exact zeros, statistics over
    the true K frames). Returns (x, the skip sum s or None)."""
    M, K, _ = x.shape
    Kp = -(-K // ROW_ALIGN) * ROW_ALIGN
    x = F.pad(x, (0, 0, 0, Kp - K))
    bp = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in blocks.items()}
    args = [bp[k] for k in _BLOCK_ORDER]
    skip_w = bp.get("skip_w")
    if form == "whole_tcn":
        x, s = whole_tcn(x, *args, cfg.norm_type, cfg.causal, cfg.X, valid_k=K, skip_w=skip_w)
    elif form == "whole_tcn_train":
        x, s = whole_tcn_train(x, *args, cfg.norm_type, cfg.causal, cfg.X, valid_k=K,
                               skip_w=skip_w)
    elif form == "whole_block_train":
        x, s = whole_chain_train(x, *args, cfg.norm_type, cfg.causal, cfg.X, valid_k=K), None
    else:
        scratch = (alloc_scratch(M, Kp, cfg.H, x.dtype, x.device)
                   if x.is_cuda else None)
        in_w = bp["in_w"].to(cfg.dtype)
        out_w = bp["out_w"].to(cfg.dtype)
        s = x.new_zeros((M, Kp, cfg.Sc)) if cfg.Sc else None
        for nb in range(cfg.R * cfg.X):
            x, s = whole_block(x, in_w[nb], bp["in_prelu"][nb], bp["in_gamma"][nb],
                               bp["in_beta"][nb], bp["dw_w"][nb], bp["dw_prelu"][nb],
                               bp["dw_gamma"][nb], bp["dw_beta"][nb], out_w[nb],
                               cfg.norm_type, 2 ** (nb % cfg.X), cfg.causal,
                               valid_k=K, scratch=scratch,
                               skip_w=None if skip_w is None else skip_w[nb], s=s)
    return x[:, :K], (None if s is None else s[:, :K])


def _n_piece(x: torch.Tensor, tp) -> torch.Tensor:
    """This TP rank's chunk of the last (N) axis of a replicated x."""
    n = x.shape[-1] // group_size(tp)
    r = group_rank(tp)
    return copy_to(x, tp)[..., r * n:(r + 1) * n]


def mask_of(score: torch.Tensor, cfg: ConvTasNetConfig) -> torch.Tensor:
    """cfg.mask_nonlinear of the f32 scores [M, K, C, N] (softmax over C)."""
    if cfg.mask_nonlinear == "softmax":
        return torch.softmax(score, dim=2)
    if cfg.mask_nonlinear == "sigmoid":
        return torch.sigmoid(score)
    return torch.relu(score)


def separate(params: Params, state: State, cfg: ConvTasNetConfig,
             mixture_w: torch.Tensor, train: bool = False,
             par: Optional[ParallelContext] = None) -> Tuple[torch.Tensor, State]:
    """Mask estimation TCN: [M, K, N] -> ([M, K, C, N] mask, new_state);
    under TP the mask is this rank's [M, K, C, N / tp] piece."""
    par = par or ParallelContext()
    if par.sharded and not cfg.first_version:
        raise ValueError("TP and CP run the first version's design only (Sc=0, a ReLU "
                         "encoder, the cLN input norm): the skip path and the gLN input "
                         "norm are not ported there")
    sp = params["separator"]
    dt = cfg.dtype
    tp = par.model
    M, K, _ = mixture_w.shape
    # The first version's input norm is always cLN whatever norm_type
    # (conv_tasnet.py:167); the final version's is cfg.input_norm.
    x, _ = apply_norm(cfg.input_norm, mixture_w, sp["ln"], None, train)
    if tp is not None:
        x = reduce_from(pointwise(_n_piece(x, tp), sp["bottleneck"]["w"], dt), tp).to(dt)
    else:
        x = pointwise(x, sp["bottleneck"]["w"], dt).to(dt)  # [M, K, B]

    new_state = state
    form = "eager" if par.sharded else chain_form(cfg, train, M, K, mixture_w.device)
    if form != "eager":
        x, s = _kernel_chain(x, sp["blocks"], cfg, form)
    else:
        block_state = state.get("blocks") if cfg.norm_type == "BN" else None
        x, s, new_bs = _eager_chain(x, sp["blocks"], block_state, cfg, train, par)
        if new_bs is not None:
            new_state = {"blocks": new_bs}

    if tp is not None:
        x = copy_to(x, tp)
    # The final version's head reads the skip sum through its own PReLU.
    head = x if s is None else prelu(s, sp["mask"]["prelu"])
    score = pointwise(head, sp["mask"]["w"], dt).reshape(M, K, cfg.C, -1)  # f32
    return mask_of(score, cfg).to(dt), new_state


def decode_frames(params: Params, cfg: ConvTasNetConfig, mixture_w: torch.Tensor,
                  est_mask: torch.Tensor, par: Optional[ParallelContext] = None
                  ) -> torch.Tensor:
    """Masked synthesis before the overlap-add: -> [M, C, K, L] float32.

    JAX multiplies in the compute dtype and contracts with
    preferred_element_type=f32; here the rounded product is up-cast and
    the contraction runs in f32 (same rounding points). Under TP each rank
    contracts its N piece and the pieces are summed."""
    dt = cfg.dtype
    tp = None if par is None else par.model
    if tp is not None:
        mixture_w = _n_piece(mixture_w, tp)
    source_w = (mixture_w[:, :, None, :] * est_mask).to(dt)  # [M, K, C, N]
    V = params["decoder"]["V"].to(dt).float()
    est_frames = torch.matmul(source_w.float().permute(0, 2, 1, 3), V)  # [M, C, K, L]
    return est_frames if tp is None else reduce_from(est_frames, tp)


def decode(params: Params, cfg: ConvTasNetConfig, mixture_w: torch.Tensor,
           est_mask: torch.Tensor, par: Optional[ParallelContext] = None) -> torch.Tensor:
    """Masked synthesis + overlap-add: -> [M, C, (K-1)*S + L] float32."""
    return overlap_and_add(decode_frames(params, cfg, mixture_w, est_mask, par), cfg.stride)


def forward(params: Params, state: State, cfg: ConvTasNetConfig,
            mixture: torch.Tensor, train: bool = False,
            par: Optional[ParallelContext] = None) -> Tuple[torch.Tensor, State]:
    """Full model: [M, T] -> ([M, C, T] float32 estimates, new_state)."""
    mixture_w = encode(params, cfg, mixture)
    est_mask, new_state = separate(params, state, cfg, mixture_w, train, par)
    est_source = decode(params, cfg, mixture_w, est_mask, par)
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
            m.register_parameter(k, nn.Parameter(v))
    return m


def _from_module(m: nn.Module) -> Params:
    tree = {k: p for k, p in m.named_parameters(recurse=False)}
    tree.update({k: _from_module(c) for k, c in m.named_children()})
    return tree


class ConvTasNet(nn.Module):
    """nn.Module over the functional model: trainable parameters registered
    under the JAX leaf names (e.g. `separator.blocks.in_w`), BN running
    stats as buffers. forward(mixture [M, T]) -> estimates [M, C, T]
    float32, in train mode when the module is (callers that only serve
    wrap it in torch.inference_mode())."""

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
            getattr(self, f"bn_{k}").copy_(v.detach())
        return est

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
