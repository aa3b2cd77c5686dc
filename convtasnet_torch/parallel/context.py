"""Context parallelism (CP): the frame axis K cut over the ranks of a group.

Counterpart of convtasnet_tpu/parallel/context.py. Each rank of the
context group frames its own stretch of the (internally padded) signal and
runs the encoder, the separator and the decoder on it:

  * the dilated depthwise convs exchange (P-1)*dilation boundary frames
    with the neighbours (ops/conv.py), zeros only at the true ends;
  * gLN statistics are all-reduced over the group (ops/norms.py);
  * each rank's overlap-add covers K_loc*S samples plus an (L-S)-sample
    tail that overlaps the next rank's head: tails shift right and are
    added, and the last rank's tail extends the output to
    T_conv = K*S + (L-S), sample for sample like the single-card decoder;
  * the pieces are summed into the whole [M, C, T] estimate on every rank
    of the group (one all-reduce), where the loss is computed alike.

The signal is padded so that K divides the group and every shard holds at
least the largest halo, (P-1)*2**(X-1) frames. gLN statistics include the
padded frames, as with batch-max padding, so the single-card forward on the
same padded signal is the reference. The whole path is differentiable:
the halo and tail exchanges and the statistics' sums carry their
gradients back (parallel/comm.py), and the train step sums the parameter
gradients over the group with the DP ones (training/solver.py).

With a TP model group on the same mesh (TP x CP) the model runs its TP
collectives inside each shard. BN is unsupported, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..config import ConvTasNetConfig
from ..models.conv_tasnet import decode_frames, encode, separate
from ..ops.framing import overlap_and_add
from .comm import ParallelContext, reduce_from, shift_right


def cp_padded_frames(cfg: ConvTasNetConfig, T: int, n: int) -> int:
    """Frame count after internal CP padding: the smallest multiple of n
    that covers T's frames and gives every shard at least the largest halo
    span (a single-neighbour exchange needs K_loc >= (P-1)*2**(X-1))."""
    span = (cfg.P - 1) * 2 ** (cfg.X - 1)
    K = max(cfg.num_frames(max(T, cfg.L)), 1)
    return n * max(-(-K // n), span)


def cp_forward(params, state, cfg: ConvTasNetConfig, mixture: torch.Tensor, mesh,
               train: bool = False) -> torch.Tensor:
    """Context-parallel forward of this rank's rows: [M, T] -> [M, C, T]
    float32, the same on every rank of the context group. Equal to the
    single-card forward on the padded signal, up to summation order."""
    if cfg.norm_type == "BN":
        raise ValueError("BN is unsupported under context parallelism "
                         "(cross-shard running statistics)")
    group, n, c = mesh.context, mesh.cp, mesh.context_rank
    par = ParallelContext(model=mesh.model if mesh.tp > 1 else None, context=group)
    S, L = cfg.stride, cfg.L
    T = mixture.shape[-1]
    K_pad = cp_padded_frames(cfg, T, n)
    T_need = (K_pad - 1) * S + L
    if T_need > T:
        mixture = F.pad(mixture, (0, T_need - T))
    K_loc = K_pad // n
    start = c * K_loc * S
    w = encode(params, cfg, mixture[:, start:start + (K_loc - 1) * S + L])  # [M, K_loc, N]
    mask, _ = separate(params, state, cfg, w, train, par)
    local = overlap_and_add(decode_frames(params, cfg, w, mask, par), S)
    body, tail = local[..., :K_loc * S], local[..., K_loc * S:]
    body = body + F.pad(shift_right(tail, group), (0, K_loc * S - (L - S)))
    piece = torch.cat([body, tail], -1) if c == n - 1 else body
    width = K_pad * S + L - S
    est = reduce_from(F.pad(piece, (start, width - start - piece.shape[-1])), group)
    if width < T:
        est = F.pad(est, (0, T - width))
    return est[..., :T]


def _cp_forward_fn(cfg: ConvTasNetConfig, mesh, train: bool) -> Callable:
    return lambda p, s, m: (cp_forward(p, s, cfg, m, mesh, train=train), s)


def make_cp_train_step(cfg: ConvTasNetConfig, opt, mesh, max_norm: float) -> Callable:
    """The train step (training/solver.make_train_step's signature) with
    the frame axis cut over the mesh's context group."""
    from ..training.solver import make_train_step

    return make_train_step(cfg, opt, max_norm, mesh, _cp_forward_fn(cfg, mesh, True))


def make_cp_eval_step(cfg: ConvTasNetConfig, mesh) -> Callable:
    """The CV step with the frame axis cut over the mesh's context group."""
    from ..training.solver import make_eval_step

    return make_eval_step(cfg, mesh, _cp_forward_fn(cfg, mesh, False))
