"""Autograd-aware collectives over a torch.distributed process group.

The port's stand-in for the JAX package's lax.psum / lax.ppermute inside
shard_map, and for the collectives GSPMD inserts. Every rank runs its
local part of one computation whose downstream is either *sharded* (each
rank goes on with its own part) or *replicated* (every rank goes on with
the same values and computes the same loss). The backward of each op
follows from which:

  all_reduce_sum  sum -> sharded downstream (norm statistics): the
                  gradient of the sum is the sum of every rank's
                  gradient, so the backward all-reduces (psum's transpose);
  copy_to         identity -> sharded downstream (a replicated activation
                  or parameter entering column-parallel work): the
                  backward all-reduces (Megatron's f);
  reduce_from     sum -> replicated downstream (after row-parallel work,
                  or gathering waveform pieces for a replicated loss): the
                  backward is the identity (Megatron's g);
  shift_right /   neighbour exchange along the group's rank order; the
  shift_left      end rank receives zeros and the backward shifts the
                  gradient the other way (ppermute and its transpose).

GradBucket is the data-parallel gradient all-reduce: one flat buffer,
every gradient leaf a view of it, one collective per step.

Each launched collective counts one `collectives` in the port's launch
ledger (utils/ledger.py), read by `counts()`; a group of one rank launches
nothing for a shift. The ledger holds the kernel wrappers' launch counts
too, and models/graphed.py takes what a capture records off it again and
adds it back on every replay, so the count says how many collectives ran,
whether a step ran eagerly or as a graph. Nothing here falls back: a backend that cannot
carry an op raises from torch.distributed.

What the ops do on the device is all the device needs: none reads a value
on the host, so an NCCL group's collectives can be recorded into a CUDA
graph (training/solver.py captures the DP step so).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils import ledger

COUNTERS = ("collectives",)


def counts() -> dict:
    return ledger.read(COUNTERS)


def reset_counts() -> None:
    ledger.reset(COUNTERS)


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """The groups a forward reduces over (each None when not sharded):
    model (TP: H and N cut over it), context (CP: frames cut over it) and
    data (DP: BN's batch statistics sum over it)."""

    model: Any = None
    context: Any = None
    data: Any = None

    @property
    def sharded(self) -> bool:
        """Whether the forward runs the TP or CP collectives (and so the
        eager chain, as the JAX package does under TP and CP)."""
        return self.model is not None or self.context is not None

    def norm_groups(self, norm_type: str) -> Tuple:
        """The groups a norm's statistics sum over: gLN over channels and
        frames, cLN over channels, BN over the batch rows."""
        groups = {"gLN": (self.model, self.context), "cLN": (self.model,),
                  "BN": (self.data,)}[norm_type]
        return tuple(g for g in groups if g is not None)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over the group (no autograd); returns t."""
    ledger.count("collectives")
    dist.all_reduce(t, group=group)
    return t


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, feeding sharded work (backward: all-reduce)."""
    return _AllReduceSum.apply(x, group)


def all_reduce_groups(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """all_reduce_sum over each group in turn (a sum over their product)."""
    for g in groups:
        x = all_reduce_sum(x, g)
    return x


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity, feeding sharded work (backward: all-reduce)."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, feeding replicated work (backward: identity)."""
    return _ReduceFrom.apply(x, group)


def _exchange(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Rank i receives rank i - step's x (zeros where there is none)."""
    n, r = group_size(group), group_rank(group)
    out = torch.zeros_like(x)
    x = x.contiguous()
    ops = []
    if 0 <= r + step < n:
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, r + step), group))
    if 0 <= r - step < n:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, r - step), group))
    if ops:
        ledger.count("collectives")
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return _exchange(x, group, step)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, -ctx.step), None, None


def shift_right(x: torch.Tensor, group) -> torch.Tensor:
    """Rank i gets rank i-1's x; rank 0 gets zeros."""
    return _Shift.apply(x, group, 1)


def shift_left(x: torch.Tensor, group) -> torch.Tensor:
    """Rank i gets rank i+1's x; the last rank gets zeros."""
    return _Shift.apply(x, group, -1)


def broadcast_(tensors: List[torch.Tensor], src: int = 0) -> None:
    """Broadcast each tensor in place from global rank `src`."""
    for t in tensors:
        ledger.count("collectives")
        dist.broadcast(t, src)


class GradBucket:
    """The data-parallel gradient all-reduce in one collective.

    A flat f32 buffer holds every gradient leaf (in the order given) plus
    `extra` trailing scalars that ride along (the step's loss); `reduce`
    copies the gradients in, all-reduces the buffer once and returns the
    leaves as views of it. The buffer is allocated here, at the step's
    first (eager) call, outside any CUDA graph's pool, and keeps its
    address: a captured step's replays write into it and read it back."""

    def __init__(self, leaves: Sequence[torch.Tensor], group, extra: int = 0):
        self.shapes = [tuple(t.shape) for t in leaves]
        self.sizes = [t.numel() for t in leaves]
        self.group = group
        self.extra = extra
        self.buffer = torch.empty(sum(self.sizes) + extra, dtype=torch.float32,
                                  device=leaves[0].device)

    @property
    def nbytes(self) -> int:
        return self.buffer.numel() * self.buffer.element_size()

    def reduce(self, grads: Sequence[torch.Tensor], extra: Optional[Sequence[torch.Tensor]] = None):
        """-> (summed gradient views, summed extra scalars)."""
        parts = [g.reshape(-1).float() for g in grads]
        parts += [e.reshape(1).float() for e in (extra or ())]
        torch.cat(parts, out=self.buffer)
        all_reduce_(self.buffer, self.group)
        views = torch.split(self.buffer[: self.buffer.numel() - self.extra], self.sizes)
        out = [v.view(s) for v, s in zip(views, self.shapes)]
        return out, self.buffer[self.buffer.numel() - self.extra:]
