"""The process mesh and its sharding rules: data, tensor and context parallelism.

Counterpart of convtasnet_tpu/parallel/mesh.py. The JAX package builds one
('data', 'model'[, 'context']) device Mesh inside one process and lets
GSPMD place the shards; the port runs one process per card, so the mesh
is a torch.distributed DeviceMesh of ranks with the same dims, and every
placement is explicit:

* DP ('data'): each rank keeps its rows of the zero-padded global batch
  (shard_batch_fn); the train step all-reduces the gradients in one flat
  bucket and the loss divides by the global count of real rows;
* TP ('model', Megatron within each block): each rank keeps slices of the
  parameter tree under _TP_RULES (H for the block weights, N for the
  bottleneck rows, the mask columns and the decoder rows), and the model
  runs the matching collectives (models/conv_tasnet.py);
* CP ('context'): each rank keeps a slice of the frame axis
  (parallel/context.py).

Rank r sits at coordinate (d, m[, c]) with r = (d * tp + m) * cp + c.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..training.optim import tree_map_paths, tree_paths
from .comm import ParallelContext, all_reduce_, broadcast_
from .distributed import device as _device, pad_rows, rank as _rank, world_size

# Parameter partition rules for TP: leaf path suffix -> how the leaf is cut.
# An int is the axis cut into tp contiguous chunks; "mask" cuts N inside
# each of the C speakers of mask/w [B, C*N], so rank m holds the columns
# c*N + n for n in its N chunk and the softmax / relu over C stays local.
# The decoder's rows follow the same N chunk, so its contraction over N is
# one all-reduce. BN's running statistics follow H.
_TP_RULES = (
    ("bottleneck/w", 0),
    ("blocks/in_w", -1),
    ("blocks/in_gamma", -1),
    ("blocks/in_beta", -1),
    ("blocks/dw_w", -1),
    ("blocks/dw_gamma", -1),
    ("blocks/dw_beta", -1),
    ("blocks/out_w", -2),
    ("mask/w", "mask"),
    ("decoder/V", 0),
    ("blocks/in_mean", -1),
    ("blocks/in_var", -1),
    ("blocks/dw_mean", -1),
    ("blocks/dw_var", -1),
)


def tp_rule(path: str):
    """How the leaf at `path` is cut under TP (None: replicated)."""
    for key, rule in _TP_RULES:
        if path.endswith(key):
            return rule
    return None


def mesh_shape(dp: int, tp: int, cp: int, world: int) -> Tuple[int, int, int]:
    """(dp, tp, cp) for `world` ranks; dp <= 0 means world / (tp * cp)."""
    if tp < 1 or cp < 1:
        raise ValueError(f"tp={tp} and cp={cp} must be at least 1")
    if dp <= 0:
        if world % (tp * cp):
            raise ValueError(f"{world} ranks not divisible by tp*cp={tp * cp}")
        dp = world // (tp * cp)
    if dp * tp * cp != world:
        raise ValueError(
            f"dp*tp*cp={dp * tp * cp} must equal the world size {world} (one process "
            f"per card): launch with torchrun --nproc_per_node {dp * tp * cp} -m "
            f"convtasnet_torch.cli.<train|evaluate|separate> --dp {dp} --tp {tp} --cp {cp}")
    return dp, tp, cp


@dataclasses.dataclass
class Mesh:
    """This rank's view of the process mesh: sizes, coordinate, groups."""

    device_mesh: Any
    dp: int
    tp: int
    cp: int
    data_rank: int
    model_rank: int
    context_rank: int
    data: Any       # ranks with this rank's (model, context): the batch rows
    model: Any      # ranks with this rank's (data, context): the TP shards
    context: Any    # ranks with this rank's (data, model): the frame shards
    replica: Any    # ranks with this rank's model coordinate: gradient sums
    device: torch.device

    @property
    def world(self) -> int:
        return self.dp * self.tp * self.cp

    @property
    def par(self) -> ParallelContext:
        """The model's parallel context: the model group under TP, the data
        group for BN's batch statistics under DP. On a DP mesh the forward
        of a gLN / cLN model is the single-card one, kernels included."""
        return ParallelContext(model=self.model if self.tp > 1 else None,
                               data=self.data if self.dp > 1 else None)

    def rows_of(self, b_pad: int, mixture, lengths, source):
        """Pad the global batch to b_pad rows; this rank's rows as tensors."""
        lo, hi = self.data_rank * b_pad // self.dp, (self.data_rank + 1) * b_pad // self.dp

        def local(a):
            a = pad_rows(a, b_pad)[lo:hi]
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, non_blocking=True)

        return local(mixture), local(lengths), None if source is None else local(source)


def make_mesh(dp: int = 0, tp: int = 1, cp: int = 1, device=None) -> Mesh:
    """The ('data', 'model') mesh, or ('data', 'model', 'context') when
    cp > 1, over the ranks of the initialised process group. `device` is
    where this rank's rows go; by default the rank's own device
    (distributed.device(): the card unless the CPU was asked for)."""
    dp, tp, cp = mesh_shape(dp, tp, cp, world_size())
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.distributed.initialize)")
    from torch.distributed.device_mesh import DeviceMesh

    device = _device() if device is None else torch.device(device)
    names = ("data", "model", "context") if cp > 1 else ("data", "model")
    shape = (dp, tp, cp) if cp > 1 else (dp, tp)
    dm = DeviceMesh(device.type, torch.arange(dp * tp * cp).reshape(shape),
                    mesh_dim_names=names)
    r = _rank()
    d, m, c = r // (tp * cp), (r // cp) % tp, r % cp
    data, model = dm.get_group("data"), dm.get_group("model")
    context = dm.get_group("context") if cp > 1 else None
    if cp == 1:
        replica = data
    elif dp == 1:
        replica = context
    else:
        # Every rank creates every group, in the same order.
        replica = None
        for mm in range(tp):
            ranks = [(dd * tp + mm) * cp + cc for dd in range(dp) for cc in range(cp)]
            g = dist.new_group(ranks)
            if mm == m:
                replica = g
    return Mesh(dm, dp, tp, cp, d, m, c, data, model, context, replica, device)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def tp_slice(t: torch.Tensor, rule, tp: int, m: int, C: int) -> torch.Tensor:
    """Rank m's piece of a full leaf under `rule` (a contiguous copy)."""
    if rule is None or t.ndim == 0:
        return t
    if rule == "mask":
        B = t.shape[0]
        N = t.shape[1] // C
        n = N // tp
        return t.reshape(B, C, N)[:, :, m * n:(m + 1) * n].reshape(B, C * n).contiguous()
    size = t.shape[rule] // tp
    return t.narrow(rule, m * size, size).contiguous()


def tp_place(piece: torch.Tensor, rule, tp: int, m: int, C: int) -> torch.Tensor:
    """Rank m's piece at its place in a zero leaf of the full shape (the
    sum over the model group of every rank's placement is the full leaf)."""
    if rule == "mask":
        B, n = piece.shape[0], piece.shape[1] // C
        full = piece.new_zeros((B, C, n * tp))
        full[:, :, m * n:(m + 1) * n] = piece.reshape(B, C, n)
        return full.reshape(B, C * n * tp)
    shape = list(piece.shape)
    shape[rule] *= tp
    full = piece.new_zeros(shape)
    full.narrow(rule, m * piece.shape[rule], piece.shape[rule]).copy_(piece)
    return full


def tp_sharded_paths(tree) -> Tuple[str, ...]:
    """Paths of the leaves of `tree` that TP cuts."""
    return tuple(p for p, t in tree_paths(tree) if tp_rule(p) is not None and t.ndim > 0)


def _opt_map(fn, opt_state):
    if opt_state is None:
        return None
    return opt_state._replace(mu=fn(opt_state.mu), nu=fn(opt_state.nu))


def shard_params_fn(mesh: Mesh, tp: int, C: int) -> Callable:
    """Returns (params, state, opt_state) -> this rank's pieces: each leaf
    under _TP_RULES cut to the rank's model coordinate, the optimizer's
    moments like their parameters, everything else whole."""

    def place(tree):
        return tree_map_paths(lambda p, t: tp_slice(t, tp_rule(p) if tp > 1 else None, tp,
                                                mesh.model_rank, C), tree)

    def shard(params, state, opt_state):
        return place(params), place(state), _opt_map(place, opt_state)

    return shard


def gather_params(mesh: Mesh, C: int, params, state=None, opt_state=None):
    """Inverse of shard_params_fn: the whole trees on every rank, from one
    all-reduce of the zero-placed pieces over the model group per leaf."""
    tp = mesh.tp

    def whole(tree):
        if tree is None or tp == 1:
            return tree

        def one(path, t):
            rule = tp_rule(path)
            if rule is None or t.ndim == 0:
                return t
            return all_reduce_(tp_place(t.detach(), rule, tp, mesh.model_rank, C), mesh.model)

        return tree_map_paths(one, tree)

    return whole(params), whole(state), _opt_map(whole, opt_state)


def broadcast_tree(tree, src: int = 0) -> None:
    """Every leaf of `tree` (tensors, in place) from global rank src."""
    broadcast_([t for _, t in tree_paths(tree)], src)


# --------------------------------------------------------------------------
# Batches and the DP forward
# --------------------------------------------------------------------------

def shard_batch_fn(mesh: Mesh) -> Callable:
    """Returns (mixture, lengths, source) -> this rank's rows as tensors on
    its device. A batch that does not divide by dp is padded with zero
    rows (length 0) to the next multiple: the loss gives them weight 0, so
    loss and gradients are exact and every rank keeps 1/dp of the work."""

    def shard(mixture, lengths, source):
        b = np.asarray(mixture).shape[0]
        return mesh.rows_of(-(-b // mesh.dp) * mesh.dp, mixture, lengths, source)

    return shard


def graphable(mesh: Optional[Mesh]) -> bool:
    """Whether the inference forward of `mesh` (None: one card) has no
    collective on its path and may be captured as a CUDA graph: one card,
    or DP with tp = cp = 1 (each rank runs the single-card forward on its
    rows). TP and CP run collectives inside the forward; their graphs wait
    for a machine with two cards. The train and CV steps have their own
    gate, `steps_graphable`."""
    return mesh is None or (mesh.tp == 1 and mesh.cp == 1)


def steps_graphable(mesh: Optional[Mesh]) -> bool:
    """Whether the train and CV steps of `mesh` (None: one card) may be
    captured as CUDA graphs with their collectives inside, as the JAX
    package jits one step under every mesh: one card, or DP with tp = cp = 1
    whose data group is NCCL on a card. The DP step's all-reduces (the
    real-row count, the gradient bucket, the CV loss, BN's batch
    statistics) are NCCL kernels, which a graph records; gloo stages them
    through the host and cannot be captured, on the CPU or on a card. TP
    and CP stay eager: their forwards hold collectives that one card cannot
    check (NCCL refuses two ranks on one card)."""
    if mesh is None:
        return True
    return (mesh.tp == 1 and mesh.cp == 1 and mesh.device.type == "cuda"
            and dist.get_backend(mesh.data) == "nccl")


def mesh_forward(cfg, params, state, mesh: Optional[Mesh]) -> Callable:
    """The inference forward of one card or of this rank's part of a mesh:
    fn(mixture rows [M, T]) -> est [M, C, T]. Under CP the rank runs its
    frames (parallel/context.py); otherwise the single-card forward with
    the mesh's collectives: its TP pieces on the eager chain, or under DP
    its own rows in cfg.kernel_form, the kernels gridding over them (the
    counterpart of the JAX package's make_dp_forward)."""
    from ..models.conv_tasnet import forward

    if mesh is None:
        return lambda mix: forward(params, state, cfg, mix, train=False)[0]
    params, state, _ = shard_params_fn(mesh, mesh.tp, cfg.C)(params, state, None)
    if mesh.cp > 1:
        from .context import cp_forward

        return lambda mix: cp_forward(params, state, cfg, mix, mesh)
    return lambda mix: forward(params, state, cfg, mix, train=False, par=mesh.par)[0]
