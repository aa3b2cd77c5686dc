"""Optimizers on parameter trees: Adam, SGD (+momentum), global-norm clip.

Counterpart of convtasnet_tpu/training/optim.py (the reference's
train.py:72-80 and solver.py:184-185):
  * Adam with L2 coupled into the gradient (torch's weight_decay, not
    AdamW), bias correction, and eps outside the sqrt;
  * SGD in torch's form, buf = momentum * buf + g, p -= lr * buf;
  * clip_by_global_norm as torch's clip_grad_norm_: scale by
    max_norm / (||g|| + 1e-6) only when the norm exceeds max_norm; under
    TP the norm sums the squares of the cut leaves over the model group.

Trees are nested dicts of tensors. The state keeps the JAX package's leaf
structure (`step`, `lr`, `mu/...`, `nu/...`; SGD without momentum keeps
scalar placeholders), so checkpoints carry it across packages. `step` and
`lr` live on the device: an update never waits for the host, and a
learning-rate change needs no rebuild.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch

from ..parallel.comm import all_reduce_

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest]) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """Leaves in sorted-key order (jax.tree_util's order for dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    lr: torch.Tensor    # f32 scalar
    mu: Dict[str, Any]  # first moment (adam) / momentum buffer (sgd) or placeholders
    nu: Dict[str, Any]  # second moment (adam) or placeholders


def tree_map_paths(fn: Callable[[str, Any], Any], tree: Tree, prefix: str = "") -> Tree:
    """tree_map with each leaf's path (keys joined by "/") as fn's first argument."""
    if isinstance(tree, dict):
        return {k: tree_map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def tree_paths(tree: Tree) -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in tree_leaves' order."""
    pairs: List[Tuple[str, torch.Tensor]] = []
    tree_map_paths(lambda p, t: pairs.append((p, t)), tree)
    return sorted(pairs, key=lambda pair: pair[0].split("/"))


def global_norm(tree: Tree, group=None, sharded: Sequence[str] = ()) -> torch.Tensor:
    """The L2 norm of every leaf. Under TP (`group`, the model group) the
    leaves at the `sharded` paths are this rank's pieces: their squares
    are summed over the group (one all-reduce) and the replicated leaves
    count once."""
    if group is None:
        return torch.sqrt(sum((g.float() ** 2).sum() for g in tree_leaves(tree)))
    parts = {True: [], False: []}
    for path, g in tree_paths(tree):
        parts[path in sharded].append((g.float() ** 2).sum())
    zero = tree_leaves(tree)[0].new_zeros((), dtype=torch.float32)
    cut = all_reduce_(sum(parts[True], zero).clone(), group)
    return torch.sqrt(cut + sum(parts[False], zero))


def clip_by_global_norm(grads: Tree, max_norm: float, group=None,
                        sharded: Sequence[str] = ()) -> Tuple[Tree, torch.Tensor]:
    """clip_grad_norm_ semantics: (grads * min(1, max_norm / (norm + 1e-6)), norm)."""
    norm = global_norm(grads, group, sharded)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


class Optimizer:
    """opt.init(params) -> OptState; opt.update(grads, state, params) ->
    (new params, new state). Updates return new tensors."""

    def __init__(self, kind: str = "adam", lr: float = 1e-3, momentum: float = 0.0,
                 weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        if kind not in ("adam", "sgd"):
            raise ValueError(f"unsupported optimizer: {kind}")
        self.kind = kind
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Tree) -> OptState:
        dev = tree_leaves(params)[0].device

        def scalar(p):
            return torch.zeros((), dtype=p.dtype, device=p.device)

        zeros = lambda p: torch.zeros_like(p, memory_format=torch.contiguous_format)  # noqa: E731
        if self.kind == "adam":
            mu, nu = tree_map(zeros, params), tree_map(zeros, params)
        else:
            mu = tree_map(zeros if self.momentum != 0.0 else scalar, params)
            nu = tree_map(scalar, params)
        return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                        lr=torch.tensor(self.lr, dtype=torch.float32, device=dev),
                        mu=mu, nu=nu)

    @torch.no_grad()
    def update(self, grads: Tree, state: OptState, params: Tree) -> Tuple[Tree, OptState]:
        step = state.step + 1
        lr = state.lr
        wd = self.weight_decay
        if wd:
            grads = tree_map(lambda g, p: g + wd * p, grads, params)
        if self.kind == "adam":
            b1, b2, eps = self.b1, self.b2, self.eps
            mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
            nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
            t = step.float()
            # A Python base: no host-to-device copy, so a CUDA graph captures it.
            bc1 = 1 - torch.pow(b1, t)
            bc2 = 1 - torch.pow(b2, t)
            new = tree_map(lambda p, m, v: p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps),
                           params, mu, nu)
            return new, OptState(step, lr, mu, nu)
        if self.momentum != 0.0:
            mu = tree_map(lambda b, g: self.momentum * b + g, state.mu, grads)
            return (tree_map(lambda p, b: p - lr * b, params, mu),
                    OptState(step, lr, mu, state.nu))
        return (tree_map(lambda p, g: p - lr * g, params, grads),
                OptState(step, lr, state.mu, state.nu))


def set_lr(state: OptState, lr) -> OptState:
    """Write `lr` into the state's device scalar in place and return the
    state: a captured train step (training/solver.GraphedStep) reads the
    rate at that address on every replay."""
    state.lr.fill_(float(lr))
    return state
