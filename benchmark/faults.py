"""Faults planted in the port underneath a run, to show that the check
fails them (benchmark/calibrate.py on the card, tests/test_bench_faults.py
on the CPU). Each is a context manager that patches one function of the
port where its answer is produced:

  stale       a train step that returns its state unchanged;
  half_batch  half of the batch left out: the loss is the mean over the
              first half; a forward separates the first half and leaves
              the other rows zero;
  altered     an answer altered where it is produced: a forward's first
              row's first source, or a train step's first gradient leaf
              (its update's source), gets half of itself one sample (one
              element) late added.

The exchange between chips does not exist on one chip.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

NAMES = ("stale", "half_batch", "altered")


def _alter(est: torch.Tensor) -> torch.Tensor:
    est = est.clone()
    est[0, 0] = est[0, 0] + 0.5 * torch.roll(est[0, 0], 1, dims=-1)
    return est


def _alter_first_leaf(tree):
    k = sorted(tree)[0]
    v = tree[k]
    if isinstance(v, dict):
        return {**tree, k: _alter_first_leaf(v)}
    return {**tree, k: v + 0.5 * torch.roll(v.flatten(), 1).reshape(v.shape)}


@contextlib.contextmanager
def plant(name: str):
    from convtasnet_torch.models import conv_tasnet, streaming
    from convtasnet_torch.training import optim, solver

    with contextlib.ExitStack() as stack:
        if name == "stale":
            stack.enter_context(mock.patch.object(
                optim.Optimizer, "update", lambda self, grads, state, params: (params, state)))
        elif name == "half_batch":
            loss, fwd = solver.cal_loss, conv_tasnet.forward

            def half_loss(source, est, lengths, *a, **k):
                h = max(1, source.shape[0] // 2)
                return loss(source[:h], est[:h], lengths[:h], *a, **k)

            def half_fwd(params, state, cfg, mixture, *a, **k):
                h = max(1, mixture.shape[0] // 2)
                est, new_state = fwd(params, state, cfg, mixture[:h], *a, **k)
                full = est.new_zeros((mixture.shape[0],) + tuple(est.shape[1:]))
                full[:h] = est
                return full, new_state

            stack.enter_context(mock.patch.object(solver, "cal_loss", half_loss))
            stack.enter_context(mock.patch.object(conv_tasnet, "forward", half_fwd))
        elif name == "altered":
            fwd, step = conv_tasnet.forward, streaming.stream_step
            clip = solver.clip_by_global_norm

            def altered_fwd(*a, **k):
                est, new_state = fwd(*a, **k)
                return _alter(est), new_state

            def altered_step(*a, **k):
                body, new_state = step(*a, **k)
                return _alter(body), new_state

            def altered_clip(grads, *a, **k):
                grads, norm = clip(grads, *a, **k)
                return _alter_first_leaf(grads), norm

            stack.enter_context(mock.patch.object(conv_tasnet, "forward", altered_fwd))
            stack.enter_context(mock.patch.object(streaming, "stream_step", altered_step))
            stack.enter_context(mock.patch.object(solver, "clip_by_global_norm", altered_clip))
        else:
            raise ValueError(f"unknown fault {name!r}; have {NAMES}")
        yield
