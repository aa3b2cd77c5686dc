"""Training engine: train / eval steps, the epoch loop and the LR / stopping
policy.

Counterpart of convtasnet_tpu/training/solver.py (the reference Solver,
solver.py:12-210):
* one train step: forward with train=True (the TCN chain in the form
  cfg.kernel_form(True) names), uPIT loss, backward, global-norm clip,
  optimizer update; the eval step runs train=False under no_grad, so it
  takes the inference kernels under any truthy use_kernels;
* the learning rate lives in the optimizer state on the device, so
  LR halving on a plateau (solver.py:105-123) is a tensor update;
* per-epoch and best-model checkpoints, `continue_from`, and
  `save_every_steps` mid-epoch resume with the running loss sums;
* the CV mean weights each batch by its real utterance count;
* device scalars (loss) are read back only at print_freq points and at
  the end of an epoch, so the host keeps queueing steps;
* the host time spent waiting for data (the loader's next batch and its
  copy to the device) is summed per epoch, always on, and written with
  the training epoch as `data_wait_s` and `data_wait_share` (of the
  epoch's time) into history.jsonl and its summary line;
* with `visualize`, <save_folder>/loss.png is re-rendered each epoch and
  loss_iter.png from every iteration's loss (kept as a device scalar,
  drained at those read-back points, redrawn at most every
  `iter_plot_interval` seconds and once at the end); a plot that fails is
  logged ("visualize failed: ...") and training goes on
  (utils/visualize.py).

On one card, and on every rank of a DP mesh (tp = cp = 1) whose data
group is NCCL, both steps run as CUDA graphs, one per key of batch
shapes (`GraphedStep`, models/graphed.py), as the JAX package jits them
under every mesh: the parameters, optimizer state and BN state live in
static buffers that every call (eager first call, capture, replay)
updates in place, the counterpart of the JAX step's donated buffers.
Under DP the step's NCCL all-reduces are recorded inside the graph, as
XLA puts the gradient all-reduce inside the jitted step; each call runs
each of them once on every rank, and the ranks' keys agree because every
rank keeps the same number of rows of the padded global batch. On the
CPU the same wrappers run every call eagerly. TP, CP and gloo groups
keep both steps eager (parallel/mesh.steps_graphable).

On a process mesh (parallel/mesh.py; one process per card) every rank
loads the same global batch and keeps its rows (`shard_batch`), and its
pieces of the parameters under TP (`shard_params`). The parameters are
broadcast from rank 0 at the start and after `continue_from`. A train
step runs the forward on the rank's rows, divides its loss by the global
count of real rows, and sums the gradients over the ranks that share its
model coordinate in one flat-bucket all-reduce, with the loss riding in
the same bucket; a CV step sums its loss over the data group. Only the
coordinator logs and writes, and under TP it writes the whole tree, so
the checkpoint loads at tp 1 in either package.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import ConvTasNetConfig, TrainConfig
from ..models.conv_tasnet import ConvTasNet, forward
from ..models.graphed import GraphedForward
from ..ops.loss import cal_loss
from ..parallel.comm import GradBucket, all_reduce_
from ..parallel.context import make_cp_eval_step, make_cp_train_step
from ..parallel.distributed import is_coordinator
from ..parallel.mesh import (broadcast_tree, gather_params, shard_batch_fn, shard_params_fn,
                             steps_graphable, tp_sharded_paths)
from ..utils.observability import span
from .checkpoint import load_checkpoint, save_checkpoint
from .optim import Optimizer, clip_by_global_norm, set_lr, tree_leaves, tree_map


def _forward_fn(cfg: ConvTasNetConfig, mesh, train: bool) -> Callable:
    par = None if mesh is None else mesh.par
    return lambda p, s, m: forward(p, s, cfg, m, train=train, par=par)


def make_train_step(cfg: ConvTasNetConfig, opt: Optimizer, max_norm: float,
                    mesh=None, forward_fn: Optional[Callable] = None) -> Callable:
    """step(params, opt_state, state, mixture, source, lengths) ->
    (params, opt_state, state, loss, grad_norm), all on the device.

    With a mesh (parallel/mesh.py) the step is one rank's: its rows, its
    TP pieces, and per step one all-reduce of the real-row count and one
    of the gradient bucket (which also sums the loss to the global mean),
    plus the collectives of TP, CP and BN. forward_fn(params, state,
    mixture) -> (est, new_state) replaces the forward (the CP step)."""
    forward_fn = forward_fn or _forward_fn(cfg, mesh, True)
    bucket: List[GradBucket] = []
    sharded: tuple = ()

    def step(params, opt_state, state, mixture, source, lengths):
        nonlocal sharded
        leaves_tree = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(leaves_tree)
        est, new_state = forward_fn(leaves_tree, state, mixture)
        loss, *_ = cal_loss(source, est, lengths, group=None if mesh is None else mesh.data)
        grad_list = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        model_group = None
        if mesh is not None:
            if not bucket:
                bucket.append(GradBucket(leaves, mesh.replica, extra=1))
                sharded = tp_sharded_paths(params) if mesh.tp > 1 else ()
            # The context ranks of a row share one loss: count it once.
            share = loss if mesh.context_rank == 0 else torch.zeros_like(loss)
            grad_list, summed = bucket[0].reduce(grad_list, [share])
            loss = summed[0].clone()  # summed is a view of the reused bucket
            model_group = mesh.model if mesh.tp > 1 else None
        grad_of = dict(zip(map(id, leaves), grad_list))
        grads = tree_map(lambda p: grad_of[id(p)], leaves_tree)
        grads, grad_norm = clip_by_global_norm(grads, max_norm, model_group, sharded)
        params, opt_state = opt.update(grads, opt_state, params)
        new_state = tree_map(lambda t: t.detach(), new_state)
        return params, opt_state, new_state, loss, grad_norm

    step.bucket = bucket
    return step


def make_eval_step(cfg: ConvTasNetConfig, mesh=None,
                   forward_fn: Optional[Callable] = None) -> Callable:
    """step(params, state, mixture, source, lengths) -> loss; with a mesh
    the loss of the global batch (its shares summed over the data group)."""
    forward_fn = forward_fn or _forward_fn(cfg, mesh, False)

    @torch.no_grad()
    def step(params, state, mixture, source, lengths):
        est, _ = forward_fn(params, state, mixture)
        loss, *_ = cal_loss(source, est, lengths, group=None if mesh is None else mesh.data)
        return loss if mesh is None else all_reduce_(loss, mesh.data)

    return step


def _all_leaves(params, opt_state, state) -> List[torch.Tensor]:
    return (tree_leaves(params) + [opt_state.step, opt_state.lr] + tree_leaves(opt_state.mu)
            + tree_leaves(opt_state.nu) + tree_leaves(state))


@torch.no_grad()
def _copy_into(static: List[torch.Tensor], params, opt_state, state) -> None:
    """Write the trees' leaves into the static leaves that are not they."""
    for dst, src in zip(static, _all_leaves(params, opt_state, state)):
        if dst is not src:
            dst.copy_(src)


class GraphedStep:
    """A train step over static trees, captured per key of (mixture,
    source, lengths) shapes by models/graphed.GraphedForward (stateful).

    `params`, `opt_state` and `state` become the static trees: every call
    writes the step's new trees into them in place and returns them
    themselves, so each call applies exactly one update, an eager call
    and a replay alike, and a captured graph keeps reading and writing the
    same addresses (the counterpart of donate_argnums). Trees passed in
    that are not the static ones (a checkpoint loaded later, a new `lr`
    tensor) are copied into them first. The returned loss and grad_norm
    are clones, which the next replay leaves alone. While a torch.profiler
    session is active a call records the span `step.call` over
    `step.adopt` (trees copied in) and the wrapper's `graphed.*` spans."""

    def __init__(self, step: Callable, params, opt_state, state, tag: tuple = ()):
        self.params, self.opt_state, self.state = params, opt_state, state
        self._static = static = _all_leaves(params, opt_state, state)

        # Closes over the trees, not over self: the wrapper and its graphs
        # are freed with the step.
        def update(mixture, source, lengths):
            *new, loss, grad_norm = step(params, opt_state, state, mixture, source, lengths)
            _copy_into(static, *new)
            return loss, grad_norm

        self.graphed = GraphedForward(update, tag, stateful=True)

    def _adopt(self, params, opt_state, state) -> None:
        if not (params is self.params and opt_state is self.opt_state and state is self.state):
            with span("step.adopt"):
                _copy_into(self._static, params, opt_state, state)

    def __call__(self, params, opt_state, state, mixture, source, lengths):
        with span("step.call"):
            self._adopt(params, opt_state, state)
            loss, grad_norm = self.graphed(mixture, source, lengths)
        return self.params, self.opt_state, self.state, loss, grad_norm

    def eval_step(self, eval_step: Callable, tag: tuple = ()) -> Callable:
        """eval_step(params, state, mixture, source, lengths) as a
        GraphedForward whose program reads the static trees, so a replay
        sees the latest update; its wrapper is the result's `graphed`."""
        params, state = self.params, self.state
        fwd = GraphedForward(lambda m, s, l: eval_step(params, state, m, s, l), tag)

        def step(params, state, mixture, source, lengths):
            self._adopt(params, self.opt_state, state)
            return fwd(mixture, source, lengths)

        step.graphed = fwd
        return step


class Solver:
    """Epoch loop with the reference's LR-halving / early-stop state machine.

    The model's parameters and state are the starting point (or those of
    `continue_from`); training runs on the functional trees and writes the
    final parameters back into the module."""

    def __init__(self, model: ConvTasNet, train_cfg: TrainConfig, tr_loader, cv_loader,
                 log: Optional[Callable[[str], None]] = None, metric_logger=None,
                 train_step: Optional[Callable] = None,
                 eval_step: Optional[Callable] = None,
                 mesh=None, shard_batch: Optional[Callable] = None,
                 shard_params: Optional[Callable] = None):
        self.model = model
        self.cfg = train_cfg
        self.tr_loader = tr_loader
        self.cv_loader = cv_loader
        self.device = next(model.parameters()).device
        self.mesh = mesh
        self.shard_batch = shard_batch
        if mesh is not None:
            self.shard_batch = shard_batch or shard_batch_fn(mesh)
            shard_params = shard_params or shard_params_fn(mesh, mesh.tp, model.cfg.C)
            if not is_coordinator():
                log, metric_logger = (lambda msg: None), None
        if metric_logger is None and log is None:
            from ..utils.observability import MetricLogger

            metric_logger = MetricLogger(train_cfg.save_folder)
        self.metric_logger = metric_logger
        self.log = log or metric_logger.log

        self.opt = Optimizer(kind=train_cfg.optimizer, lr=train_cfg.lr,
                             momentum=train_cfg.momentum, weight_decay=train_cfg.l2)
        params = tree_map(lambda p: p.detach().clone(), model.params())
        state = tree_map(lambda t: t.detach().clone(), model.state())
        opt_state = self.opt.init(params)
        self.start_epoch = 0
        self.tr_loss: List[float] = []
        self.cv_loss: List[float] = []
        self.resume_step, self.resume_loss, self.resume_audio = 0, 0.0, 0.0
        if train_cfg.continue_from:
            self.log(f"Loading checkpoint {train_cfg.continue_from}")
            ck = load_checkpoint(train_cfg.continue_from, self.device,
                                 params_template=params, state_template=state,
                                 opt_template=opt_state)
            params, state = ck["params"], ck["state"]
            opt_state = ck.get("opt_state", opt_state)
            header = ck["header"]
            self.start_epoch = header["epoch"]
            self.tr_loss = header["tr_loss"][: self.start_epoch]
            self.cv_loss = header["cv_loss"][: self.start_epoch]
            # Mid-epoch checkpoint: resume inside the epoch it was cut in,
            # with the running sums, so the epoch average is exact.
            extra = header.get("extra", {}) or {}
            self.resume_step = int(extra.get("step_in_epoch", 0))
            if self.resume_step:
                self.resume_loss = float(extra.get("running_loss", 0.0))
                self.resume_audio = float(extra.get("running_audio_sec", 0.0))
        if mesh is not None:
            broadcast_tree({"params": params, "state": state, "mu": opt_state.mu,
                            "nu": opt_state.nu, "step": opt_state.step, "lr": opt_state.lr})
        if shard_params is not None:
            params, state, opt_state = shard_params(params, state, opt_state)
        self.params, self.state, self.opt_state = params, state, opt_state
        if mesh is not None and mesh.cp > 1:
            train_step = train_step or make_cp_train_step(model.cfg, self.opt, mesh,
                                                          train_cfg.max_norm)
            eval_step = eval_step or make_cp_eval_step(model.cfg, mesh)
        train_step = train_step or make_train_step(model.cfg, self.opt, train_cfg.max_norm, mesh)
        eval_step = eval_step or make_eval_step(model.cfg, mesh)
        # One card or DP over NCCL: both steps as CUDA graphs (eager on the
        # CPU). The trees were broadcast above, so every rank's static
        # trees start equal.
        if steps_graphable(mesh):
            train_step = GraphedStep(train_step, params, opt_state, state,
                                     tag=(model.cfg.kernel_form(True, self.device),))
            eval_step = train_step.eval_step(eval_step,
                                             tag=(model.cfg.kernel_form(False, self.device),))
        self.train_step, self.eval_step = train_step, eval_step
        self.prev_val_loss = float("inf")
        self.best_val_loss = float("inf")
        self.halving = False
        self.val_no_impv = 0
        self.steps = 0
        self.data_wait_s = 0.0   # the last epoch's wait for data, and its share of the epoch
        self.data_wait_share = 0.0
        self.history: List[Dict[str, Any]] = []
        # Per-iteration loss points of loss_iter.png: (iter, epoch, device
        # loss) pending until a read-back point, then floats.
        self.iter_history: List[Dict[str, Any]] = []
        self._pending_iter: List[tuple] = []
        self.iter_plot_interval: float = 5.0
        self._last_iter_plot: float = 0.0

    # ------------------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        cfg = self.cfg
        os.makedirs(cfg.save_folder, exist_ok=True)
        for epoch in range(self.start_epoch, cfg.epochs):
            self.log("Training...")
            t0 = time.time()
            tr_avg, audio_sps = self._run_one_epoch(epoch, cross_valid=False)
            wait = {"data_wait_s": self.data_wait_s, "data_wait_share": self.data_wait_share}
            self.log(f"Train Summary | End of Epoch {epoch + 1} | "
                     f"Time {time.time() - t0:.2f}s | Train Loss {tr_avg:.3f} | "
                     f"{audio_sps:.1f} audio-s/s | data wait {self.data_wait_s:.3f}s "
                     f"({100 * self.data_wait_share:.1f} %)")

            self.log("Cross validation...")
            t0 = time.time()
            val_loss, _ = self._run_one_epoch(epoch, cross_valid=True)
            self.log(f"Valid Summary | End of Epoch {epoch + 1} | "
                     f"Time {time.time() - t0:.2f}s | Valid Loss {val_loss:.3f}")

            # LR halving / early stop (solver.py:105-123 semantics).
            stop = False
            if cfg.half_lr:
                if val_loss >= self.prev_val_loss:
                    self.val_no_impv += 1
                    if self.val_no_impv >= 3:
                        self.halving = True
                    if self.val_no_impv >= 10 and cfg.early_stop:
                        self.log("No improvement for 10 epochs, early stopping.")
                        stop = True
                else:
                    self.val_no_impv = 0
            if self.halving:
                new_lr = float(self.opt_state.lr) / 2.0
                self.opt_state = set_lr(self.opt_state, new_lr)
                self.log(f"Learning rate adjusted to: {new_lr:.6f}")
                self.halving = False
            self.prev_val_loss = val_loss
            if self.graph_counts() is not None:
                self.log(f"Graphs | End of Epoch {epoch + 1} | {self.graph_counts()}")

            self.tr_loss.append(tr_avg)
            self.cv_loss.append(val_loss)
            # Saved after the epoch's losses are recorded, so epochN.ckpt is
            # self-consistent.
            if cfg.checkpoint:
                path = os.path.join(cfg.save_folder, f"epoch{epoch + 1}.ckpt")
                self._save(path, epoch + 1)
                self.log(f"Saving checkpoint model to {path}")
            self.history.append({"epoch": epoch + 1, "tr_loss": tr_avg, "cv_loss": val_loss,
                                 "lr": float(self.opt_state.lr), "audio_sps": audio_sps,
                                 **wait})
            if self.metric_logger is not None:
                self.metric_logger.metrics(**self.history[-1])
            if cfg.visualize:
                self._plot("plot_history", self.history, "loss.png")
            if val_loss < self.best_val_loss:
                self.best_val_loss = val_loss
                path = os.path.join(cfg.save_folder, cfg.model_path)
                self._save(path, epoch + 1)
                self.log(f"Find better validated model, saving to {path}")
            if stop:
                break
        # Unthrottled, so loss_iter.png ends with the last iterations.
        if cfg.visualize and self.iter_history:
            self._maybe_plot_iter(force=True)
        params, _, _ = self._whole()
        with torch.no_grad():
            for p, new in zip(tree_leaves(self.model.params()), tree_leaves(params)):
                p.copy_(new)
        return {"tr_loss": self.tr_loss, "cv_loss": self.cv_loss,
                "best_val_loss": self.best_val_loss, "history": self.history,
                "steps": self.steps, "graphs": self.graph_counts()}

    # ------------------------------------------------------------------
    def _to_device(self, batch):
        if self.shard_batch is not None:
            return self.shard_batch(batch.mixture, batch.lengths, batch.source)

        def dev(a):
            return torch.from_numpy(np.asarray(a)).to(self.device, non_blocking=True)

        return dev(batch.mixture), dev(batch.lengths), dev(batch.source)

    def _run_one_epoch(self, epoch: int, cross_valid: bool):
        loader = self.cv_loader if cross_valid else self.tr_loader
        total_loss = 0.0
        total_audio_sec = 0.0
        total_w = 0  # CV: utterances accumulated (weighted batch means)
        start = time.time()
        skip = 0
        if not cross_valid:
            loader.set_epoch(epoch)  # deterministic order per (seed, epoch)
            if self.resume_step and epoch == self.start_epoch:
                skip = self.resume_step
                total_loss = self.resume_loss
                total_audio_sec = self.resume_audio
                self.log(f"Resuming epoch {epoch + 1} at step {skip}")
                self.resume_step = 0
        it = loader.iter_from(skip) if skip else iter(loader)
        i = skip - 1
        last_loss = None
        wait_ns = 0
        t = time.perf_counter_ns()  # the wait for each batch starts here
        for i, batch in enumerate(it, start=skip):
            mixture, lengths, source = self._to_device(batch)
            wait_ns += time.perf_counter_ns() - t
            if cross_valid:
                loss = self.eval_step(self.params, self.state, mixture, source, lengths)
                batch_w = int(np.sum(np.asarray(batch.lengths) > 0))
                total_w += batch_w
                total_loss = total_loss + loss * batch_w
            else:
                (self.params, self.opt_state, self.state, loss, _gn) = self.train_step(
                    self.params, self.opt_state, self.state, mixture, source, lengths)
                self.steps += 1
                total_loss = total_loss + loss
            last_loss = loss
            total_audio_sec += float(np.sum(np.asarray(batch.lengths))) / self.cfg.sample_rate
            visualize = self.cfg.visualize and not cross_valid
            if visualize:  # no read-back here: drained at print_freq and epoch end
                self._pending_iter.append((epoch * len(loader) + i + 1, epoch, loss))
            if i % self.cfg.print_freq == 0:
                elapsed = time.time() - start
                denom = total_w if cross_valid else i + 1
                self.log(f"Epoch {epoch + 1} | Iter {i + 1} | "
                         f"Average Loss {float(total_loss) / max(denom, 1):.3f} | "
                         f"Current Loss {float(last_loss):.6f} | "
                         f"{1000 * elapsed / max(i + 1 - skip, 1):.1f} ms/batch")
                if visualize:
                    self._drain_iter_points()
                    self._maybe_plot_iter()
            if (not cross_valid and self.cfg.save_every_steps
                    and (i + 1) % self.cfg.save_every_steps == 0):
                path = os.path.join(self.cfg.save_folder, "latest.ckpt")
                self._save(path, epoch, extra={"step_in_epoch": i + 1,
                                               "running_loss": float(total_loss),
                                               "running_audio_sec": total_audio_sec})
            t = time.perf_counter_ns()
        n = total_w if cross_valid else i + 1
        epoch_loss = float(total_loss)  # one wait for the epoch's queued steps
        elapsed = max(time.time() - start, 1e-9)
        self.data_wait_s = wait_ns * 1e-9
        self.data_wait_share = self.data_wait_s / elapsed
        if n <= 0:
            return float("nan"), 0.0
        audio_sps = total_audio_sec / elapsed
        if self.cfg.visualize and not cross_valid:
            self._drain_iter_points()
            self._maybe_plot_iter()
        return epoch_loss / n, audio_sps

    def _drain_iter_points(self) -> None:
        """Turn the pending per-iteration device losses into floats."""
        for it, ep, dev_loss in self._pending_iter:
            self.iter_history.append({"iter": it, "epoch": ep, "loss": float(dev_loss)})
        self._pending_iter.clear()

    def _maybe_plot_iter(self, force: bool = False) -> None:
        """Re-render loss_iter.png at most every iter_plot_interval seconds
        (a figure costs ~100 ms of host time); force skips the wait."""
        now = time.time()
        if not force and now - self._last_iter_plot < self.iter_plot_interval:
            return
        self._last_iter_plot = now
        self._plot("plot_iter_curve", self.iter_history, "loss_iter.png")

    def _plot(self, fn: str, rows: List[Dict[str, Any]], name: str) -> None:
        """utils/visualize.<fn>(rows, <save_folder>/<name>) on the
        coordinator; a failure, or no plot (matplotlib missing), is logged
        and training goes on."""
        if self.mesh is not None and not is_coordinator():
            return
        try:
            from ..utils import visualize

            if getattr(visualize, fn)(rows, os.path.join(self.cfg.save_folder, name)) is None:
                self.log(f"visualize failed: {name} not written (is matplotlib installed?)")
        except Exception as e:  # plotting must never stop training
            self.log(f"visualize failed: {e}")

    def graph_counts(self) -> Optional[Dict[str, dict]]:
        """The graphed steps' counts (GraphedForward.stats): captures,
        replays, eager calls, keys seen, graphs, pool bytes; None where the
        steps run eagerly (TP, CP, a gloo group)."""
        if not isinstance(self.train_step, GraphedStep):
            return None
        return {"train_step": self.train_step.graphed.stats(),
                "cv_step": self.eval_step.graphed.stats()}

    def _whole(self):
        """(params, state, opt_state) whole: gathered over the TP group."""
        if self.mesh is None or self.mesh.tp == 1:
            return self.params, self.state, self.opt_state
        return gather_params(self.mesh, self.model.cfg.C, self.params, self.state,
                             self.opt_state)

    def _save(self, path: str, epoch: int, extra: Optional[dict] = None) -> None:
        params, state, opt_state = self._whole()  # every rank takes part
        if self.mesh is not None and not is_coordinator():
            return
        save_checkpoint(path, self.model.cfg, params, state,
                        opt_state=opt_state, epoch=epoch, tr_loss=self.tr_loss,
                        cv_loss=self.cv_loss, extra=extra)
