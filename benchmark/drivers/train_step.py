"""Training: the port's graphed train step on batches cycled from a pool.

The window drives training/solver.GraphedStep around make_train_step (Adam,
clipping of the global norm), with the traffic's `use_kernels` (`hybrid`:
the whole-TCN training op, hand-written forward and backward kernels). The
pool holds `pool` batches of `batch` x `segment_s` segments on the device,
all rows different; step i takes batch i mod pool. At most `inflight`
steps are queued ahead of the device, as a training loop that reads its
loss now and then keeps them.

Set-up builds the one step object and runs its first `check_steps` steps
through the window's own call on batches 0, 1, 2, ...: the first eager,
the second a warm-up and a capture, the third the first replay of the
graph the window replays. It keeps each step's loss, each step's gradient
as the optimizer got it (from Adam's first moments before and after the
step: g_t = (mu_t - b1 mu_(t-1)) / (1 - b1)) and the parameters after each
step. The window goes on with the same object.

The check (compare) holds the program to the reference:
  * the last step, the first replay of the graph the window replays,
    against the reference's loss and gradient at the program's own
    parameters before that step, on the same batch: `loss_gap`, the gap
    of the loss (dB); `grad_gap`, the worst leaf's gap of the gradient's
    norm; `row_med`, the median row's gap of its share of the gradient
    (each row's least-squares weight over the reference's rows' own
    gradients, 1 for an even mean; a row left out reads 0);
  * the whole: `change_gap`, the worst leaf's gap of the norm of the
    parameters' change after `check_steps` steps, against the reference's
    own steps from the seed.
The first step is logged, not compared (PERF.md §2): at random weights
every row's estimate is all but orthogonal to its sources (SI-SNR -20 to
-39 dB), and rounding alone swings the first loss and gradient; from the
seed the two trajectories part within two steps, so the replayed step can
only be followed from the program's own state.
"""

from __future__ import annotations

import collections
import math
import time

import torch

from benchmark import harness, traffic, weights
from benchmark.reference import convtasnet as ref


class Driver:
    uniform_units = True  # every traced unit launches the same work

    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        t = ctx.traffic
        self.batch, self.T = int(t["batch"]), int(round(t["segment_s"] * ctx.sample_rate))
        self.n_pool, self.inflight = int(t["pool"]), int(t["inflight"])
        self.lr, self.max_norm = float(t["lr"]), float(t["max_norm"])
        self.check_steps = int(t["check_steps"])
        self.b1 = 0.9

    def setup(self):
        from convtasnet_torch.config import ConvTasNetConfig
        from convtasnet_torch.training.optim import Optimizer
        from convtasnet_torch.training.solver import GraphedStep, make_train_step

        ctx, dev = self.ctx, self.ctx.device
        m = ctx.model
        src = traffic.sources(ctx.seed, self.n_pool * self.batch, m["C"], self.T,
                              ctx.sample_rate, dev)
        self.src = src.reshape(self.n_pool, self.batch, m["C"], self.T)
        self.mix = self.src.sum(2)
        self.lengths = torch.full((self.batch,), self.T, dtype=torch.int32, device=dev)
        cfg = ConvTasNetConfig(**m, use_kernels=ctx.traffic["use_kernels"])
        params = weights.make(m, ctx.seed, dev)
        opt = Optimizer("adam", lr=self.lr, b1=self.b1)
        self.step = GraphedStep(make_train_step(cfg, opt, self.max_norm), params,
                                opt.init(params), {}, tag=(cfg.kernel_form(True, dev),))
        self.i = 0
        losses, self.grads, self.params_after = [], [], []
        mu = {p: torch.zeros_like(t) for p, t in ref.leaves(self.step.opt_state.mu)}
        for _ in range(self.check_steps):
            losses.append(self._call().clone())
            now = {p: t.clone() for p, t in ref.leaves(self.step.opt_state.mu)}
            self.grads.append({p: (now[p] - self.b1 * mu[p]) / (1 - self.b1) for p in now})
            self.params_after.append({p: t.clone() for p, t in ref.leaves(self.step.params)})
            mu = now
        self.losses = [float(x) for x in losses]

    def _call(self):
        b = self.i % self.n_pool
        self.i += 1
        s = self.step
        _, _, _, loss, _ = s(s.params, s.opt_state, s.state, self.mix[b], self.src[b],
                             self.lengths)
        return loss

    def window(self, seconds):
        dev = self.ctx.device
        cuda = dev.type == "cuda"
        queued = collections.deque()
        losses = []
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end:
            losses.append(self._call())
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                queued.append(ev)
                if len(queued) > self.inflight:
                    queued.popleft().synchronize()
        harness.sync(dev)
        window = time.perf_counter() - t0
        steps = len(losses)
        failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
        audio = steps * self.batch * self.T / self.ctx.sample_rate
        return {"attempted": steps, "failed": failed,
                "metrics": {"train_audio_s_per_s": audio / window}}

    def unit(self):
        with torch.profiler.record_function("bench:step"):
            self._call()
        return {"M": self.batch, "T": self.T, "passes": 3}

    def release(self):
        self.step = None

    def outputs(self):
        return self.losses, self.grads, self.params_after

    def _batch(self, b):
        return self.mix[b], self.src[b], self.lengths

    def reference(self, q):
        m = self.ctx.model
        batches = [self._batch(b) for b in range(self.check_steps)]
        params = weights.make(m, self.ctx.seed, self.ctx.device)
        return ref.train(params, ref.Model(**m), batches, q, self.check_steps, self.lr,
                         self.max_norm, b1=self.b1)

    def compare(self, out, refd):
        losses, grads, after = out
        r_losses, r_grads, r_after = refd
        dev = r_after[0][next(iter(r_after[0]))].device
        p0 = dict(ref.leaves(weights.make(self.ctx.model, self.ctx.seed, dev)))
        gnorm = {n: float(t.double().norm()) for n, t in r_grads[0].items()}
        med = sorted(gnorm.values())[len(gnorm) // 2]
        # leaves whose reference gradient is nought to rounding move by
        # round-off alone under Adam: left out of the change
        still = {n for n, g in gnorm.items() if g < 1e-3 * med}
        if still:
            harness.log(f"left out of change_gap (reference gradient < 1e-3 of the median "
                        f"leaf's): {sorted(still)}")
        d_prog = {n: after[-1][n].to(dev) - p0[n] for n in p0}
        d_ref = {n: r_after[-1][n] - p0[n] for n in p0}
        change = ref.norm_gaps(d_prog, d_ref, skip=still)
        first = ref.worst(ref.norm_gaps({n: v.to(dev) for n, v in grads[0].items()}, r_grads[0]))
        # the replayed step, against the reference at the program's own
        # parameters before it (the configuration's bf16 activations)
        t = self.check_steps
        start = {n: v.to(dev) for n, v in after[t - 2].items()}
        names = [n for n, _ in ref.leaves(start)]
        r_loss, r_g, rows = ref.row_grads(start, ref.Model(**self.ctx.model),
                                          self._batch(t - 1), ref.rounding(torch.bfloat16))
        r_g = dict(zip(names, (g.detach() for g in ref.clip(r_g, self.max_norm))))
        g = {n: v.to(dev) for n, v in grads[t - 1].items()}
        gaps = ref.norm_gaps(g, r_g)
        shares = ref.row_shares(g, rows)
        row_med = float((shares - 1).abs().median())
        harness.log(f"not compared: first step's worst grad gap {first[0]} ({first[1]}), loss "
                    f"gap by step from the seed {[abs(a - b) for a, b in zip(losses, r_losses)]}")
        harness.log(f"step {t}: worst grad leaf {ref.worst(gaps)[1]}, worst change leaf "
                    f"{ref.worst(change)[1]}; row shares {[round(float(x), 4) for x in shares]}; "
                    f"the reference's row losses {[round(x, 3) for x in r_loss]}")
        return {"loss_gap": abs(losses[t - 1] - sum(r_loss) / len(r_loss)),
                "grad_gap": ref.worst(gaps)[0],
                "row_med": row_med if math.isfinite(row_med) else math.inf,
                "change_gap": ref.worst(change)[0]}
