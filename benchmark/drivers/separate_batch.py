"""Offline separation: batches of one padded shape through the separate
CLI's graphed forward and one-deep pipeline.

The window drives GraphedForward(mesh_forward(cfg, params, state, None),
tag=(cfg.kernel_form(False, device),)), as cli/separate._separate builds
it, with the traffic's `use_kernels`. Each batch is copied from host memory
to the card, its forward enqueued, and its estimates copied into pinned
host memory behind an event; the next batch is enqueued before this one's
event is waited on (the CLI's `batches_with_async_infer`). A batch counts
when its sources are in host memory. The pool holds `pool` host batches of
`batch` x `segment_s` mixtures; `sample` batches that the window finished,
drawn from the seed, are kept for the check.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness, traffic, weights
from benchmark.reference import convtasnet as ref


class Driver:
    uniform_units = True  # every traced unit launches the same work

    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        t = ctx.traffic
        self.batch, self.T = int(t["batch"]), int(round(t["segment_s"] * ctx.sample_rate))
        self.n_pool = int(t["pool"])
        self.kept = harness.Reservoir(int(t["sample"]), ctx.seed)

    def setup(self):
        from convtasnet_torch.config import ConvTasNetConfig
        from convtasnet_torch.models.graphed import GraphedForward
        from convtasnet_torch.parallel.mesh import mesh_forward

        ctx, dev = self.ctx, self.ctx.device
        m = ctx.model
        mix = traffic.mixtures(ctx.seed, self.n_pool * self.batch, m["C"], self.T,
                               ctx.sample_rate, dev)
        self.pool = [b.numpy() for b in mix.reshape(self.n_pool, self.batch, self.T).cpu()]
        del mix
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        cfg = ConvTasNetConfig(**m, use_kernels=ctx.traffic["use_kernels"])
        params = weights.make(m, ctx.seed, dev)
        self.fwd = GraphedForward(mesh_forward(cfg, params, {}, None),
                                  tag=(cfg.kernel_form(False, dev),))
        self.i, self.pending = 0, None
        for _ in range(3):  # eager, captured, replayed
            self._ready(self._infer())

    @torch.inference_mode()
    def _infer(self):
        """Enqueue the next batch (cli/separate.infer): (index, host, event)."""
        b = self.i % self.n_pool
        self.i += 1
        dev = self.ctx.device
        with torch.profiler.record_function("bench:enqueue"):
            est = self.fwd(torch.from_numpy(self.pool[b]).to(dev, non_blocking=True))
            if dev.type != "cuda":
                return b, est, None
            host = torch.empty(est.shape, dtype=est.dtype, pin_memory=True)
            host.copy_(est, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return b, host, done

    @staticmethod
    def _ready(pending):
        b, host, done = pending
        with torch.profiler.record_function("bench:wait"):
            if done is not None:
                done.synchronize()
        return b, host.numpy()

    def _take(self, pending):
        b, est = self._ready(pending)
        self.kept.offer(lambda: (b, est))
        return int(not np.isfinite(est).all())

    def window(self, seconds):
        done = failed = 0
        t0 = time.perf_counter()
        end = t0 + seconds
        pending = None
        while time.perf_counter() < end:
            nxt = self._infer()
            if pending is not None:
                failed += self._take(pending)
                done += 1
            pending = nxt
        if pending is not None:
            failed += self._take(pending)
            done += 1
        window = time.perf_counter() - t0
        audio = done * self.batch * self.T / self.ctx.sample_rate
        return {"attempted": done * self.batch, "failed": failed * self.batch,
                "metrics": {"separate_audio_s_per_s": audio / window}}

    def unit(self):
        """The window's pipeline, one batch on: enqueue the next batch, then
        wait for the one before it."""
        nxt = self._infer()
        if self.pending is not None:
            self._ready(self.pending)
        self.pending = nxt
        return {"M": self.batch, "T": self.T, "passes": 1}

    def release(self):
        if self.pending is not None:
            self._ready(self.pending)
        self.fwd = self.pending = None

    def outputs(self):
        return [est for _, est in sorted(self.kept.items, key=lambda x: x[0])]

    @torch.no_grad()
    def reference(self, q):
        m, dev = self.ctx.model, self.ctx.device
        params = weights.make(m, self.ctx.seed, dev)
        model = ref.Model(**m)
        return [ref.forward(params, model, torch.from_numpy(self.pool[b]).to(dev), q).cpu().numpy()
                for b, _ in sorted(self.kept.items, key=lambda x: x[0])]

    def compare(self, out, refd):
        return {"wave_err": max(map(ref.wave_error, out, refd))}
