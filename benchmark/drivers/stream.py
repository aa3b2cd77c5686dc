"""Live streaming: one stream of fixed-size chunks through the port's
StreamingSeparator, closed loop.

The window drives StreamingSeparator(cfg, params, batch=1).push on the
graphed first and steady chunk steps: each `chunk`-sample chunk is handed
to push from host memory and its separated samples fetched to the host
before the next is pushed; a chunk is timed from the hand-off to its
samples on the host. An utterance ends with flush() and reset().
Utterances are those of traffic.utterance_lengths (multiples of the chunk),
in an order drawn from the seed and cycled. `sample` whole utterances that the window finished, drawn from the
seed, are kept for the check against the reference's offline causal
forward.
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
        self.chunk = int(t["chunk"])
        self.lengths = traffic.utterance_lengths(t)
        if any(n % self.chunk for n in self.lengths):
            raise ValueError("utterance lengths must be multiples of the chunk")
        self.order = traffic.order(ctx.seed, len(self.lengths))
        self.kept = harness.Reservoir(int(t["sample"]), ctx.seed)

    def setup(self):
        from convtasnet_torch.config import ConvTasNetConfig
        from convtasnet_torch.models.streaming import StreamingSeparator

        ctx, dev = self.ctx, self.ctx.device
        m = ctx.model
        mix = traffic.mixtures(ctx.seed, len(self.lengths), m["C"], max(self.lengths),
                               ctx.sample_rate, dev).cpu()
        self.utts = [mix[k:k + 1, :n].clone() for k, n in enumerate(self.lengths)]
        del mix
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        cfg = ConvTasNetConfig(**m)
        self.sep = StreamingSeparator(cfg, weights.make(m, ctx.seed, dev), batch=1, device=dev)
        u = self.utts[0]
        for _ in range(2):  # first and steady steps, captured then replayed
            for s in range(0, 4 * self.chunk, self.chunk):
                self.sep.push(u[:, s:s + self.chunk]).cpu()
            self.sep.reset()
        self.i, self.pos, self.outs = 0, 0, []

    def _chunk(self):
        """Push the next chunk and fetch its samples; (utterance, its whole
        output) when the chunk ended it (flushed and reset), else None."""
        k = self.order[self.i % len(self.order)]
        u = self.utts[k]
        with torch.profiler.record_function("bench:chunk"):
            self.outs.append(self.sep.push(u[:, self.pos:self.pos + self.chunk]).cpu())
        self.pos += self.chunk
        if self.pos < u.shape[1]:
            return None
        with torch.profiler.record_function("bench:flush"):
            self.outs.append(self.sep.flush().cpu())
            self.sep.reset()
        whole = torch.cat(self.outs, dim=-1)
        self.i, self.pos, self.outs = self.i + 1, 0, []
        return k, whole

    def window(self, seconds):
        lat, failed = [], 0
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            t = time.perf_counter()
            if t >= end:
                break
            done = self._chunk()
            lat.append(time.perf_counter() - t)
            failed += int(not torch.isfinite(self.outs[-1] if done is None else done[1]).all())
            if done is not None:
                self.kept.offer(lambda: done)
        p95 = float(np.percentile(lat, 95)) * 1e3
        # the utterance in flight is due too: finished untimed, and offered
        done = None
        while self.pos and done is None:
            done = self._chunk()
        if done is not None:
            self.kept.offer(lambda: done)
        return {"attempted": len(lat), "failed": failed,
                "metrics": {"stream_chunk_p95_ms": p95}}

    def prepare_trace(self, n):
        """Put n steady chunks of one utterance ahead: no first chunk and no
        flush among the traced units."""
        left = (self.utts[self.order[self.i % len(self.order)]].shape[1] - self.pos) // self.chunk
        if left <= n:
            while self._chunk() is None:
                pass
        if self.pos == 0:
            self._chunk()

    def unit(self):
        self._chunk()
        return {"M": 1, "T": self.chunk, "passes": 1}

    def release(self):
        self.sep = None

    def outputs(self):
        return [out[0].numpy() for _, out in sorted(self.kept.items, key=lambda x: x[0])]

    @torch.no_grad()
    def reference(self, q):
        m, dev = self.ctx.model, self.ctx.device
        params = weights.make(m, self.ctx.seed, dev)
        model = ref.Model(**m)
        return [ref.forward(params, model, self.utts[k].to(dev), q)[0].cpu().numpy()
                for k, _ in sorted(self.kept.items, key=lambda x: x[0])]

    def compare(self, out, refd):
        return {"wave_err": max(map(ref.wave_error, out, refd))}
