"""Interactive separation: one closed-loop client, one utterance a request.

The window drives the separate CLI's graphed forward (as separate_batch
does) at batch 1. A request is timed from its mixture in host memory to
its C sources in host memory: padded on the host to a multiple of
`pad_to` samples (as the CLI's --pad_to_multiple), copied to the card,
forwarded, copied into pinned host memory and waited on, the padding cut
off. Utterances are those of traffic.utterance_lengths, in an order drawn
from the seed and cycled; every padded shape is captured in set-up.
`sample` finished requests of each padded shape, drawn from the seed, are
kept for the check.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness, traffic, weights
from benchmark.reference import convtasnet as ref

BLOCK = 64  # utterances drawn per generator call in set-up


class Driver:
    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        t = ctx.traffic
        self.lengths = traffic.utterance_lengths(t)
        self.pad_to, self.n_sample = int(t["pad_to"]), int(t["sample"])
        self.order = traffic.order(ctx.seed, len(self.lengths))
        self.kept = {}   # padded length -> Reservoir of n_sample

    def setup(self):
        from convtasnet_torch.config import ConvTasNetConfig
        from convtasnet_torch.models.graphed import GraphedForward
        from convtasnet_torch.parallel.mesh import mesh_forward

        ctx, dev = self.ctx, self.ctx.device
        m = ctx.model
        top = max(self.lengths)
        self.mixtures = []
        for s in range(0, len(self.lengths), BLOCK):
            part = self.lengths[s:s + BLOCK]
            mix = traffic.mixtures(ctx.seed + s, len(part), m["C"], top, ctx.sample_rate, dev)
            self.mixtures += [row[:n].numpy().copy() for row, n in zip(mix.cpu(), part)]
        del mix
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        cfg = ConvTasNetConfig(**m, use_kernels=ctx.traffic["use_kernels"])
        params = weights.make(m, ctx.seed, dev)
        self.fwd = GraphedForward(mesh_forward(cfg, params, {}, None),
                                  tag=(cfg.kernel_form(False, dev),))
        shapes = sorted({traffic.padded(n, self.pad_to) for n in self.lengths})
        first = {}
        for k, n in enumerate(self.lengths):
            first.setdefault(traffic.padded(n, self.pad_to), k)
        for _ in range(3):  # each shape eager, captured, replayed
            for shape in shapes:
                self._request(first[shape])
        self.kept = {s: harness.Reservoir(self.n_sample, ctx.seed + s) for s in shapes}
        self.i = 0

    @torch.inference_mode()
    def _request(self, k):
        """Request k, host to host: (padded length, sources [C, n])."""
        dev = self.ctx.device
        mix = self.mixtures[k]
        n = len(mix)
        Tp = traffic.padded(n, self.pad_to)
        with torch.profiler.record_function("bench:request"):
            padded = np.zeros((1, Tp), np.float32)
            padded[0, :n] = mix
            est = self.fwd(torch.from_numpy(padded).to(dev, non_blocking=True))
            if dev.type == "cuda":
                host = torch.empty(est.shape, dtype=est.dtype, pin_memory=True)
                host.copy_(est, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
                est = host
            out = est.numpy()[0, :, :n]
        return Tp, out

    def _next(self):
        k = self.order[self.i % len(self.order)]
        self.i += 1
        return k, self._request(k)

    def window(self, seconds):
        lat, failed = [], 0
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            t = time.perf_counter()
            if t >= end:
                break
            k, (Tp, out) = self._next()
            lat.append(time.perf_counter() - t)
            failed += int(not np.isfinite(out).all())
            self.kept[Tp].offer(lambda: (k, out))
        return {"attempted": len(lat), "failed": failed,
                "metrics": {"separate_p95_ms": float(np.percentile(lat, 95)) * 1e3}}

    def unit(self):
        k, (Tp, _) = self._next()
        return {"M": 1, "T": Tp, "passes": 1}

    def release(self):
        self.fwd = None

    def _sample(self):
        return [item for _, r in sorted(self.kept.items()) for item in r.items]

    def outputs(self):
        return [out for _, out in self._sample()]

    @torch.no_grad()
    def reference(self, q):
        m, dev = self.ctx.model, self.ctx.device
        params = weights.make(m, self.ctx.seed, dev)
        model = ref.Model(**m)
        outs = []
        for k, _ in self._sample():
            mix = self.mixtures[k]
            padded = np.zeros((1, traffic.padded(len(mix), self.pad_to)), np.float32)
            padded[0, :len(mix)] = mix
            est = ref.forward(params, model, torch.from_numpy(padded).to(dev), q)
            outs.append(est[0, :, :len(mix)].cpu().numpy())
        return outs

    def compare(self, out, refd):
        return {"wave_err": max(map(ref.wave_error, out, refd))}
