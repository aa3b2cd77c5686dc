"""Training a configuration of the paper's final version (a skip path):
the train_step driver's traffic, window and check on such a model.

The model keys that benchmark.spec passes on are the first version's; the
final version's (`FINAL_KEYS`: the skip channels Sc, encoder_relu,
input_norm) are read from the configuration file (or a test's overrides of
the model). The weights are weights.make's shared leaves, plus the skip
path's from a second generator of the seed: blocks/skip_w xavier-normal on
its torch shape (Sc, H, 1), mask/prelu 0.25, and mask/w [Sc, C*N] drawn
there too when Sc != B (weights.make draws it [B, C*N]). The reference is
benchmark/reference/convtasnet_skip.py; the set-up, the reference's steps
and the check (loss_gap, grad_gap, row_med, change_gap) are train_step's
own methods, run with that module's weights and reference swapped for
these (`_final_version`).
"""

from __future__ import annotations

import contextlib
import math
import types
from unittest import mock

import torch

from benchmark import harness, weights
from benchmark.drivers import train_step
from benchmark.reference import convtasnet_skip as ref

FINAL_KEYS = ("Sc", "encoder_relu", "input_norm")
SEED2 = 1 << 32  # the second generator's seed is the run's seed plus this


def make_weights(m, seed: int, device):
    """The parameter tree of model keys `m` (with FINAL_KEYS) for `seed`."""
    dev = torch.device(device)
    tree = weights.make(m, seed, dev)
    H, R, X, C, N, Sc = (m[k] for k in ("H", "R", "X", "C", "N", "Sc"))
    gen = torch.Generator(device=dev).manual_seed(seed + SEED2)
    std = math.sqrt(2.0 / (H + Sc))  # xavier-normal, torch shape (Sc, H, 1)
    skip = torch.randn((R, X, H, Sc), generator=gen, device=dev) * std
    tree["separator"]["blocks"]["skip_w"] = skip
    mask = tree["separator"]["mask"]
    if Sc != m["B"]:
        mask["w"] = (torch.randn((Sc, C * N), generator=gen, device=dev)
                     * math.sqrt(2.0 / (Sc + C * N)))
    mask["prelu"] = torch.full((), 0.25, device=dev)
    return tree


@contextlib.contextmanager
def _final_version():
    """train_step's module-level weights and reference, which its Driver's
    methods read, as the final version's for the duration."""
    with mock.patch.object(train_step, "weights", types.SimpleNamespace(make=make_weights)), \
            mock.patch.object(train_step, "ref", ref):
        yield


class Driver(train_step.Driver):
    def __init__(self, ctx: harness.Context):
        final = {k: ctx.model.get(k, ctx.cell.config[k]) for k in FINAL_KEYS}
        super().__init__(ctx._replace(model={**ctx.model, **final}))

    def setup(self):
        with _final_version():
            super().setup()

    def reference(self, q):
        with _final_version():
            return super().reference(q)

    def compare(self, out, refd):
        with _final_version():
            return super().compare(out, refd)
