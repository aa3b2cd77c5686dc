"""One run of one cell: set-up, the measured window, the traced segment, the
check against the reference, and the result line.

A driver (drivers/<name>.py, named by the traffic file) plays one kind of
traffic through the port. It is a class `Driver(ctx)` with:

  setup()            build the program, make the traffic, warm and capture
                     every shape the traffic uses;
  window(seconds)    play the traffic for `seconds`; returns {"attempted",
                     "failed", "metrics": {end-to-end name: value}};
  unit()             one more unit of the same traffic (a step, a batch, a
                     request, a chunk) for the traced segment; returns its
                     shape {"M", "T", "passes", ...} for the readers;
  release()          drop the program and its state;
  outputs()          what the window's timed path produced, for the check;
  reference(q)       the same outputs from benchmark/reference, activations
                     rounded by q;
  compare(out, ref)  {check name: number}, each held to limits/<cell>.json.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import spec
from .reference.convtasnet import FP8, rounding

# Top-level module names a run may not hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "convtasnet_tpu")


class Context(NamedTuple):
    cell: spec.Cell
    model: Dict          # ConvTasNetConfig keywords
    traffic: Dict
    seed: int
    device: torch.device
    sample_rate: int


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Reservoir:
    """A uniform sample of k of the items offered, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen = k, [], 0
        self.rng = np.random.default_rng([seed, 2])

    def offer(self, make):
        """Keep make() (called only when kept) with reservoir probability."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = make()


def port_counts() -> Dict[str, int]:
    """The port's launch counters of its hand-written kernels."""
    from convtasnet_torch.ops.kernels import tcn_block, tcn_block_bwd

    return {**tcn_block.counts(), **tcn_block_bwd.counts()}


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def make_driver(cell: spec.Cell, seed: int, device, overrides: Optional[Dict] = None):
    """The cell's driver, with the configuration's and the traffic's keys
    replaced by `overrides` {"model": {...}, "traffic": {...}} (tests; a
    "limits" key there replaces limits in run)."""
    overrides = overrides or {}
    model = {**spec.model_kwargs(cell.config), **overrides.get("model", {})}
    traffic = {**cell.traffic, **overrides.get("traffic", {})}
    mod = spec.load_module("drivers", traffic["driver"], cell.root)
    ctx = Context(cell, model, traffic, int(seed), torch.device(device),
                  int(cell.config["sample_rate"]))
    return mod.Driver(ctx)


def check(drv, limits: Dict[str, float], control: bool = False):
    """(correct, {name: {"value", "limit"}}): the window's outputs (with
    `control`, the reference one precision below the configuration's in
    their place) against the reference, each number against its limit.
    The reference's float32 matmuls and convolutions run without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = drv.reference(rounding(torch.bfloat16))
    out = drv.reference(rounding(FP8)) if control else drv.outputs()
    numbers = drv.compare(out, ref)
    rows = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = bool(rows) and all(math.isfinite(r["value"]) and r["value"] <= r["limit"]
                            for r in rows.values())
    return ok, rows


def run(cell_name: str, seed: int, seconds: float, trace: bool, device="cuda",
        root: str = spec.ROOT, overrides: Optional[Dict] = None,
        started: Optional[float] = None) -> Dict:
    """The result of one run (the keys of the result line)."""
    started = time.perf_counter() if started is None else started
    cell = spec.cell(cell_name, root)
    dev = torch.device(device)
    drv = make_driver(cell, seed, dev, overrides)
    drv.setup()
    sync(dev)
    setup_s = time.perf_counter() - started
    log(f"set-up {setup_s:.3f} s")

    win = drv.window(seconds)
    metrics = {}
    traced = None
    if trace:
        from . import tracing

        traced = tracing.traced(drv, int(drv.ctx.traffic["trace_units"]), dev)
        for m in cell.per_layer:
            reader = spec.load_module("metrics", m["name"], root)
            value = None if reader is None else reader.read(m["name"], traced, drv.ctx)
            if value is None:
                log(f"per-layer metric {m['name']}: nothing to read")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, **win["metrics"]}
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    drv.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ok, checks = check(drv, {**cell.limits, **(overrides or {}).get("limits", {})})
    device_row = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                  "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": ok, "attempted": int(win["attempted"]), "failed": int(win["failed"]),
              "metrics": metrics, "device": device_row}
    if traced is not None:
        device_row.update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = traced.breakdown()
    result["checks"] = checks
    return result
