"""The traced segment of a `--trace 1` run: torch.profiler over a fixed
number of the traffic's units, its records counted before anything is read.

A torch.profiler session can lose records, most at its start and more the
older the process (convtasnet_torch/tools/_bench.py, whose check is copied
here). So each session launches filler kernels (torch.cuda._sleep) before
and after the units, which take what is lost at the edges and are left out,
and the session is accepted only if
  * it holds device records;
  * its records of the port's kernels (the `tcn::` namespace of csrc/)
    equal the launches the port's counters saw in it;
  * where the driver's units are alike (`uniform_units`), every name holds
    exactly n times the records of a one-unit session.
Otherwise it is taken again with more fillers; after the last try the run
fails rather than read a blind profile as low device time.

The window is the `bench:window` range around the units and the final
synchronise. Busy is the union of the device records' intervals in it.

Under the profiler every launch costs the host and the device more, so a
cell of many small launches or of much host work per unit runs slower
traced than untraced. Just before the traced sessions the same number of
units therefore runs without the profiler, between two CUDA events (the
host clock on the CPU): `untraced_s`, the time of those n units
(`untraced_units`) as the window runs them, which the readers of the whole
step's pace use.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

import torch

from benchmark import harness

PORT_KERNEL = "tcn::"     # the namespace of every kernel in convtasnet_torch/csrc
FILLER = "spin_kernel"    # torch.cuda._sleep's kernel
FILLS = (64, 512, 4096)   # filler launches on each side, by try
WINDOW = "bench:window"

Records = Dict[str, Tuple[int, float]]   # name -> (records, device seconds)


class Trace:
    """What the readers of metrics/ get from the traced segment."""

    def __init__(self, units, records: Records, intervals, window: Tuple[int, int],
                 spans: List[Tuple[int, int, str]], untraced):
        self.untraced_s, self.untraced_units = untraced  # n units without the profiler
        self.units = units                # [{"M", "T", "passes", "launches": {...}}]
        self.records = records
        self.window_s = (window[1] - window[0]) * 1e-9
        self.busy_s, self._gaps = _union(intervals, window)
        self._spans = spans

    @property
    def port_s(self) -> float:
        return sum(s for k, (_, s) in self.records.items() if PORT_KERNEL in k)

    @property
    def glue_s(self) -> float:
        return sum(s for k, (_, s) in self.records.items() if PORT_KERNEL not in k)

    def idle_share(self, untraced: bool) -> Optional[float]:
        """1 - busy / window in percent, over the traced window or (untraced)
        over the untraced units' time, busy taken per unit from the trace."""
        if self.busy_s <= 0 or not self.units:
            return None
        if not untraced:
            return 100.0 * (1.0 - self.busy_s / self.window_s) if self.window_s > 0 else None
        if self.untraced_s <= 0:
            return None
        busy = self.busy_s / len(self.units) * len(self.untraced_units)
        return 100.0 * (1.0 - busy / self.untraced_s)

    @property
    def n_records(self) -> int:
        return sum(n for n, _ in self.records.values())

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.records.items(), key=lambda kv: -kv[1][1])[:10]
        by_host: Dict[str, float] = {}
        starts = [s for s, _, _ in self._spans]
        for g0, g1 in self._gaps:
            best, name = 0, "host outside the harness's spans"
            i = bisect.bisect_right(starts, g1)
            for s, e, n in self._spans[max(0, i - 64):i]:
                ov = min(e, g1) - max(s, g0)
                if ov > best:
                    best, name = ov, n
            by_host[name] = by_host.get(name, 0.0) + (g1 - g0) * 1e-9
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:160], s] for k, (_, s) in ops],
                "idle_gaps": [[k, s] for k, s in gaps]}


def _union(intervals, window):
    """(busy seconds inside window, idle gaps [(start, end)] in ns)."""
    w0, w1 = window
    busy, gaps, at = 0, [], w0
    for s, e in sorted(intervals):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
        if e > at:
            busy += e - max(s, at)
            at = e
    if w1 > at:
        gaps.append((at, w1))
    return busy * 1e-9, gaps


def _fill(n: int, dev) -> None:
    if dev.type == "cuda":
        for _ in range(n):
            torch.cuda._sleep(1)
    harness.sync(dev)


def _untraced(drv, n: int, dev):
    """(seconds, units) of n units without the profiler, the seconds from
    the device's clock."""
    harness.sync(dev)
    units = []
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            units.append(drv.unit())
        return time.perf_counter() - t0, units
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        units.append(drv.unit())
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3, units


def _session(drv, n: int, fill: int, dev):
    """One profiler session over n units: (units, records, intervals,
    window, spans)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    units = []
    with torch.profiler.profile(activities=acts) as prof:
        _fill(fill, dev)
        with torch.profiler.record_function(WINDOW):
            for _ in range(n):
                before = harness.port_counts()
                u = drv.unit()
                after = harness.port_counts()
                u["launches"] = {k: v - before[k] for k, v in after.items() if v != before[k]}
                units.append(u)
            harness.sync(dev)
        _fill(fill, dev)
    window, spans, device = None, [], []
    on_cpu = dev.type == "cpu"  # the CPU tests: its aten ops stand for device records
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.is_user_annotation() and name.startswith("bench:"):
                if name == WINDOW:
                    window = (e.start_ns(), e.end_ns())
                else:
                    spans.append((e.start_ns(), e.end_ns(), name))
            elif on_cpu and name.startswith("aten::"):
                device.append((e.start_ns(), e.end_ns(), name))
        elif not e.is_user_annotation() and FILLER not in name:
            device.append((e.start_ns(), e.end_ns(), name))
    if window is None:
        raise RuntimeError("the profile holds no bench:window range")
    records: Records = {}
    intervals = []
    for s, e, name in device:
        if window[0] <= s < window[1]:
            c, t = records.get(name, (0, 0.0))
            records[name] = (c + 1, t + (e - s) * 1e-9)
            intervals.append((s, e))
    spans.sort()
    return units, records, intervals, window, spans


def verdict(units, records: Records, one: Optional[Records], n: int) -> str:
    """Why a session is not complete, or ""."""
    if not records:
        return "the session holds no device record"
    launched = sum(sum(u["launches"].values()) for u in units)
    port = sum(c for k, (c, _) in records.items() if PORT_KERNEL in k)
    if port != launched:
        return f"{port} records of the port's kernels, {launched} launches counted"
    if one is not None:
        off = [(records.get(k, (0, 0))[0] - n * one.get(k, (0, 0))[0], k)
               for k in set(one) | set(records)]
        off = sorted((d for d in off if d[0]), key=lambda d: -abs(d[0]))
        if off:
            return ("records are not n times a one-unit session's: "
                    + ", ".join(f"{d:+d} {k[:60]}" for d, k in off[:3]))
    return ""


def traced(drv, n: int, dev) -> Trace:
    from convtasnet_torch.models.graphed import keep_cupti

    keep_cupti()
    uniform = getattr(drv, "uniform_units", False)
    if hasattr(drv, "prepare_trace"):
        drv.prepare_trace(n + 1)
    untraced = _untraced(drv, n, dev)
    why = []
    for fill in FILLS:
        if hasattr(drv, "prepare_trace"):
            drv.prepare_trace(n + 1)
        one = _session(drv, 1, fill, dev)[1] if uniform else None
        units, records, intervals, window, spans = _session(drv, n, fill, dev)
        short = verdict(units, records, one, n)
        if not short:
            return Trace(units, records, intervals, window, spans, untraced)
        why.append(f"{short} ({fill} fillers)")
        harness.log(f"profile incomplete: {why[-1]}")
    raise RuntimeError("torch.profiler fell short in every try: " + "; ".join(why))
