"""Structured metric logs, profiler traces and step timing (counterpart of
convtasnet_tpu/utils/observability.py).

* MetricLogger appends one JSON line per event to <dir>/history.jsonl and
  mirrors human-readable lines to stdout and <dir>/train.log (the
  reference's print-to-train.log, solver.py:190-195).
* profile_trace records a block with torch.profiler (host activity, and
  the card's where CUDA is present) and writes a Chrome trace,
  <dir>/trace.json (open in chrome://tracing or Perfetto).
* StepTimer keeps per-step wall times with warm-up-aware averages.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Optional

import torch


class MetricLogger:
    """JSONL metrics + tee'd text logging."""

    def __init__(self, log_dir: Optional[str] = None, filename: str = "train.log"):
        self.log_dir = log_dir
        self._jsonl = None
        self._text = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "history.jsonl"), "a")
            self._text = open(os.path.join(log_dir, filename), "a")

    def log(self, msg: str) -> None:
        print(msg, flush=True)
        if self._text:
            self._text.write(msg + "\n")
            self._text.flush()

    def metrics(self, **kv: Any) -> None:
        kv.setdefault("time", time.time())
        if self._jsonl:
            self._jsonl.write(json.dumps(kv) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        for f in (self._jsonl, self._text):
            if f:
                f.close()


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """torch.profiler over the block; yields the profiler (None when not
    enabled) and writes <log_dir>/trace.json when the block ends, also on
    an error."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Lightweight step timing with warmup-aware averages."""

    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self.times = []
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    @property
    def mean_ms(self) -> float:
        xs = self.times[self.skip_first:] or self.times
        return 1000 * sum(xs) / max(len(xs), 1)
