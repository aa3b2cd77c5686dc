"""Structured metric logs, the port's spans and profiler traces
(counterpart of convtasnet_tpu/utils/observability.py).

* MetricLogger appends one JSON line per event to <dir>/history.jsonl and
  mirrors human-readable lines to stdout and <dir>/train.log (the
  reference's print-to-train.log, solver.py:190-195).
* span(name, **attrs) marks a stretch of the port's host work. While a
  torch.profiler session is active it appends a Span (name, start_ns,
  end_ns, span_id, parent_id, unit_id, attrs) to a bounded ring, read by
  spans() and emptied by clear(). Times come from time.time_ns(), the
  clock of the profiler's own host and device records; parent_id is the
  innermost span open on this thread, unit_id the outermost one's id,
  shared by every span of one request, chunk or step. With no session a
  span costs one attribute read and is a shared no-op: no clock read, no
  record, no record_function.
* profile_trace records a block with torch.profiler (host activity, and
  the card's where CUDA is present) and writes a Chrome trace,
  <dir>/trace.json (open in chrome://tracing or Perfetto), with the
  block's spans as a `convtasnet_torch` track above the host and device
  rows.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler


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


# Spans kept: a traced benchmark unit holds about five, a profiled train
# step a few; the oldest go first.
RING = 65536
TRACK = "convtasnet_torch"   # the Chrome trace's process row of the spans


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]   # None: the outermost span of its unit
    unit_id: int
    attrs: Dict[str, Any]


_RING: "collections.deque[Span]" = collections.deque(maxlen=RING)
_OPEN = threading.local()    # .stack: this thread's open spans, innermost last
_IDS = itertools.count(1)


class _Off:
    """The span of a process that no profiler session watches."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, key: str, value: Any) -> None:
        pass


_OFF = _Off()


class _On:
    """A span that records itself into the ring when it closes."""

    __slots__ = ("name", "attrs", "start", "id", "parent", "unit", "stack")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.id = next(_IDS)
        if stack:
            self.parent, self.unit = stack[-1].id, stack[-1].unit
        else:
            self.parent, self.unit = None, self.id
        stack.append(self)
        self.stack = stack
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        self.stack.pop()
        _RING.append(Span(self.name, self.start, end, self.id, self.parent, self.unit,
                          self.attrs))
        return False

    def set(self, key: str, value: Any) -> None:
        """An attribute known only once the span is open."""
        self.attrs[key] = value


def span(name: str, **attrs: Any):
    """A context manager over a stretch of the port's host work, recorded
    while a torch.profiler session is active (module docstring)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, attrs)


def spans() -> List[Span]:
    """The ring's spans, in the order they closed."""
    return list(_RING)


def clear() -> None:
    _RING.clear()


def _add_spans_to_trace(path: str, recorded: List[Span]) -> None:
    """Append `recorded` to the Chrome trace at `path` as complete events of
    a TRACK process, on the trace's own timebase (its events' "ts" are
    microseconds since its baseTimeNanoseconds, 0 where it names none)."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": TRACK, "tid": 0,
                   "args": {"name": TRACK}})
    for s in recorded:
        events.append({"ph": "X", "cat": TRACK, "name": s.name, "pid": TRACK, "tid": 0,
                       "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {**{k: str(v) for k, v in s.attrs.items()},
                                "span_id": s.span_id, "parent_id": s.parent_id,
                                "unit_id": s.unit_id}})
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """torch.profiler over the block; yields the profiler (None when not
    enabled) and writes <log_dir>/trace.json, with the spans the block
    recorded on the TRACK row, when the block ends, also on an error."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    since = time.time_ns()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        _add_spans_to_trace(path, [s for s in _RING if s.start_ns >= since])
