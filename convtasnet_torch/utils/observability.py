"""Structured metric logs (the MetricLogger of
convtasnet_tpu/utils/observability.py:24-52).

MetricLogger appends one JSON line per event to <dir>/history.jsonl and
mirrors human-readable lines to stdout and <dir>/train.log (the
reference's print-to-train.log, solver.py:190-195)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


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
