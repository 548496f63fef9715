"""Structured metrics — the logging/observability layer (a copy of
``sdr_tpu/obs/metrics.py``, which imports no JAX: the port keeps its own).

The reference has zero logging or metrics (SURVEY.md §5; its only
observability is the GUI itself). This is a minimal structured-metrics
facility: named counters/gauges with JSONL emission, used by long sweeps
so runs leave a machine-readable trail.
"""

from __future__ import annotations

import json
import threading
import time
from typing import IO, Optional


class Metrics:
    """Thread-safe named counters/gauges with optional JSONL sink."""

    def __init__(self, sink: Optional[IO[str]] = None, path: Optional[str] = None):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._sink = sink
        self._path = path

    def count(self, name: str, delta: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + delta

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ts": time.time(),
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
            }

    def emit(self, event: str = "snapshot", **extra) -> dict:
        """Write one JSONL record to the sink/path; returns the record."""
        rec = {"event": event, **self.snapshot(), **extra}
        line = json.dumps(rec)
        if self._sink is not None:
            self._sink.write(line + "\n")
            self._sink.flush()
        if self._path:
            with open(self._path, "a") as f:
                f.write(line + "\n")
        return rec


_global = Metrics()


def global_metrics() -> Metrics:
    return _global
