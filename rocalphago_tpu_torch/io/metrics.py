"""Structured training metrics: JSONL stream + stdout.

A copy of the reference package's ``io/metrics.py``: one JSON object
per event in ``metrics.jsonl`` (step, loss, accuracy, ...), echoed to
stdout by :meth:`MetricsLogger.log`.

Strict-parser contract: non-finite floats (NaN/Inf -- e.g. an empty
split's NaN) are sanitized to JSON ``null`` before serialization, and
``json.dumps`` runs with ``allow_nan=False``.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time


def sanitize(value):
    """Recursively replace non-finite floats with None (JSON null);
    tuples become lists (their JSON form anyway)."""
    if isinstance(value, float):           # incl. np.float64 subclass
        return value if math.isfinite(value) else None
    if isinstance(value, dict):
        return {k: sanitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [sanitize(v) for v in value]
    return value


class MetricsLogger:
    """Line-buffered JSONL event stream (``with``-able: closing is
    ``close``). Thread-safe: emission is one ``write()`` under a lock,
    so interleaved events never tear each other's lines and ``close``
    can race an emit without writing to a closed file. Serialization
    happens outside the lock."""

    def __init__(self, path: str | None):
        self.path = path
        self._lock = threading.Lock()
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._f = open(path, "a", buffering=1)
        else:
            self._f = None

    def write(self, event: str, **fields) -> None:
        """File-only emission (no console echo)."""
        rec = sanitize({"event": event, "time": time.time(), **fields})
        line = json.dumps(rec, allow_nan=False) + "\n"
        with self._lock:
            if self._f:
                self._f.write(line)

    def log(self, event: str, **fields) -> None:
        fields = sanitize(fields)
        self.write(event, **fields)
        shown = " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in fields.items())
        print(f"[{event}] {shown}", flush=True)

    def close(self) -> None:
        with self._lock:
            if self._f:
                self._f.close()
                self._f = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
