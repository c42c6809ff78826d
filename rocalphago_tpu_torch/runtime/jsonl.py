"""Tolerant JSONL reading (standard library only).

A copy of the reference package's ``runtime/jsonl.py``. A process
killed in the middle of a ``write`` leaves at most one torn trailing
line in a line-buffered JSONL stream
(:class:`~rocalphago_tpu_torch.io.metrics.MetricsLogger` writes whole
lines through a ``buffering=1`` handle), so a reader that skips
undecodable lines loses at most the last record in flight.
"""

from __future__ import annotations

import json


def read_jsonl(path: str, on_error: str = "skip") -> list:
    """One dict per well-formed line of ``path``. ``on_error``: "skip"
    (default) drops undecodable or non-object lines; "raise" propagates
    the decode error."""
    with open(path) as f:
        return list(iter_jsonl(f, on_error))


def iter_jsonl(f, on_error: str = "skip"):
    """Streaming form over an open file object."""
    for line in f:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            if on_error == "raise":
                raise
            continue
        if isinstance(rec, dict):
            yield rec
