"""Nested tracing spans over the ``metrics.jsonl`` stream.

A copy of the reference package's ``obs/trace.py`` (standard library
only). ``with span("gtp.genmove"):`` wraps a phase of a host loop; on
exit one structured ``span`` record goes through the process's
configured sink (a :class:`~rocalphago_tpu_torch.io.metrics.
MetricsLogger`, the same JSONL stream as the other metrics)::

    {"event": "span", "name": "serve.search",
     "path": "gtp.genmove/serve.search", "parent": "gtp.genmove",
     "depth": 1, "dur_s": 1.234567, "start": <wall clock t0>,
     "ok": true, ...caller tags...}

Durations are ``time.monotonic`` differences; ``start`` is wall clock.
Nesting is per thread (a thread-local stack), but the set of open spans
is visible process-wide through :func:`open_spans` / :func:`where`, so
the watchdog's ``stall`` events say where the process hung; the stack
is kept even with no sink configured (a span without a sink emits
nothing). One process, one sink: the GTP CLI and the trainers call
:func:`configure` right after building their ``MetricsLogger``.

Span durations are host wall time. CUDA work is queued, not waited
for, so a span around a phase that only launches kernels closes when
the host has queued them; a phase's device remainder lands in the
first span that reads a result back (the trainers' metrics read).

While a ``torch.profiler`` capture records the calling thread, a span
also opens a ``torch.profiler.record_function`` range of its name, so
the program's phases sit on the capture's timeline beside the card's
kernels (``start`` and the profiler read the same epoch clock). The
record written to the sink is the same with or without a capture. The
module never imports torch: it looks for it among the loaded modules.
"""

from __future__ import annotations

import sys
import threading
import time

_lock = threading.Lock()
_stacks: dict = {}        # guarded-by: _lock — ident -> open frames
_names: dict = {}         # guarded-by: _lock — ident -> thread name
_sink = None
_enabled = True


class _Frame:
    __slots__ = ("name", "path", "t0", "wall0")


def configure(metrics=None, enabled: bool = True) -> None:
    """Install the process sink (``MetricsLogger``-shaped: ``write``
    or ``log``). ``metrics=None`` detaches; ``enabled=False`` keeps
    the sink but mutes emission (the cheap global off-switch)."""
    global _sink, _enabled
    _sink = metrics
    _enabled = enabled


def sink():
    """The configured sink (None when detached): a caller that runs a
    nested trainer, which configures its own, puts this one back."""
    return _sink


def emit(event: str, **fields) -> None:
    """Write one structured event through the configured sink (no-op
    when unconfigured/muted); prefers the sink's file-only ``write``
    over ``log`` so high-rate telemetry never spams the console."""
    s = _sink
    if s is None or not _enabled:
        return
    fn = getattr(s, "write", None) or s.log
    fn(event, **fields)


class span:
    """``with span("name", **tags):`` — one timed, nested phase.

    Reusable but not reentrant: construct one per ``with`` block.
    Exceptions propagate; the record then carries ``ok: false`` and
    an ``error`` string (the exception is NOT swallowed).
    """

    __slots__ = ("name", "tags", "_frame", "_ident", "_range")

    def __init__(self, name: str, **tags):
        self.name = name
        self.tags = tags
        self._frame = None
        self._range = None

    def __enter__(self) -> "span":
        f = _Frame()
        f.t0 = time.monotonic()
        f.wall0 = time.time()
        f.name = self.name
        ident = threading.get_ident()
        with _lock:
            stack = _stacks.get(ident)
            if stack is None:
                stack = _stacks[ident] = []
                _names[ident] = threading.current_thread().name
            f.path = (self.name if not stack
                      else stack[-1].path + "/" + self.name)
            stack.append(f)
        self._frame = f
        self._ident = ident
        self._range = _profiler_range(self.name)
        return self

    def __exit__(self, et, ev, tb):
        f = self._frame
        dur = time.monotonic() - f.t0
        if self._range is not None:
            self._range.__exit__(et, ev, tb)
        with _lock:
            stack = _stacks.get(self._ident)
            if stack and stack[-1] is f:
                stack.pop()
            elif stack and f in stack:      # unbalanced exit: heal
                del stack[stack.index(f):]
            if not stack:
                _stacks.pop(self._ident, None)
                _names.pop(self._ident, None)
        parent, _, _ = f.path.rpartition("/")
        fields = dict(
            name=f.name, path=f.path, parent=parent or None,
            depth=f.path.count("/"), dur_s=round(dur, 6),
            start=round(f.wall0, 6), ok=et is None)
        if et is not None:
            fields["error"] = f"{et.__name__}: {ev}"
        fields.update(self.tags)
        emit("span", **fields)
        return False


def _profiler_range(name: str):
    """An entered ``record_function`` range named ``name`` when a
    ``torch.profiler`` capture records this thread, else None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


def current_path() -> str | None:
    """Innermost open span path of the CALLING thread (None when no
    span is open here)."""
    with _lock:
        stack = _stacks.get(threading.get_ident())
        return stack[-1].path if stack else None


def open_spans() -> dict:
    """``{thread_name: innermost open span path}`` across every
    thread — the process-wide 'what is everyone doing' view."""
    with _lock:
        return {_names[ident]: stack[-1].path
                for ident, stack in _stacks.items() if stack}


def where() -> str | None:
    """Best one-string answer to 'where is this process right now':
    the DEEPEST open span path across all threads (a hung worker's
    rung span beats the engine's outer genmove span); ties prefer
    MainThread, then thread-name order — deterministic, so stall
    logs are assertable."""
    spans = open_spans()
    if not spans:
        return None

    def rank(item):
        tname, path = item
        return (-path.count("/"), tname != "MainThread", tname)

    return sorted(spans.items(), key=rank)[0][1]
