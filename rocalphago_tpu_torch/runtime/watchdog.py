"""Heartbeat watchdog for long loops and hung searches. A copy of the
reference package's ``runtime/watchdog.py``.

A wedged card program leaves a ``nohup`` run silently stuck. The
watchdog is a daemon thread the loop feeds with :meth:`Watchdog.beat`
once per iteration; if no beat arrives within the deadline it logs a
``stall`` event (to the run's ``metrics.jsonl`` through the given
logger) and, in abort mode, calls the caller's ``abort_fn`` -- whose
job is to save the last completed state -- and exits the process with
:data:`STALL_EXIT_CODE` (``exit=False`` keeps it: the serving ladder
abandons a hung search that way). Without ``abort_fn`` it only logs.
A stall event's ``span`` field is the deepest open tracing span across
all threads (:func:`rocalphago_tpu_torch.obs.trace.where`), so the
operator reads the stuck phase straight off ``metrics.jsonl``.

Starvation against deadlock: a learner blocked on an empty replay
buffer shows the same missing beat as a wedged program. Code that
blocks by design wraps the wait in :func:`waiting_on`, and the stall
event's ``waiting_on`` field names it (e.g. ``replay_fill``).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

from rocalphago_tpu_torch.obs import trace

STALL_EXIT_CODE = 170

_waiting_lock = threading.Lock()
_waiting: dict[int, str] = {}  # guarded-by: _waiting_lock


@contextlib.contextmanager
def waiting_on(phase: str):
    """Tag the calling thread as deliberately blocked on ``phase``.
    Nested tags restore the outer one on exit; the registry is keyed by
    thread, so concurrent waiters do not clobber each other."""
    ident = threading.get_ident()
    with _waiting_lock:
        prev = _waiting.get(ident)
        _waiting[ident] = phase
    try:
        yield
    finally:
        with _waiting_lock:
            if prev is None:
                _waiting.pop(ident, None)
            else:
                _waiting[ident] = prev


def waiting_phases() -> tuple[str, ...]:
    """Sorted distinct phases threads are blocked on now."""
    with _waiting_lock:
        return tuple(sorted(set(_waiting.values())))


class Watchdog:
    """``with Watchdog(deadline_s, metrics=logger) as wd: wd.beat()``.

    ``metrics``: an object with ``log(event, **fields)`` (a
    ``MetricsLogger``), or None for stderr. ``abort_fn``: run once on
    the first stall; after it returns the process exits with
    :data:`STALL_EXIT_CODE` (``exit=False`` keeps it, for tests).
    Without ``abort_fn`` a stall is logged at most once a deadline."""

    def __init__(self, deadline_s: float, metrics=None,
                 abort_fn=None, name: str = "train",
                 exit: bool = True, poll_s: float | None = None):
        if deadline_s <= 0:
            raise ValueError(f"deadline must be > 0, got {deadline_s}")
        self.deadline_s = deadline_s
        self.metrics = metrics
        self.abort_fn = abort_fn
        self.name = name
        self.exit = exit
        self.stalls = 0
        self._poll_s = poll_s or min(1.0, deadline_s / 4.0)
        # one writer (beat) and one reader (_watch): a stale read of a
        # monotonic float only shifts a stall report by one poll
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._watch, name=f"watchdog-{name}", daemon=True)

    def start(self) -> "Watchdog":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def beat(self) -> None:
        self._last_beat = time.monotonic()

    def _log(self, elapsed: float) -> None:
        at = trace.where()          # deepest open span, any thread
        waits = waiting_phases()
        waiting = ",".join(waits) if waits else None
        if self.metrics is not None:
            self.metrics.log("stall", watchdog=self.name,
                             elapsed_s=round(elapsed, 1),
                             deadline_s=self.deadline_s, span=at,
                             waiting_on=waiting)
        else:
            print(f"watchdog[{self.name}]: no heartbeat for "
                  f"{elapsed:.0f}s (deadline {self.deadline_s:.0f}s)"
                  f"{f' in {at}' if at else ''}"
                  f"{f' waiting on {waiting}' if waiting else ''}",
                  file=sys.stderr)

    def _watch(self) -> None:
        while not self._stop.wait(self._poll_s):
            elapsed = time.monotonic() - self._last_beat
            if elapsed < self.deadline_s:
                continue
            self.stalls += 1
            self._log(elapsed)
            if self.abort_fn is not None:
                try:
                    self.abort_fn()
                finally:
                    if self.exit:
                        sys.stdout.flush()
                        sys.stderr.flush()
                        os._exit(STALL_EXIT_CODE)
                return
            self._last_beat = time.monotonic()
