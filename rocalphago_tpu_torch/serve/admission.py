"""Admission control for the serving pool: bounded queue, session cap.

The port of the reference package's ``serve/admission.py``, with its
defaults (256 sessions, 1,024 queued rows) and no environment knobs. A
serving process protects itself at two boundaries:

* **sessions** -- :meth:`AdmissionController.admit_session` refuses to
  open a game past ``max_sessions`` (:class:`AdmissionError`; a load
  balancer reads the live count off the ``rocalphago-health`` probe);
* **evaluation rows** -- the shared evaluator's queue is bounded at
  ``queue_rows`` pending leaf rows. A submit past the bound is shed:
  :class:`EvaluatorOverload` goes back to the submitting session, whose
  :class:`~rocalphago_tpu_torch.interface.resilient.ResilientPlayer`
  ladder steps it down (reason ``overload``: the reduced retry, then
  the raw policy move, then the rules fallback).

Both decisions are counted (``serve_sheds_total{kind=}``,
``serve_sessions_live``).
"""

from __future__ import annotations

import threading

from rocalphago_tpu_torch.obs import registry as obs_registry

#: default cap on concurrently open sessions
MAX_SESSIONS = 256
#: default bound on pending evaluation rows
QUEUE_ROWS = 1024


class AdmissionError(RuntimeError):
    """Session admission refused: the pool is at ``max_sessions``."""


class EvaluatorOverload(OSError):
    """The evaluator's bounded queue is full; this submit was shed.

    An ``OSError``, so :func:`rocalphago_tpu_torch.runtime.retries.
    is_transient` classifies it transient (load passes; a cheaper retry
    is safe), with ``degradation_reason`` naming the ladder's reason
    code so that sheds show as ``overload`` in the health probe and
    the metrics.
    """

    #: read by ``ResilientPlayer._classify``
    degradation_reason = "overload"


class AdmissionController:
    """Thread-safe counters + bounds shared by pool and evaluator."""

    def __init__(self, max_sessions: int | None = None,
                 queue_rows: int | None = None,
                 board: int | None = None):
        self.max_sessions = (MAX_SESSIONS if max_sessions is None
                             else max_sessions)
        self.queue_rows = QUEUE_ROWS if queue_rows is None else queue_rows
        self._lock = threading.Lock()
        self.live_sessions = 0            # guarded-by: self._lock
        self.session_rejects = 0          # guarded-by: self._lock
        self.queue_sheds = 0              # guarded-by: self._lock
        # ``board`` labels the gauges and counters per pool in a
        # multi-size process (serve_sessions_live{board=}); a plain
        # pool stays on the unlabelled series
        labels = {} if board is None else {"board": str(board)}
        self._live_g = obs_registry.gauge("serve_sessions_live",
                                          **labels)
        self._shed_queue_c = obs_registry.counter(
            "serve_sheds_total", kind="queue_full", **labels)
        self._shed_sess_c = obs_registry.counter(
            "serve_sheds_total", kind="session_reject", **labels)

    # ------------------------------------------------------- sessions

    def admit_session(self) -> None:
        with self._lock:
            if self.live_sessions >= self.max_sessions:
                self.session_rejects += 1
                self._shed_sess_c.inc()
                raise AdmissionError(
                    f"pool at capacity ({self.live_sessions}/"
                    f"{self.max_sessions} sessions)")
            self.live_sessions += 1
            self._live_g.set(self.live_sessions)

    def release_session(self) -> None:
        with self._lock:
            self.live_sessions = max(0, self.live_sessions - 1)
            self._live_g.set(self.live_sessions)

    def live(self) -> int:
        """Locked read of the live-session count (the evaluator's
        fill target polls this once per dispatch round)."""
        with self._lock:
            return self.live_sessions

    # ---------------------------------------------------- eval queue

    def admit_rows(self, pending_rows: int, rows: int) -> None:
        """Raise :class:`EvaluatorOverload` (counted) when accepting
        ``rows`` more pending evaluation rows would cross the bound.
        Called under the evaluator's queue lock: a pure check and a
        count, never blocks."""
        if pending_rows + rows > self.queue_rows:
            with self._lock:
                self.queue_sheds += 1
            self._shed_queue_c.inc()
            raise EvaluatorOverload(
                f"evaluator queue full ({pending_rows} pending + "
                f"{rows} > {self.queue_rows} rows)")

    def stats(self) -> dict:
        with self._lock:
            return {
                "live_sessions": self.live_sessions,
                "max_sessions": self.max_sessions,
                "queue_rows": self.queue_rows,
                "session_rejects": self.session_rejects,
                "queue_sheds": self.queue_sheds,
            }
