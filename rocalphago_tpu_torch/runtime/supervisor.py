"""A supervised worker fleet: restarts, crash-loop parking, drain. A
copy of the reference package's ``runtime/supervisor.py``, with its
defaults (no environment knobs).

* **Restart policy** (:class:`RestartPolicy`): a dead worker is
  classified with :func:`.retries.is_transient`'s line, restarted
  after a deterministic-jitter backoff (:func:`.retries.
  backoff_delay`), and parked -- for good, with a ``worker_parked``
  event -- once it dies ``max_deaths`` times within ``window_s`` (a
  crash loop).
* **Heartbeat liveness**: workers report progress through their
  handle's ``beat``; the monitor tags alive workers whose beat is stale
  in the watchdog's ``waiting_on`` registry (``actor:3``), so a
  :class:`.watchdog.Watchdog` stall names the wedged member. The first
  beat after a restart closes the MTTR clock (``worker_recovered``).
* **Graceful drain**: :meth:`Supervisor.install_sigterm` routes SIGTERM
  (the preemption notice) to :meth:`Supervisor.request_drain`:
  restarts stop, a ``drain`` event is logged, and the training loop
  sees :attr:`Supervisor.draining` and exits at its next iteration
  boundary with a committed checkpoint.

:class:`Supervisor` manages replaceable workers built per incarnation
by a factory (the self-play actors; lockstep actors are registered
``restartable=False`` and park on their first death, so the lockstep
bit-identity holds); :class:`SupervisedThread` re-enters a long-lived
loop body after an unexpected exception.

Lifecycle events (``worker_restart``, ``worker_parked``,
``worker_recovered``, ``drain``) go to the run's ``metrics.jsonl``
through the given logger; the registry counts
``supervisor_restarts_total{worker=,reason=}`` and
``supervisor_parked_total{worker=}`` and observes
``supervisor_mttr_seconds``.
"""

from __future__ import annotations

import signal
import threading
import time

from rocalphago_tpu_torch.obs import registry
from rocalphago_tpu_torch.runtime import retries
from rocalphago_tpu_torch.runtime import watchdog as watchdog_mod

#: park a worker after this many deaths within the window
MAX_DEATHS = 3
#: crash-loop window, seconds
WINDOW_S = 60.0
#: base restart backoff, seconds
BACKOFF_S = 0.25
#: monitor poll interval, seconds
POLL_S = 0.2
#: an alive worker whose last beat is older than this is named stale
HEARTBEAT_S = 30.0


class RestartPolicy:
    """When and how fast to resurrect a dead worker. ``classify`` is
    ``transient`` (infrastructure flake, :func:`.retries.is_transient`)
    or ``error``; both restart, but a crash loop of either parks."""

    def __init__(self, max_deaths: int | None = None,
                 window_s: float | None = None,
                 base_delay: float | None = None,
                 max_delay: float = 30.0, seed: int = 0):
        self.max_deaths = MAX_DEATHS if max_deaths is None else max_deaths
        self.window_s = WINDOW_S if window_s is None else window_s
        self.base_delay = BACKOFF_S if base_delay is None else base_delay
        self.max_delay = max_delay
        self.seed = seed

    def classify(self, error: BaseException) -> str:
        return "transient" if retries.is_transient(error) else "error"

    def crash_looping(self, deaths: list[float], now: float) -> bool:
        recent = [t for t in deaths if now - t <= self.window_s]
        return len(recent) >= self.max_deaths

    def delay(self, attempt: int, key: str) -> float:
        return retries.backoff_delay(attempt, self.base_delay,
                                     self.max_delay, self.seed, key)


class Handle:
    """One supervised slot: the current worker incarnation and its
    restart history (from :meth:`Supervisor.add`). Every field but the
    beat pair is written by the monitor thread only."""

    def __init__(self, factory, name: str, restartable: bool, sup):
        self.factory = factory
        self.name = name
        self.restartable = restartable
        self.worker = None          # current incarnation
        self.restarts = 0
        self.parked = False
        self.finished = False       # clean exit (games bound, stop)
        self.error: BaseException | None = None
        self.last_mttr_s: float | None = None
        self._sup = sup
        self._deaths: list[float] = []
        # lock-free heartbeat pair: one writer (the worker, via beat)
        # and one reader (the monitor); _recover_t0 is set by the
        # monitor while the worker is dead, cleared by the first beat
        self._last_beat = time.monotonic()
        self._recover_t0: float | None = None

    def beat(self) -> None:
        """Report progress (workers call it once a unit of work, a
        finished game). The first beat after a restart stamps the
        MTTR."""
        self._last_beat = time.monotonic()
        t0 = self._recover_t0
        if t0 is not None:
            self._recover_t0 = None
            mttr = time.monotonic() - t0
            self.last_mttr_s = mttr
            registry.histogram("supervisor_mttr_seconds").observe(mttr)
            self._sup._emit("worker_recovered", worker=self.name,
                            restarts=self.restarts,
                            mttr_s=round(mttr, 3))

    def alive(self) -> bool:
        w = self.worker
        return w is not None and w.alive()


class Supervisor:
    """Monitor thread resurrecting factory-built workers on death.

    Worker protocol (:class:`~..training.actor.SelfplayActor` has it):
    ``start()``, ``stop(timeout)``, ``alive() -> bool`` and an ``error``
    attribute that is None after a clean exit. ``factory(attempt,
    beat)`` builds incarnation ``attempt`` (0 first); ``beat`` is the
    handle's heartbeat. A worker whose thread ends with ``error`` set
    has died: the monitor classifies, backs off and restarts it, unless
    the handle is ``restartable=False`` (it parks at once, reason
    ``restart_refused``) or the crash-loop detector trips."""

    def __init__(self, *, metrics=None, policy: RestartPolicy | None = None,
                 poll_s: float | None = None,
                 heartbeat_s: float | None = None):
        self._metrics = metrics
        self.policy = policy or RestartPolicy()
        self._poll_s = POLL_S if poll_s is None else poll_s
        self._heartbeat_s = (HEARTBEAT_S if heartbeat_s is None
                             else heartbeat_s)
        self._lock = threading.Lock()
        self._handles: list[Handle] = []   # guarded-by: self._lock
        self._draining = False             # guarded-by: self._lock
        self.drain_reason: str | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._monitor, name="supervisor", daemon=True)
        self._stale_tag: str | None = None      # monitor thread only
        self._stale_cm = None                   # monitor thread only
        self._old_sigterm = None

    # ------------------------------------------------------ lifecycle

    def add(self, factory, *, name: str,
            restartable: bool = True) -> Handle:
        """Register a worker slot; :meth:`start` (or a restart) builds
        and starts the worker."""
        h = Handle(factory, name, restartable, self)
        with self._lock:
            self._handles.append(h)
        return h

    def start(self) -> "Supervisor":
        for h in self.handles():
            if h.worker is None:
                h.worker = h.factory(0, h.beat)
                h.worker.start()
                h._last_beat = time.monotonic()
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop restarting, join the monitor, stop every worker."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)
        for h in self.handles():
            if h.worker is not None:
                h.worker.stop(timeout=timeout)
        self.restore_sigterm()

    def handles(self) -> list[Handle]:
        with self._lock:
            return list(self._handles)

    def parked(self) -> list[Handle]:
        return [h for h in self.handles() if h.parked]

    # ---------------------------------------------------------- drain

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def request_drain(self, reason: str = "signal") -> None:
        """Graceful drain: restarts stop; the training loop exits at its
        next iteration boundary with a committed checkpoint.
        Idempotent."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
            self.drain_reason = reason
        self._emit("drain", phase="requested", reason=reason)

    def install_sigterm(self) -> bool:
        """Route SIGTERM to :meth:`request_drain`. Only the main thread
        can install a handler: elsewhere this is a no-op returning
        False."""
        if threading.current_thread() is not threading.main_thread():
            return False
        self._old_sigterm = signal.signal(
            signal.SIGTERM,
            lambda signum, frame: self.request_drain(reason="sigterm"))
        return True

    def restore_sigterm(self) -> None:
        if (self._old_sigterm is not None
                and threading.current_thread()
                is threading.main_thread()):
            signal.signal(signal.SIGTERM, self._old_sigterm)
            self._old_sigterm = None

    # -------------------------------------------------------- monitor

    def _emit(self, event: str, **fields) -> None:
        if self._metrics is not None:
            self._metrics.log(event, **fields)

    def _park(self, h: Handle, reason: str) -> None:
        h.parked = True
        registry.counter("supervisor_parked_total", worker=h.name).inc()
        self._emit("worker_parked", worker=h.name, reason=reason,
                   deaths=len(h._deaths),
                   error=(f"{type(h.error).__name__}: {h.error}"
                          if h.error is not None else None))

    def _restart(self, h: Handle, now: float) -> None:
        err = h.error
        reason = self.policy.classify(err)
        if not h.restartable:
            self._park(h, reason="restart_refused")
            return
        if self.policy.crash_looping(h._deaths, now):
            self._park(h, reason="crash_loop")
            return
        h.restarts += 1
        delay = self.policy.delay(h.restarts, key=h.name)
        registry.counter("supervisor_restarts_total", worker=h.name,
                         reason=reason).inc()
        self._emit("worker_restart", worker=h.name, reason=reason,
                   restarts=h.restarts, delay_s=round(delay, 3),
                   error=f"{type(err).__name__}: {err}")
        # the MTTR clock starts at the death's detection
        h._recover_t0 = now
        if self._stop.wait(delay):
            return
        w = h.factory(h.restarts, h.beat)
        w.start()
        h.worker = w
        h._last_beat = time.monotonic()

    def _retag_stale(self, handles: list[Handle], now: float) -> None:
        stale = sorted(
            h.name for h in handles
            if not h.parked and not h.finished and h.alive()
            and now - h._last_beat > self._heartbeat_s)
        tag = ",".join(stale) if stale else None
        if tag == self._stale_tag:
            return
        if self._stale_cm is not None:
            self._stale_cm.__exit__(None, None, None)
            self._stale_cm = None
        if tag is not None:
            self._stale_cm = watchdog_mod.waiting_on(tag)
            self._stale_cm.__enter__()
        self._stale_tag = tag

    def _monitor(self) -> None:
        try:
            while not self._stop.wait(self._poll_s):
                with self._lock:
                    handles = list(self._handles)
                    draining = self._draining
                now = time.monotonic()
                for h in handles:
                    if (h.parked or h.finished or h.worker is None
                            or h.alive()):
                        continue
                    err = getattr(h.worker, "error", None)
                    if err is None or draining:
                        # games bound reached, stopped, or draining: the
                        # death is final; only a clean one counts as done
                        h.finished = err is None
                        continue
                    h.error = err
                    h._deaths.append(now)
                    self._restart(h, now)
                self._retag_stale(handles, now)
        finally:
            if self._stale_cm is not None:
                self._stale_cm.__exit__(None, None, None)
                self._stale_cm = None
                self._stale_tag = None


class SupervisedThread:
    """Daemon thread that re-enters its target after an unexpected
    exception (a loop body whose state lives outside the thread). A
    return of ``target`` ends the thread; an exception is classified,
    the thread backs off (the :class:`Supervisor` schedule) and re-enters,
    until the crash-loop detector parks it -- then ``on_park`` runs and
    the thread ends with ``error`` set and ``parked`` True."""

    def __init__(self, target, name: str, *,
                 policy: RestartPolicy | None = None, metrics=None,
                 on_park=None):
        self._target = target
        self.name = name
        self.policy = policy or RestartPolicy()
        self._metrics = metrics
        self._on_park = on_park
        self.restarts = 0
        self.parked = False
        self.error: BaseException | None = None
        self._deaths: list[float] = []
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True)

    def start(self) -> "SupervisedThread":
        self._thread.start()
        return self

    def join(self, timeout: float | None = None) -> None:
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    def _emit(self, event: str, **fields) -> None:
        if self._metrics is not None:
            self._metrics.log(event, **fields)

    def _run(self) -> None:
        while True:
            try:
                self._target()
                return                       # clean stop
            except Exception as e:  # noqa: BLE001 — classified below
                now = time.monotonic()
                self._deaths.append(now)
                self.error = e
                reason = self.policy.classify(e)
                if self.policy.crash_looping(self._deaths, now):
                    self.parked = True
                    registry.counter("supervisor_parked_total",
                                     worker=self.name).inc()
                    self._emit("worker_parked", worker=self.name,
                               reason="crash_loop",
                               deaths=len(self._deaths),
                               error=f"{type(e).__name__}: {e}")
                    if self._on_park is not None:
                        self._on_park()
                    return
                self.restarts += 1
                delay = self.policy.delay(self.restarts, key=self.name)
                registry.counter("supervisor_restarts_total",
                                 worker=self.name, reason=reason).inc()
                self._emit("worker_restart", worker=self.name,
                           reason=reason, restarts=self.restarts,
                           delay_s=round(delay, 3),
                           error=f"{type(e).__name__}: {e}")
                time.sleep(delay)
