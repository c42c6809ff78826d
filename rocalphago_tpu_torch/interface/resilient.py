"""Self-healing serving wrapper: the degradation ladder.

The port of the reference package's ``interface/resilient.py``. A GTP
controller forfeits the game on any ``? error`` reply, so a raising
``player.get_move`` must never reach it. :class:`ResilientPlayer` wraps
any ``get_move(state)`` player in four rungs, walked top to bottom
until a legal move comes out:

1. **search** -- the wrapped player's full search, optionally
   hang-protected: the call runs in a worker thread watched by a
   :class:`~rocalphago_tpu_torch.runtime.watchdog.Watchdog`, and a
   stalled search is abandoned;
2. **reduced** -- one retry of the same search on the same device with
   a reduced simulation budget, taken only for transient errors
   (:func:`rocalphago_tpu_torch.runtime.retries.is_transient`: a CUDA
   out-of-memory error or an ``OSError``) and evaluator load sheds;
3. **policy** -- the argmax of the same policy net on the same device
   over the sensible legal moves
   (:class:`~rocalphago_tpu_torch.search.players.GreedyPolicyPlayer`);
4. **fallback** -- no net at all: the first sensible legal move by the
   host rules, else pass. It touches no device (after a sticky CUDA
   error the card cannot answer) and cannot fail: even an injected
   fault inside it degrades to a pass.

No rung is a device fallback: the first three run on the card the
player was built for, and only the last runs no net. Every rung
transition is a structured ``degradation`` event (rung, reason, error,
latency) in ``metrics.jsonl`` when a
:class:`~rocalphago_tpu_torch.io.metrics.MetricsLogger` is attached,
and is counted for the GTP ``rocalphago-health`` probe and in the
metric registry. The fault barriers ``serve.search`` /
``serve.reduced`` / ``serve.policy`` / ``serve.fallback``
(:mod:`rocalphago_tpu_torch.runtime.faults`, iteration =
``state.turns_played``) let the chaos tests break every rung.
"""

from __future__ import annotations

import threading
import time

import torch

from rocalphago_tpu_torch.obs import registry as obs_registry
from rocalphago_tpu_torch.obs import trace
from rocalphago_tpu_torch.runtime import faults
from rocalphago_tpu_torch.runtime.retries import is_transient
from rocalphago_tpu_torch.runtime.watchdog import Watchdog

#: ladder rungs, strongest first (the order the ladder walks them)
RUNGS = ("search", "reduced", "policy", "fallback")

#: reason codes a degradation event may carry. ``overload`` is the
#: serving pool's load-shed signal (:class:`~rocalphago_tpu_torch.
#: serve.admission.EvaluatorOverload`): the shared evaluator's bounded
#: queue refused the session's leaf evaluations, and the ladder is the
#: per-session shed policy -- the reduced retry (less load), then the
#: raw policy net (no evaluator at all).
REASONS = ("transient_error", "overload", "error", "hang",
           "illegal_from_player", "fallback_error", "barrier_fault")


class SearchHang(RuntimeError):
    """The primary search exceeded the hang timeout and was abandoned
    (the worker thread may still be running; its result is discarded).
    A RuntimeError, deliberately not transient: a retry at the reduced
    rung would hang again, so the ladder goes on to the policy rung."""


class _IllegalFromPlayer(Exception):
    """Internal: the rung produced a move the rules oracle rejects."""


def percentile(sorted_vals, q: float):
    """Nearest-rank percentile of an ascending list (None if empty);
    the health probe's p50 and p99."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class ResilientPlayer:
    """Degradation-ladder wrapper around any ``get_move`` player.

    Parameters
    ----------
    primary : the wrapped player (``get_move(state)``; rung 1).
    policy : optional :class:`~rocalphago_tpu_torch.models.policy.
        CNNPolicy` for the raw-policy rung. Defaults to
        ``primary.policy`` when the primary exposes one
        (DeviceMCTSPlayer, the pool's SessionPlayer and the policy
        players do); without a net the ladder skips rung 3.
    metrics : optional ``MetricsLogger``-shaped object (``log(event,
        **fields)``); degradation events and watchdog stalls land in
        its ``metrics.jsonl``.
    reduced_sims : simulation cap for the reduced-retry rung; default
        ``max(1, primary.n_sim // 4)`` when the primary has an
        ``n_sim``, else a plain retry. Applied via the primary's
        ``sim_limit`` attribute when it has one.
    hang_timeout_s : wall seconds after which a silent rung-1 search
        is abandoned (None disables hang protection, the default: no
        worker thread in the path unless asked for).
    """

    def __init__(self, primary, policy=None, metrics=None,
                 reduced_sims: int | None = None,
                 hang_timeout_s: float | None = None):
        self.primary = primary
        self._policy = (policy if policy is not None
                        else getattr(primary, "policy", None))
        self._greedy = None               # built on first policy rung
        self.metrics = metrics
        self.hang_timeout_s = hang_timeout_s
        if reduced_sims is None:
            n = getattr(primary, "n_sim", None)
            reduced_sims = max(1, n // 4) if n else None
        self.reduced_sims = reduced_sims
        # observability (the GTP health/stats probes read these)
        self.genmoves = 0
        self.served = {r: 0 for r in RUNGS}     # moves served per rung
        self.rung_failures = {r: 0 for r in RUNGS}
        self.reasons: dict = {}                 # reason code -> count
        self.illegal_from_player = 0
        self.barrier_faults = 0
        self.last_rung = None
        self.last_fallback = None       # {"rung","reason","turn"} | None
        self.latencies: list = []       # per-get_move wall seconds

    # ------------------------------------------------------------ rungs

    def _greedy_player(self):
        if self._greedy is None and self._policy is not None:
            from rocalphago_tpu_torch.search.players import (
                GreedyPolicyPlayer,
            )

            # a move cap (4·N², far past any real game) so a degraded
            # endgame always ends in passes even if the deterministic
            # greedy move would capture-cycle
            board = getattr(self._policy, "board", None)
            limit = 4 * board * board if board else None
            self._greedy = GreedyPolicyPlayer(self._policy,
                                              move_limit=limit)
        return self._greedy

    def _acceptable(self, state, move) -> bool:
        """A servable answer: a legal board move, or pass while the
        game is live (after the game has ended nothing is legal: the
        ladder then bottoms out and the engine reports game over)."""
        if move is None:
            return not state.is_end_of_game
        return bool(state.is_legal(move))

    def _attempt(self, rung: str, fn, state):
        """One rung: its fault barrier, then the rung's move fn,
        hang-protected for the search rungs when configured. Raises on
        any failure; returns the move otherwise."""
        timeout = (self.hang_timeout_s if rung in ("search", "reduced")
                   else None)

        def protected():
            # the rung span pins WHERE a hang happened: the watchdog's
            # stall event reads the deepest open span across threads
            # (obs.trace.where), which is this one when a rung wedges
            with trace.span(f"serve.{rung}",
                            turn=state.turns_played):
                faults.barrier(f"serve.{rung}",
                               iteration=state.turns_played)
                return fn(state)

        if timeout is None:
            return protected()
        box: dict = {}
        done = threading.Event()
        abandoned = threading.Event()

        def work():
            try:
                # grad mode is per thread: the worker sets its own
                with torch.no_grad():
                    box["move"] = protected()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["exc"] = e
            finally:
                done.set()

        # the watchdog is the stall detector: no beat ever arrives, so
        # it fires once at the timeout (logging the stall) and flags
        # the abandon event instead of ending the process (exit=False)
        wd = Watchdog(timeout, metrics=self.metrics,
                      abort_fn=abandoned.set, name=f"serve.{rung}",
                      exit=False, poll_s=min(0.05, timeout / 4.0))
        # abandoned by design on a hang: joining a wedged search would
        # bring back the hang the ladder exists to escape; the daemon
        # worker's result is discarded. It holds no evaluator lock
        # while it runs on (each submit takes the lock only to queue)
        worker = threading.Thread(  # jaxlint: disable=thread-no-join
            target=work, daemon=True, name=f"genmove-{rung}")
        with wd:
            worker.start()
            while not done.is_set():
                if abandoned.is_set():
                    raise SearchHang(
                        f"{rung} rung silent for {timeout}s; "
                        "abandoned")
                done.wait(0.02)
        if "exc" in box:
            raise box["exc"]
        return box.get("move")

    def _reduced_call(self, state):
        """The reduced-budget re-dispatch: cap the primary's simulations
        through its ``sim_limit`` hook when it has one
        (DeviceMCTSPlayer, SessionPlayer), else a plain retry."""
        if self.reduced_sims is not None and \
                hasattr(self.primary, "sim_limit"):
            prev = self.primary.sim_limit
            self.primary.sim_limit = self.reduced_sims
            try:
                return self.primary.get_move(state)
            finally:
                self.primary.sim_limit = prev
        return self.primary.get_move(state)

    def _fallback_move(self, state):
        """Rung 4: the first sensible legal move by the host rules,
        else pass. Deterministic, net-free, device-free."""
        moves = state.get_legal_moves(include_eyes=False)
        return moves[0] if moves else None

    # ----------------------------------------------------- bookkeeping

    def _classify(self, exc) -> str:
        if isinstance(exc, _IllegalFromPlayer):
            return "illegal_from_player"
        if isinstance(exc, SearchHang):
            return "hang"
        # exceptions may name their own ladder reason (duck-typed, so
        # serve.admission need not be imported here): the pool's
        # EvaluatorOverload carries "overload", keeping load sheds
        # apart from other transient errors in every probe
        named = getattr(exc, "degradation_reason", None)
        if isinstance(named, str) and named in REASONS:
            return named
        return "transient_error" if is_transient(exc) else "error"

    def _note(self, rung: str, reason: str, exc, t0: float,
              turn: int) -> None:
        self.rung_failures[rung] += 1
        self.reasons[reason] = self.reasons.get(reason, 0) + 1
        obs_registry.counter("serve_degradation_total", rung=rung,
                             reason=reason).inc()
        if reason == "illegal_from_player":
            self.illegal_from_player += 1
        if self.metrics is not None:
            err = None if exc is None else \
                f"{type(exc).__name__}: {exc}"
            self.metrics.log(
                "degradation", rung=rung, reason=reason,
                turn=turn, error=err,
                latency_s=round(time.monotonic() - t0, 4))

    def note_barrier_fault(self, barrier: str, exc) -> None:
        """An engine-level serving barrier (``genmove.*``) raised in
        resilient mode: counted and logged, never surfaced."""
        self.barrier_faults += 1
        self.reasons["barrier_fault"] = \
            self.reasons.get("barrier_fault", 0) + 1
        obs_registry.counter("serve_degradation_total", rung="barrier",
                             reason="barrier_fault").inc()
        if self.metrics is not None:
            self.metrics.log("degradation", rung="barrier",
                             reason="barrier_fault", barrier=barrier,
                             error=f"{type(exc).__name__}: {exc}")

    # ----------------------------------------------------------- serve

    def _run(self, rung: str, fn, state):
        """Attempt one rung end to end, the legality check included.
        Returns the move; raises (``_IllegalFromPlayer`` included) on
        anything unservable."""
        move = self._attempt(rung, fn, state)
        if not self._acceptable(state, move):
            raise _IllegalFromPlayer(f"{rung} rung returned {move!r}")
        return move

    def get_move(self, state):
        t0 = time.monotonic()
        turn = state.turns_played
        self.genmoves += 1
        try:
            move, rung = self._ladder(state, t0, turn)
        finally:
            self.latencies.append(time.monotonic() - t0)
        self.served[rung] += 1
        # ladder rungs as registry counters: the GTP stats probe reads
        # served-per-rung without a ladder reference
        obs_registry.counter("serve_rung_total", rung=rung).inc()
        self.last_rung = rung
        if rung != "search":
            self.last_fallback = {
                "rung": rung,
                "reason": self._last_reason,
                "turn": turn,
            }
        return move

    def _ladder(self, state, t0: float, turn: int):
        self._last_reason = None
        # rung 1: the full search
        try:
            return self._run("search", self.primary.get_move,
                             state), "search"
        except Exception as e:  # noqa: BLE001 — classified below
            reason = self._classify(e)
            self._note("search", reason, e, t0, turn)
            self._last_reason = reason
        # rung 2: the reduced retry, for transient errors and load
        # sheds only (after a hang it would hang again, after a
        # programming error re-raise, after an illegal move return it
        # again). Under overload the reduced budget is the shed: a
        # quarter of the leaf evaluations re-enter the queue, and if
        # even that sheds, the policy rung costs the evaluator nothing
        if reason in ("transient_error", "overload"):
            try:
                return self._run("reduced", self._reduced_call,
                                 state), "reduced"
            except Exception as e:  # noqa: BLE001
                reason = self._classify(e)
                self._note("reduced", reason, e, t0, turn)
                self._last_reason = reason
        # rung 3: the raw policy net
        greedy = self._greedy_player()
        if greedy is not None:
            try:
                return self._run("policy", greedy.get_move,
                                 state), "policy"
            except Exception as e:  # noqa: BLE001
                reason = self._classify(e)
                self._note("policy", reason, e, t0, turn)
                self._last_reason = reason
        # rung 4: a host-rules move or pass. Cannot fail: even an
        # injected fault here degrades to the unconditional pass
        try:
            move = self._attempt("fallback", self._fallback_move,
                                 state)
            if move is not None and not state.is_legal(move):
                move = None
        except Exception as e:  # noqa: BLE001
            self._note("fallback", "fallback_error", e, t0, turn)
            self._last_reason = "fallback_error"
            move = None
        return move, "fallback"

    # ----------------------------------------------- player passthrough

    @property
    def policy(self):
        """The policy net backing the ladder's rung 3 (shared with the
        primary; also lets ``player_board`` see the net size)."""
        return self._policy

    def set_move_time(self, seconds) -> None:
        set_time = getattr(self.primary, "set_move_time", None)
        if set_time is not None:
            set_time(seconds)

    def reset(self) -> None:
        """New game: clear the primary's cross-move search state (the
        ladder itself carries none; its counters are per-process
        observability, deliberately not reset per game)."""
        from rocalphago_tpu_torch.search.players import reset_player

        reset_player(self.primary)

    # ------------------------------------------------------------ stats

    def stats(self) -> dict:
        """The health-probe snapshot (the ``rocalphago-health``
        schema)."""
        lat = sorted(self.latencies)
        degraded = {r: self.served[r] for r in RUNGS[1:]}
        return {
            "genmoves": self.genmoves,
            "degradations": degraded,
            "degraded_total": sum(degraded.values()),
            "rung_failures": dict(self.rung_failures),
            "reasons": dict(self.reasons),
            "illegal_from_player": self.illegal_from_player,
            "barrier_faults": self.barrier_faults,
            "last_rung": self.last_rung,
            "last_fallback": self.last_fallback,
            "latency_s": {
                "p50": (round(percentile(lat, 0.50), 4)
                        if lat else None),
                "p99": (round(percentile(lat, 0.99), 4)
                        if lat else None),
                "last": (round(self.latencies[-1], 4)
                         if self.latencies else None),
            },
        }
