"""Wilson-gated canary: a candidate net earns full rollout in play.

The port of the reference package's ``rollout/canary.py``, with its
defaults and no environment knob (a 0.1 fraction of new sessions, a
32-game decision budget). The controller stages the candidate on the
pool WITHOUT flipping the current pointer (:meth:`~rocalphago_tpu_torch.
serve.sessions.ServePool.stage_params`), assigns a fraction of new
gateway sessions to it (:meth:`CanaryController.assign`: the session
pins the staged version), accumulates live-game outcomes per arm, and
decides on the Wilson 95% lower bound
(:func:`rocalphago_tpu_torch.interface.elo.wilson_lower_bound`) of the
candidate's decided-game win rate. At the game budget:

* lb >= 0.5 -- **promote**: the staged version becomes current (a
  pointer flip; in-flight searches finish on their pinned version);
* lb < 0.5 -- **rollback**: the staged version retires; sessions pinned
  to it fall back to the incumbent on their NEXT genmove (the
  evaluator's acquire fallback), so a bad canary never strands a game.
  The incumbent's play is untouched throughout.

Decisions, arm assignments and rollbacks land as ``canary`` events on
the metrics logger, and the per-arm record and the lower bound as the
reference's registry metrics. The lock is a plain ``threading`` lock.
"""

from __future__ import annotations

import threading

from rocalphago_tpu_torch.interface.elo import wilson_lower_bound
from rocalphago_tpu_torch.obs import registry as obs_registry

#: fraction of new sessions routed to the candidate
FRACTION = 0.1
#: decided candidate games before the gate decides
MIN_GAMES = 32


class CanaryController:
    """One candidate rollout over one pool (module docstring).

    ``pool`` needs the rollout surface
    (``stage_params``/``promote_version``/``discard_version``:
    :class:`~rocalphago_tpu_torch.serve.sessions.ServePool` or
    :class:`~rocalphago_tpu_torch.multisize.pool.MultiSizePool`).
    ``fraction``/``min_games`` default to :data:`FRACTION`/
    :data:`MIN_GAMES`. States:
    ``idle`` → :meth:`stage` → ``running`` → ``promoted`` |
    ``rolled_back``; a finished controller can :meth:`stage` again.
    """

    def __init__(self, pool, fraction: float | None = None,
                 min_games: int | None = None, metrics=None):
        self.pool = pool
        self.fraction = (FRACTION if fraction is None
                         else float(fraction))
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(
                f"canary fraction must be in (0, 1], "
                f"got {self.fraction}")
        self.min_games = (MIN_GAMES if min_games is None
                          else int(min_games))
        self.metrics = metrics
        self._lock = threading.Lock()
        # everything below guarded-by: self._lock
        self.state = "idle"
        self.candidate_version: int | None = None
        self.incumbent_version: int | None = None
        self._acc = 0.0               # fractional-assignment carry
        self._assigned = {"candidate": 0, "incumbent": 0}
        self._wins = {"candidate": 0, "incumbent": 0}
        self._losses = {"candidate": 0, "incumbent": 0}
        self.wilson_lb: float | None = None
        self.promotions = 0
        self.rollbacks = 0
        self._lb_g = obs_registry.gauge("rollout_canary_lb")
        self._rb_c = obs_registry.counter(
            "rollout_canary_rollbacks_total")
        self._pr_c = obs_registry.counter(
            "rollout_canary_promotions_total")

    def _emit(self, phase: str, **fields) -> None:
        if self.metrics is not None:
            self.metrics.log("canary", phase=phase, **fields)

    # ---------------------------------------------------------- flow

    def stage(self, params_p, params_v,
              version: int | None = None) -> int:
        """Stage the candidate pair on the pool and start routing a
        slice of new sessions to it. Returns the staged version."""
        with self._lock:
            if self.state == "running":
                raise RuntimeError(
                    f"a canary (version {self.candidate_version}) "
                    "is already running")
        # pool calls outside the controller lock (no lock nesting);
        # one controller drives one pool -- no concurrent stage race
        incumbent = self.pool.params_version
        v = self.pool.stage_params(params_p, params_v,
                                   version=version)
        with self._lock:
            self.state = "running"
            self.candidate_version = v
            self.incumbent_version = incumbent
            self._acc = 0.0
            self._assigned = {"candidate": 0, "incumbent": 0}
            self._wins = {"candidate": 0, "incumbent": 0}
            self._losses = {"candidate": 0, "incumbent": 0}
            self.wilson_lb = None
        self._emit("stage", candidate=v, incumbent=incumbent,
                   fraction=self.fraction, min_games=self.min_games)
        return v

    def assign(self) -> int | None:
        """Arm a NEW session: the candidate's staged version for a
        ``fraction`` slice (fractional accumulator -- exact share,
        no rng), None (= incumbent / current pointer) otherwise."""
        with self._lock:
            if self.state != "running":
                return None
            self._acc += self.fraction
            if self._acc >= 1.0:
                self._acc -= 1.0
                self._assigned["candidate"] += 1
                v = self.candidate_version
            else:
                self._assigned["incumbent"] += 1
                v = None
        obs_registry.counter(
            "rollout_canary_assigned_total",
            arm="candidate" if v is not None else "incumbent").inc()
        return v

    def record(self, arm: str, won: bool) -> str:
        """One decided game's outcome for ``arm`` (``"candidate"`` /
        ``"incumbent"``); draws are simply not recorded. Returns the
        controller state after the gate had its chance to decide."""
        if arm not in ("candidate", "incumbent"):
            raise ValueError(f"unknown canary arm {arm!r}")
        decide = None
        with self._lock:
            if self.state != "running":
                return self.state
            (self._wins if won else self._losses)[arm] += 1
            wins = self._wins["candidate"]
            decided = wins + self._losses["candidate"]
            lb = wilson_lower_bound(wins, decided)
            self.wilson_lb = lb
            if decided >= self.min_games:
                decide = "promote" if lb >= 0.5 else "rollback"
        obs_registry.counter("rollout_canary_games_total",
                             arm=arm).inc()
        self._lb_g.set(lb)
        self._emit("record", arm=arm, won=bool(won),
                   wilson_lb=round(lb, 4), decided=decided)
        if decide == "promote":
            self.promote()
        elif decide == "rollback":
            self.rollback()
        return self.state

    def promote(self) -> None:
        """Full rollout: the candidate becomes current everywhere."""
        with self._lock:
            if self.state != "running":
                return
            v = self.candidate_version
            self.state = "promoted"
            self.promotions += 1
            lb = self.wilson_lb
        self.pool.promote_version(v)
        self._pr_c.inc()
        self._emit("promote", candidate=v,
                   wilson_lb=None if lb is None else round(lb, 4))

    def rollback(self, reason: str = "wilson_lb") -> None:
        """Instant rollback: retire the staged version; canary-armed
        sessions fall back to the incumbent on their next genmove."""
        with self._lock:
            if self.state != "running":
                return
            v = self.candidate_version
            self.state = "rolled_back"
            self.rollbacks += 1
            lb = self.wilson_lb
        self.pool.discard_version(v)
        self._rb_c.inc()
        self._emit("rollback", candidate=v, reason=reason,
                   wilson_lb=None if lb is None else round(lb, 4))

    # --------------------------------------------------------- stats

    def stats(self) -> dict:
        """The probes' ``canary`` block (the reference's schema)."""
        with self._lock:
            return {
                "state": self.state,
                "fraction": self.fraction,
                "min_games": self.min_games,
                "candidate_version": self.candidate_version,
                "incumbent_version": self.incumbent_version,
                "assigned": {
                    "candidate": self._assigned["candidate"],
                    "incumbent": self._assigned["incumbent"],
                },
                "games": {
                    "candidate_wins": self._wins["candidate"],
                    "candidate_losses": self._losses["candidate"],
                    "incumbent_wins": self._wins["incumbent"],
                    "incumbent_losses": self._losses["incumbent"],
                },
                "wilson_lb": (None if self.wilson_lb is None
                              else round(self.wilson_lb, 4)),
                "promotions": self.promotions,
                "rollbacks": self.rollbacks,
            }
