"""The learner: replay updates at their own cadence. The port of
``training/learner.py``.

:class:`ZeroLearner` wraps ``iteration.learn`` (the replay and update
half of :class:`~.zero.ZeroIteration`) and takes batches from the
replay buffer FIFO (:meth:`~..data.replay.ReplayBuffer.next_batch`,
the bit-exact lockstep path) or by prioritised-recency
:meth:`~..data.replay.ReplayBuffer.sample`. A step is retried on
transient failures: ``learn`` zeroes the gradients at its start and
changes the state only at its end.

``idle_frac`` -- the learner's wait for games over its wall time -- is
the number the actor/learner split exists to push down; the registry
carries it as ``learner_idle_frac``, beside ``learner_steps_total`` and
``learner_wait_seconds``. A step runs in the span ``learner.step``
(tagged with the batch's params version), after the fault barrier of
the same name, where the batch is already taken.
"""

from __future__ import annotations

import time

from rocalphago_tpu_torch.obs import registry, trace
from rocalphago_tpu_torch.runtime import faults, retries


class ZeroLearner:
    """``step(state)``: take one batch from the buffer, run one update,
    account the wait. No thread of its own: the training loop drives
    it."""

    def __init__(self, learn_fn, buffer, *, sample: bool = False,
                 gang=None, metrics=None, retry_attempts: int = 3):
        self._learn_fn = learn_fn
        self._buffer = buffer
        self._sample = sample
        # the DispatchGang shared with the actors: each step's dispatch
        # and metrics read run as one device section
        self._gang = gang
        self._metrics = metrics
        self._retry_attempts = retry_attempts
        self._wait_s = 0.0
        self._busy_s = 0.0
        self.steps = 0

    @property
    def idle_frac(self) -> float:
        """Share of the learner's wall time spent waiting for games."""
        total = self._wait_s + self._busy_s
        return self._wait_s / total if total > 0 else 0.0

    def step(self, state, timeout: float | None = None):
        """One update: ``(new_state, metrics, entry)``, the metrics as
        host floats (their read is the sync, so the busy time is the
        card's), or None when the buffer timed out or closed empty. The
        metrics gain ``replay_version`` (the snapshot that played the
        batch) and ``replay_staleness_s``."""
        from rocalphago_tpu_torch.training.zero import metrics_to_host

        t0 = time.monotonic()
        entry = (self._buffer.sample(timeout) if self._sample
                 else self._buffer.next_batch(timeout))
        t1 = time.monotonic()
        if entry is None:
            self._wait_s += t1 - t0
            registry.gauge("learner_idle_frac").set(self.idle_frac)
            return None
        # a kill here finds the batch taken: the consumed but unlearned
        # entry the failover path must ride out
        faults.barrier("learner.step", iteration=self.steps)

        def _learn_synced():
            new_state, m = retries.retry_call(
                self._learn_fn, state, entry.games,
                _retry_kwargs=dict(max_attempts=self._retry_attempts,
                                   logger=self._metrics))
            return new_state, metrics_to_host(m)

        with trace.span("learner.step", version=entry.version):
            new_state, m = (self._gang.run(_learn_synced) if self._gang
                            else _learn_synced())
        t2 = time.monotonic()
        self._wait_s += t1 - t0
        self._busy_s += t2 - t1
        self.steps += 1
        m["replay_version"] = entry.version
        m["replay_staleness_s"] = round(t1 - entry.t_ingest, 3)
        registry.counter("learner_steps_total").inc()
        registry.histogram("learner_wait_seconds").observe(t1 - t0)
        registry.gauge("learner_idle_frac").set(self.idle_frac)
        return new_state, m, entry
