"""Hot swap: promoted params under live sessions, no restart.

The port of the reference package's ``rollout/hotswap.py``. Installing
a new pair is a versioned pointer flip on the pool's
:class:`~rocalphago_tpu_torch.serve.evaluator.BatchingEvaluator`: the
port compiles nothing, live games keep playing, and every in-flight
genmove finishes on the version it pinned. The swap's work is one
working copy per net (its weights cast once to the working type), which
the pool's nets then point at (:meth:`~rocalphago_tpu_torch.serve.
sessions.ServePool.set_params`).

Two feeds drive the :class:`HotSwapper`:

* :class:`PublisherWatcher` -- in process: blocks on
  :meth:`~rocalphago_tpu_torch.training.actor.ParamsPublisher.
  wait_version` and applies each newly published snapshot (its
  modules' state dicts, which is what ``set_params`` takes);
* :class:`SpillWatcher` -- across processes: polls the ``rollout.json``
  spill pointer (written atomically, last, by ``ZeroGate.promote`` or
  ``ParamsPublisher(spill_dir=...)`` of either package), loads the Flax
  msgpack pair it names and applies it.

Both watchers are daemon threads with a bounded ``stop``; the poll
cadence defaults to :data:`POLL_S` (0.5 s, the reference's default).
The registry carries the reference's ``rollout_swaps_total``,
``rollout_params_version`` and ``rollout_swap_seconds``.
"""

from __future__ import annotations

import os
import struct
import threading
import time

from rocalphago_tpu_torch.obs import registry as obs_registry

#: watcher poll cadence in seconds
POLL_S = 0.5


def load_spill_params(spill_dir: str, spill: dict, policy_template=None,
                      value_template=None) -> tuple:
    """The pair a spill pointer names, as the state dicts
    ``ServePool.set_params`` takes. The templates (the serving nets'
    modules) are accepted for the reference's signature; the Flax tree
    carries its own shapes."""
    from rocalphago_tpu_torch.models.weights import (
        params_from_flax,
        read_flax_msgpack,
    )

    return tuple(
        params_from_flax(read_flax_msgpack(
            os.path.join(spill_dir, str(spill[key]))))
        for key in ("policy", "value"))


def _state_dict(params):
    """A published snapshot (a module) as its state dict; a state dict
    passes through."""
    return params.state_dict() if hasattr(params, "state_dict") else params


class HotSwapper:
    """Applies a params pair to one or more swap targets: anything with
    a ``set_params(params_p, params_v)`` surface
    (:class:`~rocalphago_tpu_torch.serve.sessions.ServePool`,
    :class:`~rocalphago_tpu_torch.multisize.pool.MultiSizePool`).

    ``version`` is the ROLLOUT version (the gate iteration or publisher
    version); the targets' evaluators allocate their own params versions.
    :attr:`version` is what fleet convergence checks compare."""

    def __init__(self, *targets, metrics=None):
        if not targets:
            raise ValueError("HotSwapper needs at least one target")
        self.targets = tuple(targets)
        self.metrics = metrics
        self.version = -1      # latest applied rollout version
        self.swaps = 0
        self._swap_c = obs_registry.counter("rollout_swaps_total")
        self._ver_g = obs_registry.gauge("rollout_params_version")
        self._swap_h = obs_registry.histogram("rollout_swap_seconds")

    def apply(self, params_p, params_v, version: int) -> None:
        """Swap every target to the pair."""
        t0 = time.monotonic()
        for target in self.targets:
            target.set_params(params_p, params_v)
        dt = time.monotonic() - t0
        self.version = int(version)
        self.swaps += 1
        self._swap_c.inc()
        self._ver_g.set(self.version)
        self._swap_h.observe(dt)
        if self.metrics is not None:
            self.metrics.log("rollout", phase="swap",
                             version=self.version,
                             targets=len(self.targets),
                             elapsed_s=round(dt, 6))


class _WatcherThread:
    """The daemon-thread skeleton of the two watchers."""

    def __init__(self, name: str, poll_s: float | None):
        self.poll_s = POLL_S if poll_s is None else float(poll_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self.poll_s)

    def poll_once(self) -> bool:
        raise NotImplementedError


class PublisherWatcher(_WatcherThread):
    """In-process feed: apply each newly published snapshot. The port's
    publisher holds modules, so the watcher passes their state dicts."""

    def __init__(self, publisher, swapper: HotSwapper,
                 poll_s: float | None = None):
        super().__init__("rollout-publisher-watch", poll_s)
        self.publisher = publisher
        self.swapper = swapper

    def poll_once(self) -> bool:
        got = self.publisher.wait_version(self.swapper.version + 1,
                                          timeout=self.poll_s)
        if got is None:
            return False
        version, pp, pv = got
        self.swapper.apply(_state_dict(pp), _state_dict(pv), version)
        return True

    def _loop(self) -> None:
        # wait_version already blocks up to poll_s: no extra sleep
        while not self._stop.is_set():
            self.poll_once()


class SpillWatcher(_WatcherThread):
    """Cross-process feed: follow the spill pointer.

    ``policy_template`` / ``value_template`` are kept for the
    reference's signature (the serving nets). A pointer naming files
    that are mid-replace or already pruned is skipped and retried next
    poll: the pointer is written last, so that window exists only for
    pruned history, never the latest pair."""

    def __init__(self, spill_dir: str, swapper: HotSwapper,
                 policy_template=None, value_template=None,
                 poll_s: float | None = None, metrics=None):
        super().__init__("rollout-spill-watch", poll_s)
        self.spill_dir = spill_dir
        self.swapper = swapper
        self.policy_template = policy_template
        self.value_template = value_template
        self.metrics = metrics

    def poll_once(self) -> bool:
        """One poll: apply the spill-pointed version when it is newer
        than what the swapper already serves. True when a swap
        happened."""
        from rocalphago_tpu_torch.training.actor import read_spill

        spill = read_spill(self.spill_dir)
        if spill is None:
            return False
        version = int(spill["version"])
        if version <= self.swapper.version:
            return False
        try:
            pp, pv = load_spill_params(
                self.spill_dir, spill, self.policy_template,
                self.value_template)
        except (OSError, ValueError, KeyError, IndexError,
                struct.error) as e:
            # torn window (pruned file, partial copy): skip, retry
            if self.metrics is not None:
                self.metrics.log("rollout", phase="spill_skip",
                                 version=version, error=str(e))
            return False
        self.swapper.apply(pp, pv, version)
        return True
