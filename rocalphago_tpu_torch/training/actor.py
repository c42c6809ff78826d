"""Self-play actors: paced producers feeding the replay buffer. The
port of ``training/actor.py``.

Each :class:`SelfplayActor` is a thread around ``iteration.play`` (the
self-play half of :class:`~.zero.ZeroIteration`) that repeatedly waits
for a params snapshot from the :class:`ParamsPublisher`, walks its own
generator chain with :func:`~.zero.next_keys`, plays one batch of
games and puts the host copy into the
:class:`~..data.replay.ReplayBuffer`.

Two pacing modes:

- **lockstep** (``lockstep=True``, one actor): game ``k`` waits for
  published version ``k``, and the chain starts from the trainer
  state's own; with a FIFO consumer this is the synchronous loop bit
  for bit;
- **free run**: actors play the latest snapshot; the buffer's pacing
  bounds the staleness.

Each game is retried on transient failures (``play`` changes nothing
the caller sees); any other failure parks the actor with ``error`` set,
which a :class:`~..runtime.supervisor.Supervisor` treats as a death
(:meth:`SelfplayActor.inject_fault` arms one at the next game; the
``actor.game`` fault barrier is hit before each game). Waits are
tagged ``actor:<name>`` in the watchdog's ``waiting_on`` registry. A
game plays in the span ``actor.play``; the registry counts
``actor_games_total{actor=}`` and the publisher sets
``actor_params_version``.

PyTorch specifics: grad mode is per thread, so ``play`` enters
``no_grad`` itself; the games draw only from the generators built from
the chain's game seed (never from a global generator); the cuDNN
settings are process-wide and set by the trainer before any thread
starts; and a :class:`DispatchGang` serialises the device sections of
the actor and learner threads.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib

from rocalphago_tpu_torch.data.replay import ZeroGames
from rocalphago_tpu_torch.obs import registry, trace
from rocalphago_tpu_torch.runtime import faults, retries, watchdog
from rocalphago_tpu_torch.training.zero import next_keys

#: wait slice for params and buffer waits (how fast a stop is seen)
POLL_S = 0.5

#: the rollout pointer a serving process watches: ``{"version",
#: "policy", "value"}`` beside the pair it names, replaced atomically
SPILL_NAME = "rollout.json"


def write_spill(dir_path: str, *, version: int, policy_path: str,
                value_path: str) -> str:
    """Atomically write ``dir_path/rollout.json`` naming the latest
    gated pair."""
    from rocalphago_tpu_torch.runtime.atomic import atomic_write_json

    path = os.path.join(dir_path, SPILL_NAME)
    atomic_write_json(path, {"version": int(version),
                             "policy": os.path.basename(policy_path),
                             "value": os.path.basename(value_path)})
    return path


def read_spill(dir_path: str) -> dict | None:
    """The current pointer, or None when absent or incomplete."""
    try:
        with open(os.path.join(dir_path, SPILL_NAME),
                  encoding="utf-8") as f:
            spill = json.load(f)
    except (OSError, ValueError):
        return None
    if not all(k in spill for k in ("version", "policy", "value")):
        return None
    return spill


def games_to_host(games: ZeroGames) -> ZeroGames:
    """A record's tensors as host numpy arrays (the buffer's form)."""
    return ZeroGames(*(None if x is None else x.cpu().numpy()
                       for x in games))


class DispatchGang:
    """Serialises whole device sections between threads sharing the
    card: one ``play`` or one learner step (dispatch to host read) at a
    time. What the split still buys is learner cadence decoupled from
    game cadence (sample mode) and host-side overlap (buffer and spill
    I/O run outside the gang).

    Over a sharded ``mesh`` the sections hold collectives, which the
    ranks must issue in one order. Rank 0 admits its sections as its
    threads arrive and broadcasts each one's ``name`` before running it
    (the ticket); every other rank receives the tickets in turn and
    runs the section of the thread the ticket names, so every rank runs
    the same sections in the same order. Every rank must therefore
    reach the same named sections; a ticket is received only while no
    section runs, so the tickets and the sections' collectives never
    interleave."""

    def __init__(self, mesh=None):
        self._lock = threading.Lock()
        self._mesh = mesh if mesh is not None and mesh.sharded else None
        self._cond = threading.Condition()
        self._ticket = None       # guarded-by: self._cond

    def run(self, fn, *args, name: str = "section", **kwargs):
        """Run ``fn``, a device section named ``name``, holding the
        gang."""
        if self._mesh is None:
            with self._lock:
                # the callback IS the protected resource (an atomic
                # device section), not a re-entrancy hazard: sections
                # never touch the gang from inside
                return fn(*args, **kwargs)  # jaxlint: disable=callback-under-lock
        import torch

        code = zlib.crc32(name.encode())
        if self._mesh.rank == 0:
            with self._lock:
                self._mesh.broadcast(torch.tensor(
                    [code], dtype=torch.int64, device=self._mesh.device))
                # as above: the section is what the gang protects
                return fn(*args, **kwargs)  # jaxlint: disable=callback-under-lock
        self._await_ticket(code)
        try:
            return fn(*args, **kwargs)
        finally:
            self._lock.release()

    def _await_ticket(self, code: int) -> None:
        """Return holding the lock once rank 0's next ticket is
        ``code`` (a rank other than 0)."""
        import torch

        while True:
            self._lock.acquire()
            with self._cond:
                ticket = self._ticket
            if ticket is None:
                # no section runs: receive rank 0's next ticket
                try:
                    ticket = int(self._mesh.broadcast(torch.zeros(
                        1, dtype=torch.int64, device=self._mesh.device)))
                except BaseException:
                    self._lock.release()
                    raise
            with self._cond:
                if ticket == code:
                    self._ticket = None
                    self._cond.notify_all()
                    return
                # another thread's turn: leave the ticket for it
                self._ticket = ticket
                self._lock.release()
                self._cond.notify_all()
                self._cond.wait_for(lambda: self._ticket != ticket,
                                    timeout=POLL_S)


class ParamsPublisher:
    """A versioned pair of nets actors wait on between games. The
    learner (or the gate, after a promotion) calls :meth:`publish` with
    snapshots (the trainer's own modules change in place); actors block
    in :meth:`wait_version`.

    With ``spill_dir`` set, every publish is also mirrored to disk as a
    Flax msgpack pair plus the ``rollout.json`` pointer, the reference's
    files, so a serving process of either package follows it
    (:class:`~rocalphago_tpu_torch.rollout.hotswap.SpillWatcher`)."""

    def __init__(self, spill_dir: str | None = None):
        self._cond = threading.Condition()
        self._version = -1     # guarded-by: self._cond
        self._policy = None    # guarded-by: self._cond
        self._value = None     # guarded-by: self._cond
        #: directory each publish is mirrored into (None: in process only)
        self.spill_dir = spill_dir

    def publish(self, policy, value, version: int | None = None) -> int:
        """Install a pair; bumps the version (or sets it: lockstep pins
        version = iteration)."""
        with self._cond:
            self._version = (self._version + 1 if version is None
                             else int(version))
            self._policy = policy
            self._value = value
            v = self._version
            self._cond.notify_all()
        registry.gauge("actor_params_version").set(v)
        if self.spill_dir is not None:
            self._spill(v, policy, value)
        return v

    def _spill(self, version: int, policy, value) -> None:
        """Mirror one publish to disk: the pair as Flax msgpack (host
        copies of the snapshots' weights), then the pointer flipped at
        it. Pointer-last ordering means a watcher that reads the pointer
        always finds both files; older pairs are pruned best-effort once
        the pointer has moved on."""
        from rocalphago_tpu_torch.models.weights import (
            params_to_flax,
            write_flax_msgpack,
        )

        d = self.spill_dir
        os.makedirs(d, exist_ok=True)
        ppath = os.path.join(d, f"spill.{version:05d}.policy.msgpack")
        vpath = os.path.join(d, f"spill.{version:05d}.value.msgpack")
        for path, net in ((ppath, policy), (vpath, value)):
            write_flax_msgpack(path, params_to_flax(net.state_dict()))
        write_spill(d, version=version, policy_path=ppath, value_path=vpath)
        for name in sorted(os.listdir(d)):
            if (name.startswith("spill.") and name.endswith(".msgpack")
                    and not name.startswith(f"spill.{version:05d}.")):
                try:
                    os.remove(os.path.join(d, name))
                except OSError:
                    pass  # a concurrent reader may hold it open

    def get(self):
        """The latest ``(version, policy, value)``; version -1 before the
        first publish."""
        with self._cond:
            return self._version, self._policy, self._value

    def wait_version(self, min_version: int,
                     timeout: float | None = None):
        """Block until a version ≥ ``min_version`` is published;
        ``(version, policy, value)``, or None on timeout."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cond:
            while self._version < min_version:
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    return None
                self._cond.wait(rem)
            return self._version, self._policy, self._value


class SelfplayActor:
    """A producer thread putting finished game batches into the replay
    buffer (the module docstring has the pacing modes).

    ``play_fn`` is ``iteration.play``; ``rng`` the generator-chain state
    the actor starts from (the trainer's own in lockstep, a
    :func:`~.zero.fold_in` branch otherwise); ``games`` bounds the
    batches it produces (None: until :meth:`stop`)."""

    def __init__(self, play_fn, publisher: ParamsPublisher, buffer,
                 rng, *, name: str = "actor0", lockstep: bool = False,
                 start_index: int = 0, games: int | None = None,
                 pace: bool = True, poll_s: float | None = None,
                 gang: DispatchGang | None = None, metrics=None,
                 on_progress=None):
        self._play_fn = play_fn
        self._gang = gang
        self._publisher = publisher
        self._buffer = buffer
        self._rng = rng
        self.name = name
        self.lockstep = lockstep
        self._start_index = start_index
        self._games = games
        self._pace = pace
        self._poll_s = POLL_S if poll_s is None else poll_s
        self._metrics = metrics
        self._on_progress = on_progress   # the supervisor's heartbeat
        self._inject: BaseException | None = None
        self.games_played = 0
        self.error: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"selfplay-{name}", daemon=True)

    def start(self) -> "SelfplayActor":
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    def alive(self) -> bool:
        return self._thread.is_alive()

    def inject_fault(self, exc: BaseException | None = None) -> None:
        """Arm a one-shot fault raised at this actor's next game
        boundary (default :class:`~..runtime.faults.InjectedKill`): the
        deterministic kill of one actor; schedules across a run go
        through :func:`~..runtime.faults.install`."""
        self._inject = exc if exc is not None else faults.InjectedKill(
            f"injected kill of {self.name} (inject_fault)")

    def _run(self) -> None:
        rng = self._rng
        index = self._start_index
        while not self._stop.is_set():
            if (self._games is not None
                    and index - self._start_index >= self._games):
                break
            # lockstep: game k is played by version k, the pair the
            # synchronous loop would use; free run: the freshest
            need = index if self.lockstep else 0
            with watchdog.waiting_on(f"actor:{self.name}"):
                got = self._publisher.wait_version(need, self._poll_s)
            if got is None:
                continue
            version, policy, value = got
            rng, game_seed = next_keys(rng)

            def _play_synced():
                # dispatch and host copy in one section: the card is
                # free again once the copy has waited for every launch
                games = retries.retry_call(
                    self._play_fn, policy, value, game_seed,
                    _retry_kwargs=dict(max_attempts=3, base_delay=0.5,
                                       logger=self._metrics))
                return games_to_host(games)

            try:
                faults.barrier("actor.game", iteration=index)
                if self._inject is not None:
                    exc, self._inject = self._inject, None
                    raise exc
                with trace.span("actor.play", actor=self.name,
                                game=index):
                    host = (self._gang.run(_play_synced,
                                           name=f"play:{self.name}")
                            if self._gang else _play_synced())
            except BaseException as e:  # noqa: BLE001 — park and report
                self.error = e
                if self._metrics is not None:
                    self._metrics.log("actor_error", actor=self.name,
                                      error=f"{type(e).__name__}: {e}")
                break
            while not self._stop.is_set():
                with watchdog.waiting_on(f"actor:{self.name}"):
                    accepted = self._buffer.put(
                        host, version=version, block=self._pace,
                        timeout=self._poll_s)
                if accepted:
                    registry.counter("actor_games_total",
                                     actor=self.name).inc()
                    self.games_played += 1
                    index += 1
                    if self._on_progress is not None:
                        self._on_progress()
                    break
                if self._buffer.closed:
                    self._stop.set()   # drained: park
                    break
