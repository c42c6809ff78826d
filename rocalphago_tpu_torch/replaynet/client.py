"""Replay client: reconnecting transport plus the degraded-mode WAL.

The port of the reference package's ``replaynet/client.py``; its frames,
spool files and acked ledger are the reference's, so a spool written by
either package's client flushes from the other's. Three layers,
innermost first:

* :class:`ReplayConn` -- one raw connection: blocking request/response
  correlated by ``id``; typed refusals surface as
  :class:`ReplayRefused` (carrying the server's ``retry_after_s``), a
  drop as :class:`ReplayClosed`, both names the shared
  :func:`rocalphago_tpu_torch.net.client.default_transient` classifier
  recognizes.
* :class:`ReplayClient` -- the actor-side handle. With a ``spool_dir``,
  every finished game is first written to a local crash-safe WAL
  (atomic tmp+fsync+rename, one ``game.<n>.json`` per record), and
  only then shipped. While the service is unreachable the actor keeps
  playing and spooling (degraded mode); on reconnect the spool
  re-ships strictly head to tail. An ack appends the ``game_id`` to
  ``acked.jsonl`` BEFORE the spool file is unlinked, so every crash
  window leaves the spool file, the acked line, or both, and the
  server's dedup window collapses whichever re-ship that implies:
  ``produced = acked ∪ still-spooled`` is exact.
* :class:`RemoteReplayBuffer` -- the learner-side adapter: the
  ``next_batch``/``sample`` surface of :class:`~rocalphago_tpu_torch.
  data.replay.ReplayBuffer`, backed by wire requests with reconnect.
  Retrying a ``next_batch`` whose reply was lost is safe by server
  construction (the popped entry requeues on send failure).

The module touches no device and imports no torch.
"""

from __future__ import annotations

import glob
import json
import os
import socket
import time

from rocalphago_tpu_torch.data import replay
from rocalphago_tpu_torch.net import client as net_client
from rocalphago_tpu_torch.obs import registry as obs_registry
from rocalphago_tpu_torch.replaynet import protocol
from rocalphago_tpu_torch.runtime import atomic


class ReplayError(Exception):
    """A typed error frame; ``code`` is one of
    :data:`~rocalphago_tpu_torch.replaynet.protocol.ERROR_CODES`."""

    def __init__(self, code: str, msg: str,
                 retry_after_s: float | None = None):
        super().__init__(f"{code}: {msg}")
        self.code = code
        self.retry_after_s = retry_after_s


class ReplayRefused(ReplayError):
    """The service shed (``overload``/``draining``) -- back off at
    least ``retry_after_s`` and retry (or keep spooling)."""


class ReplayClosed(Exception):
    """The connection dropped mid-conversation (kill, drain nudge,
    service restart)."""


_REFUSAL_CODES = ("overload", "draining")


def _raise_error(frame: dict) -> None:
    code = frame.get("code", "internal")
    msg = frame.get("msg", "")
    retry = frame.get("retry_after_s")
    if code in _REFUSAL_CODES:
        raise ReplayRefused(code, msg, retry_after_s=retry)
    raise ReplayError(code, msg, retry_after_s=retry)


class ReplayConn:
    """One wire connection to a replay service.

    Connecting reads the server's ``hello`` (protocol version,
    record schema, buffer capacity) -- or raises
    :class:`ReplayRefused` when the service sheds at accept.
    """

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self._reader = self.sock.makefile("rb")
        self._next_id = 0
        self.hello = self._recv()
        if self.hello.get("type") == "error":
            self.close()
            _raise_error(self.hello)
        self.capacity = self.hello.get("capacity")

    def _recv(self) -> dict:
        try:
            frame = protocol.read_frame(self._reader)
        except protocol.ProtocolError as e:
            raise ReplayClosed(f"unreadable frame: {e}")
        if frame is None:
            raise ReplayClosed("connection closed by service")
        return frame

    def request(self, msg: dict) -> dict:
        """Send one frame, return its (id-matched) reply. Typed
        errors raise; a ``goodbye`` or stray frame is
        :class:`ReplayClosed`."""
        self._next_id += 1
        msg = dict(msg, id=self._next_id)
        try:
            self.sock.sendall(protocol.encode_frame(msg))
        except OSError:
            raise ReplayClosed("send failed: connection closed")
        reply = self._recv()
        if reply.get("type") == "goodbye":
            raise ReplayClosed(
                f"service said goodbye ({reply.get('reason', '?')})")
        if reply.get("id") != self._next_id:
            raise ReplayClosed(f"unexpected frame {reply!r}")
        if reply.get("type") == "error":
            _raise_error(reply)
        return reply

    def settimeout(self, timeout: float) -> None:
        self.sock.settimeout(timeout)

    def close(self) -> None:
        # the makefile reader holds the fd: close it too or the
        # server side never sees the FIN (same rule as the gateway)
        try:
            self._reader.close()
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


#: spool WAL filename pattern (index preserves ship order)
_SPOOL_GLOB = "game.*.json"
#: append-only ledger of acked game ids (the durable half of the
#: produced set; the spool is the other half)
_ACKED_FILE = "acked.jsonl"


class ReplayClient:
    """Actor-side handle: spool-first shipping with reconnect.

    Without a ``spool_dir`` the client is a plain reliable sender
    (ship with backoff, raise after the attempt budget). With one,
    :meth:`put_games` NEVER raises on service unavailability -- the
    game is already durable in the WAL when shipping starts, and a
    failed flush just leaves it (and everything behind it) spooled
    for the next :meth:`flush`. ``sleep`` is injectable so tests
    assert the backoff schedule instead of waiting it out.
    """

    def __init__(self, host: str, port: int, *,
                 spool_dir: str | None = None, timeout: float = 30.0,
                 attempts: int = 6, base_delay: float = 0.25,
                 max_delay: float = 5.0, seed: int = 0,
                 sleep=time.sleep):
        self.host = host
        self.port = port
        self.spool_dir = spool_dir
        self.timeout = float(timeout)
        self.attempts = int(attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.seed = int(seed)
        self._sleep = sleep
        self._conn: ReplayConn | None = None
        self._connected_once = False
        self.reconnects = 0
        self.shipped = 0
        self.shipped_games = 0
        self.dup_acks = 0
        self.degraded = False
        self._acked: set[str] = set()
        self._spool_next = 0
        if spool_dir:
            os.makedirs(spool_dir, exist_ok=True)
            self._acked = set(self._read_acked())
            indices = [self._spool_index(p)
                       for p in self._spool_paths()]
            self._spool_next = max(indices, default=-1) + 1

    # --------------------------------------------------------- wire

    def _ensure_conn(self) -> ReplayConn:
        if self._conn is None:
            self._conn = ReplayConn(self.host, self.port,
                                    timeout=self.timeout)
            if self._connected_once:
                self.reconnects += 1
                obs_registry.counter(
                    "replaynet_reconnects_total").inc()
            self._connected_once = True
        return self._conn

    def _drop_conn(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _request(self, msg: dict, *, key: str,
                 timeout: float | None = None) -> dict:
        """One request with the shared reconnect/backoff loop: a
        drop reconnects, a refusal sleeps at least the server's
        ``retry_after_s``; the final attempt's exception
        propagates."""

        def attempt():
            conn = self._ensure_conn()
            if timeout is not None:
                conn.settimeout(timeout)
            try:
                return conn.request(msg)
            except (ReplayClosed, OSError):
                self._drop_conn()
                raise

        def transient(e):
            # a typed ``internal`` is the server's fault wall talking
            # (an injected transient, or a kill that aborted the
            # connection): the request had no durable effect -- it is
            # exactly the retry the dedup window exists to absorb
            return (net_client.default_transient(e)
                    or (isinstance(e, ReplayError)
                        and e.code == "internal"))

        return net_client.call_with_backoff(
            attempt, attempts=self.attempts,
            base_delay=self.base_delay, max_delay=self.max_delay,
            seed=self.seed, key=key, transient=transient,
            sleep=self._sleep)

    # -------------------------------------------------------- spool

    def _spool_paths(self) -> list[str]:
        return sorted(glob.glob(os.path.join(self.spool_dir,
                                             _SPOOL_GLOB)))

    @staticmethod
    def _spool_index(path: str) -> int:
        try:
            return int(os.path.basename(path).split(".")[1])
        except (IndexError, ValueError):
            return -1

    def _read_acked(self) -> list[str]:
        path = os.path.join(self.spool_dir, _ACKED_FILE)
        ids = []
        try:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if line:
                        ids.append(line)
        except OSError:
            pass
        return ids

    def _append_acked(self, gid: str) -> None:
        path = os.path.join(self.spool_dir, _ACKED_FILE)
        with open(path, "a", encoding="utf-8") as f:
            f.write(gid + "\n")
        self._acked.add(gid)

    @property
    def spool_depth(self) -> int:
        """Unshipped games waiting in the WAL (0 without a spool)."""
        return len(self._spool_paths()) if self.spool_dir else 0

    def produced_ids(self) -> set[str]:
        """Every game id this actor has DURABLY produced: acked ∪
        still-spooled. Exact across any crash window -- a game is in
        the WAL before its first ship, its id is in the ledger
        before the WAL entry is unlinked, and the ambiguous overlap
        (both present) is what the server dedups."""
        ids = set(self._acked)
        for path in self._spool_paths():
            try:
                with open(path, encoding="utf-8") as f:
                    gid = json.load(f).get("game_id")
                if gid:
                    ids.add(str(gid))
            except (OSError, ValueError):
                continue
        return ids

    # --------------------------------------------------------- puts

    def put_games(self, games: replay.ZeroGames,
                  version: int = 0) -> str:
        """Durably hand off one finished batch; returns its
        ``game_id``.

        Spool mode: WAL-write first (the game is safe the moment
        this returns), then best-effort :meth:`flush` -- service
        down means ``degraded`` flips True and the game waits.
        Direct mode (no spool): ship with backoff, raising the
        final attempt's exception."""
        gid = replay.compute_game_id(games)
        rec = replay.games_to_record(games, version=version,
                                     game_id=gid)
        if not self.spool_dir:
            self._ship(rec)
            return gid
        atomic.atomic_write_json(
            os.path.join(self.spool_dir,
                         f"game.{self._spool_next:08d}.json"),
            rec, indent=None)
        self._spool_next += 1
        self.flush(best_effort=True)
        return gid

    def _ship(self, rec: dict) -> dict:
        reply = self._request({"type": "put_games", "record": rec},
                              key="replaynet.put")
        self.shipped += 1
        if reply.get("dup"):
            self.dup_acks += 1
        else:
            self.shipped_games += len(rec.get("winners", ()))
            obs_registry.counter(
                "replaynet_shipped_games_total").inc(
                len(rec.get("winners", ())))
        return reply

    def flush(self, best_effort: bool = False) -> int:
        """Re-ship the spool strictly head-to-tail; returns games
        shipped this call.

        Order is the FIFO guarantee: nothing at index n+1 ships
        before index n is acked (or known-acked from the ledger).
        ``best_effort`` swallows the transport failure after the
        backoff budget -- degraded mode -- leaving the tail spooled;
        otherwise the exception propagates with the spool intact.
        """
        if not self.spool_dir:
            return 0
        shipped = 0
        try:
            for path in self._spool_paths():
                try:
                    with open(path, encoding="utf-8") as f:
                        rec = json.load(f)
                    gid = str(rec.get("game_id", ""))
                except (OSError, ValueError):
                    # torn/unreadable WAL entry: can't have been
                    # produced (writes are atomic) -- drop it
                    os.unlink(path)
                    continue
                if gid and gid in self._acked:
                    # crashed between ledger append and unlink:
                    # already durable server-side
                    os.unlink(path)
                    continue
                self._ship(rec)
                if gid:
                    self._append_acked(gid)
                os.unlink(path)
                shipped += 1
            self.degraded = False
        except (ReplayError, ReplayClosed, OSError):
            self.degraded = True
            if not best_effort:
                raise
        finally:
            obs_registry.gauge("replaynet_spool_depth").set(
                self.spool_depth)
        return shipped

    # --------------------------------------------------------- take

    def next_batch(self, timeout_s: float = 0.0) -> dict | None:
        """One ``next_batch`` request: the raw ``batch`` frame, or
        None when the server answered ``empty``. Reconnects under
        the shared backoff; safe to retry (a popped entry whose
        reply was lost requeues server-side)."""
        reply = self._request(
            {"type": "next_batch", "timeout_s": float(timeout_s)},
            key="replaynet.take",
            timeout=self.timeout + float(timeout_s))
        if reply.get("type") == "empty":
            return None
        return reply

    def stats(self) -> dict:
        return self._request({"type": "stats"},
                             key="replaynet.stats")["replaynet"]

    def close(self) -> None:
        self._drop_conn()

    def __enter__(self) -> "ReplayClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RemoteReplayBuffer:
    """The learner's buffer surface over the wire.

    Duck-types the consumer half of :class:`~rocalphago_tpu_torch.data.
    replay.ReplayBuffer` (``next_batch``/``sample`` returning
    :class:`~rocalphago_tpu_torch.data.replay.ReplayEntry` or None) so
    ``ZeroLearner`` runs unchanged against a remote service
    (``run_training --replay-connect`` wires this in). ``sample``
    aliases ``next_batch``: the service owns the FIFO; recency
    sampling stays a server-side concern.
    """

    def __init__(self, client: ReplayClient):
        self.client = client
        self._closed = False

    def next_batch(self, timeout: float | None = None) \
            -> replay.ReplayEntry | None:
        if self._closed:
            return None
        try:
            reply = self.client.next_batch(
                timeout_s=0.0 if timeout is None else float(timeout))
        except (ReplayError, ReplayClosed, OSError):
            # service unreachable past the backoff budget: to the
            # learner that's indistinguishable from (and handled
            # like) an empty buffer -- idle a beat and re-ask
            return None
        if reply is None:
            return None
        games, version = replay.record_to_games(reply["record"])
        return replay.ReplayEntry(int(reply.get("seq", 0)), version,
                                  games, time.monotonic())

    def sample(self, timeout: float | None = None) \
            -> replay.ReplayEntry | None:
        return self.next_batch(timeout=timeout)

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True
        self.client.close()
