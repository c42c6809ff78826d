"""The replay service: a ReplayBuffer behind the wire, lossless.

The port of the reference package's ``replaynet/server.py``, with its
defaults and no environment knob (64 connections, a 10 s drain, a
4,096-id dedup window). :class:`ReplayService` fronts one
:class:`~rocalphago_tpu_torch.data.replay.ReplayBuffer` with the shared
:class:`~rocalphago_tpu_torch.net.server.LineServerCore` and the
replaynet protocol. A killed connection, a restarted service or a slow
learner may cost latency, never a game:

* **ack-after-accept**: the ``ok`` for a ``put_games`` is sent only
  after the buffer accepted the record (and, with a spill dir,
  atomically persisted it): an ack in hand means durable;
* **exactly-once via dedup**: every record carries its content-hash
  ``game_id``; a bounded id window (the newest ``dedup_window`` ids,
  rebuilt from the spill and ``dedup.json`` on restart) absorbs the
  retries at-least-once delivery implies, acking ``dup: true``
  without re-inserting;
* **lossless shedding**: a full buffer turns ``put_games`` into a
  typed ``overload`` refusal with ``retry_after_s`` (unless ``evict``
  asks for the sliding window of a sampling learner);
* **take-side requeue**: a popped ``next_batch`` entry whose reply
  cannot be sent goes back to the head of the FIFO and re-spills
  (:meth:`~rocalphago_tpu_torch.data.replay.ReplayBuffer.requeue`);
* **fault walls**: every request runs behind ``replay.conn``, the put
  path behind ``replay.put`` (before any side effect), the take path
  behind ``replay.take`` (before the pop). Injected transients fail
  the request with a typed ``internal``; kills abort the connection;
  nothing escapes the handler (``requests.unhandled`` counts any
  escape);
* **drain leaves the spill**: SIGTERM (through the supervisor in
  :func:`main`) stops the accept loop, finishes in-flight requests,
  joins every handler, persists the dedup window, and leaves every
  unconsumed entry spilled on disk for :meth:`ReplayService.recover`.

The service touches no device and imports no torch: the CLI takes no
``--device``. The lock is a plain ``threading`` lock; each attribute it
guards says so in a ``# guarded-by:`` comment.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time

from rocalphago_tpu_torch.data import replay
from rocalphago_tpu_torch.net.server import LineServerCore
from rocalphago_tpu_torch.obs import registry as obs_registry
from rocalphago_tpu_torch.replaynet import protocol
from rocalphago_tpu_torch.runtime import atomic, faults

#: connection cap, drain grace and dedup window: the reference's
#: defaults
MAX_CONNS = 64
DRAIN_S = 10.0
DEDUP_WINDOW = 4096

#: retry hint a shed/refused client receives (seconds)
RETRY_AFTER_S = 1.0

#: longest server-side wait one next_batch request may hold (the
#: client re-issues; bounding it keeps drain prompt)
_TAKE_CAP_S = 30.0

#: dedup-window snapshot filename (inside the spill dir)
_DEDUP_FILE = "dedup.json"


class ReplayService:
    """Threaded NDJSON replay front end (module docstring).

    Pass an existing ``buffer`` or let the service build one from
    ``capacity``/``spill_dir``. ``max_conns``/``drain_s``/
    ``dedup_window`` default to :data:`MAX_CONNS`/:data:`DRAIN_S`/
    :data:`DEDUP_WINDOW`; ``metrics`` gets the drain-phase events.
    """

    def __init__(self, buffer: replay.ReplayBuffer | None = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 capacity: int | None = None,
                 spill_dir: str | None = None,
                 max_conns: int | None = None,
                 drain_s: float | None = None,
                 dedup_window: int | None = None,
                 evict: bool = False, metrics=None):
        if buffer is None:
            buffer = replay.ReplayBuffer(capacity,
                                         spill_dir=spill_dir)
        self.buffer = buffer
        self.metrics = metrics
        self.max_conns = (MAX_CONNS if max_conns is None
                          else int(max_conns))
        self.drain_s = DRAIN_S if drain_s is None else float(drain_s)
        self.dedup_window = (DEDUP_WINDOW if dedup_window is None
                             else int(dedup_window))
        # sliding-window mode for sampling learners (which never pop
        # the FIFO): a full buffer evicts the oldest entry instead of
        # refusing. Lossless rigs keep the default refusal
        self.evict = bool(evict)
        self._max_frame = protocol.max_frame_bytes()
        self._lock = threading.Lock()
        self._dedup: dict = {}       # guarded-by: self._lock
        self._requests = 0           # guarded-by: self._lock
        self._errors = 0             # guarded-by: self._lock
        self._unhandled = 0          # guarded-by: self._lock
        self._puts = 0               # guarded-by: self._lock
        self._put_games = 0          # guarded-by: self._lock
        self._dup_hits = 0           # guarded-by: self._lock
        self._refused = 0            # guarded-by: self._lock
        self._takes = 0              # guarded-by: self._lock
        self._empties = 0            # guarded-by: self._lock
        self._requeued = 0           # guarded-by: self._lock
        self._faults = 0             # guarded-by: self._lock
        self._kills = 0              # guarded-by: self._lock
        self._put_kills = 0          # guarded-by: self._lock
        self._take_kills = 0         # guarded-by: self._lock
        self._conn_kills = 0         # guarded-by: self._lock
        self._put_attempts = 0       # guarded-by: self._lock
        self._take_attempts = 0      # guarded-by: self._lock
        self._closed = False
        self._live_g = obs_registry.gauge("replaynet_conns_live")
        self._acc_c = obs_registry.counter(
            "replaynet_connections_total", result="accepted")
        self._shed_c = obs_registry.counter(
            "replaynet_connections_total", result="shed")
        self._core = LineServerCore(
            host=host, port=port, max_conns=self.max_conns,
            drain_s=self.drain_s, handler=self._handle,
            refusal=self._refusal_frame, name="replaynet",
            metrics=metrics, live_gauge=self._live_g,
            accepted_counter=self._acc_c, shed_counter=self._shed_c)

    # ------------------------------------------------------ lifecycle

    def recover(self) -> int:
        """Restore the previous incarnation's durable state BEFORE
        serving: the dedup window (``dedup.json`` + the ids of every
        spilled record -- so an ack lost in the old incarnation's
        last moments still dedups) and the spilled entries
        themselves. Returns the number of restored entries."""
        if not self.buffer.spill_dir:
            return 0
        ids: list[str] = []
        dedup_path = os.path.join(self.buffer.spill_dir, _DEDUP_FILE)
        try:
            with open(dedup_path, encoding="utf-8") as f:
                ids.extend(str(g) for g in json.load(f))
        except (OSError, ValueError):
            pass
        for path in sorted(glob.glob(os.path.join(
                self.buffer.spill_dir, "entry.*.json"))):
            try:
                with open(path, encoding="utf-8") as f:
                    gid = json.load(f).get("game_id")
                if gid:
                    ids.append(str(gid))
            except (OSError, ValueError):
                continue
        with self._lock:
            for gid in ids:
                self._dedup[gid] = None
            while len(self._dedup) > self.dedup_window:
                self._dedup.pop(next(iter(self._dedup)))
        return self.buffer.restore()

    def start(self) -> "ReplayService":
        self._core.start()
        return self

    @property
    def port(self) -> int:
        return self._core.port

    @property
    def draining(self) -> bool:
        return self._core.draining

    def drain(self, reason: str = "requested",
              timeout: float | None = None) -> None:
        """Graceful stop: refuse new work, finish in-flight
        requests, quiesce every thread, persist the dedup window --
        and leave every unconsumed entry spilled for
        :meth:`recover`. Idempotent; bounded by ``timeout``."""
        self._core.drain(reason=reason, timeout=timeout)
        if self.buffer.spill_dir:
            with self._lock:
                ids = list(self._dedup)
            atomic.atomic_write_json(
                os.path.join(self.buffer.spill_dir, _DEDUP_FILE),
                ids, indent=None)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.drain(reason="close")
        self.buffer.close()

    def __enter__(self) -> "ReplayService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------- handler

    def _refusal_frame(self, code: str) -> dict:
        """At-accept shed (``overload``/``draining``): the typed
        refusal the core sends before closing the connection."""
        self._count_error(code)
        return protocol.error_frame(
            code,
            f"replaynet {code}: {self.max_conns} connections live",
            retry_after_s=RETRY_AFTER_S)

    def _count_error(self, code: str) -> None:
        obs_registry.counter("replaynet_errors_total",
                             code=code).inc()
        with self._lock:
            self._errors += 1

    def _handle(self, conn, reader, cid: int) -> None:
        if not self._core.send(conn,
                               protocol.hello_frame(
                                   self.buffer.capacity)):
            return
        n = 0
        while True:
            if self._core.draining:
                self._core.send(conn, {"type": "goodbye",
                                       "reason": "draining"})
                break
            try:
                msg = protocol.read_frame(reader, self._max_frame)
            except protocol.ProtocolError as e:
                self._count_error(e.code)
                self._core.send(conn,
                                protocol.error_frame(e.code, str(e)))
                if e.fatal:
                    break
                continue
            if msg is None:
                break                  # disconnect / torn frame
            n += 1
            with self._lock:
                self._requests += 1
            obs_registry.counter("replaynet_requests_total",
                                 type=str(msg.get("type"))).inc()
            rid = msg.get("id")
            # the per-request fault wall: a transient fails this
            # request, a kill this connection -- never the server, and
            # never a game (no side effect has happened yet)
            try:
                faults.barrier("replay.conn", iteration=n)
            except faults.InjectedKill as e:
                with self._lock:
                    self._kills += 1
                    self._conn_kills += 1
                obs_registry.counter("replaynet_faults_total",
                                     kind="kill").inc()
                self._core.send(conn, protocol.error_frame(
                    "internal", f"connection aborted: {e}", id=rid))
                break
            except Exception as e:  # noqa: BLE001 -- injected
                with self._lock:
                    self._faults += 1
                obs_registry.counter("replaynet_faults_total",
                                     kind="fault").inc()
                self._count_error("internal")
                self._core.send(conn, protocol.error_frame(
                    "internal", f"transient fault: {e}", id=rid))
                continue
            popped = None
            try:
                reply, popped = self._dispatch(msg)
            except _ConnAbort as e:
                self._core.send(conn, protocol.error_frame(
                    "internal", f"connection aborted: {e}", id=rid))
                break
            except Exception as e:  # noqa: BLE001 -- fault wall: the
                #   connection must answer, the service live on
                with self._lock:
                    self._unhandled += 1
                self._count_error("internal")
                reply = protocol.error_frame(
                    "internal", f"{type(e).__name__}: {e}", id=rid)
            if reply is not None and not self._core.send(conn, reply):
                # peer died mid-response: a popped entry goes back
                # to the head of the FIFO (and back to the spill) --
                # the failed delivery costs nothing
                if popped is not None and self.buffer.requeue(popped):
                    with self._lock:
                        self._requeued += 1
                break

    # ------------------------------------------------------ dispatch

    def _dispatch(self, msg: dict):
        """One request → (reply frame, popped entry or None).
        Refusals are typed error frames; only genuine bugs raise
        (counted unhandled)."""
        rid = msg.get("id")
        mtype = msg.get("type")
        if mtype == "hello":
            proto = msg.get("proto", protocol.PROTO_VERSION)
            if proto != protocol.PROTO_VERSION:
                self._count_error("bad_proto")
                return protocol.error_frame(
                    "bad_proto",
                    f"server speaks proto {protocol.PROTO_VERSION}, "
                    f"client pinned {proto}", id=rid), None
            return {"type": "ok", "id": rid,
                    "proto": protocol.PROTO_VERSION}, None
        if mtype == "put_games":
            return self._put(msg), None
        if mtype == "next_batch":
            return self._take(msg)
        if mtype == "stats":
            return {"type": "stats", "id": rid,
                    "replaynet": self.stats()}, None
        self._count_error("unknown_type")
        return protocol.error_frame(
            "unknown_type", f"unknown message type {mtype!r}",
            id=rid), None

    def _put(self, msg: dict) -> dict:
        rid = msg.get("id")
        rec = msg.get("record")
        # client fields parse BEFORE any side effect: a malformed
        # record is a typed refusal, never a half-ingested game
        if not isinstance(rec, dict):
            self._count_error("bad_request")
            return protocol.error_frame(
                "bad_request", "put_games needs a 'record' object",
                id=rid)
        try:
            games, version = replay.record_to_games(rec)
            gid = replay.record_game_id(rec, games)
        except replay.UnknownSchemaError as e:
            self._count_error("bad_schema")
            return protocol.error_frame("bad_schema", str(e), id=rid)
        except (ValueError, KeyError, TypeError) as e:
            self._count_error("bad_request")
            return protocol.error_frame(
                "bad_request", f"unparseable record: {e}", id=rid)
        with self._lock:
            self._put_attempts += 1
            it = self._put_attempts
        # the put fault wall: a kill lands BEFORE the buffer accept,
        # so the client holds no ack, re-ships, and the dedup window
        # makes the retry exactly-once
        try:
            faults.barrier("replay.put", iteration=it)
        except faults.InjectedKill as e:
            with self._lock:
                self._kills += 1
                self._put_kills += 1
            obs_registry.counter("replaynet_faults_total",
                                 kind="kill").inc()
            raise _ConnAbort(str(e))
        except Exception as e:  # noqa: BLE001 -- injected
            with self._lock:
                self._faults += 1
            obs_registry.counter("replaynet_faults_total",
                                 kind="fault").inc()
            self._count_error("internal")
            return protocol.error_frame(
                "internal", f"transient fault: {e}", id=rid)
        if self._core.draining:
            self._count_error("draining")
            return protocol.error_frame(
                "draining", "service is draining", id=rid,
                retry_after_s=RETRY_AFTER_S)
        with self._lock:
            if gid in self._dedup:
                self._dup_hits += 1
                dup = True
            else:
                self._dedup[gid] = None
                while len(self._dedup) > self.dedup_window:
                    self._dedup.pop(next(iter(self._dedup)))
                dup = False
        if dup:
            obs_registry.counter("replaynet_dedup_hits_total").inc()
            return {"type": "ok", "id": rid, "game_id": gid,
                    "dup": True}
        # default mode never evicts: a full buffer is a structured
        # refusal, not a silent drop of the oldest game
        if not self.buffer.put(games, version=version, block=False,
                               evict=self.evict):
            with self._lock:
                self._dedup.pop(gid, None)
                self._refused += 1
            code = ("draining" if self.buffer.closed else "overload")
            self._count_error(code)
            return protocol.error_frame(
                code, f"buffer full ({self.buffer.capacity} entries)"
                if code == "overload" else "buffer closed",
                id=rid, retry_after_s=RETRY_AFTER_S)
        n_games = int(games.winners.shape[0])
        with self._lock:
            self._puts += 1
            self._put_games += n_games
        obs_registry.counter("replaynet_ingest_games_total").inc(
            n_games)
        # the ack: sent by the caller only now, AFTER accept+spill
        return {"type": "ok", "id": rid, "game_id": gid,
                "dup": False}

    def _take(self, msg: dict):
        rid = msg.get("id")
        try:
            timeout_s = float(msg.get("timeout_s", 0.0))
        except (TypeError, ValueError) as e:
            self._count_error("bad_request")
            return protocol.error_frame(
                "bad_request", f"unparseable timeout_s: {e}",
                id=rid), None
        timeout_s = min(max(timeout_s, 0.0), _TAKE_CAP_S)
        with self._lock:
            self._take_attempts += 1
            it = self._take_attempts
        # the take fault wall sits BEFORE the pop: a kill can't
        # strand a popped entry
        try:
            faults.barrier("replay.take", iteration=it)
        except faults.InjectedKill as e:
            with self._lock:
                self._kills += 1
                self._take_kills += 1
            obs_registry.counter("replaynet_faults_total",
                                 kind="kill").inc()
            raise _ConnAbort(str(e))
        except Exception as e:  # noqa: BLE001 -- injected
            with self._lock:
                self._faults += 1
            obs_registry.counter("replaynet_faults_total",
                                 kind="fault").inc()
            self._count_error("internal")
            return protocol.error_frame(
                "internal", f"transient fault: {e}", id=rid), None
        # wait in bounded slices so a long take never holds drain
        # hostage -- the drained client re-issues elsewhere/later
        deadline = time.monotonic() + timeout_s
        entry = None
        while entry is None:
            if self._core.draining:
                break
            rem = deadline - time.monotonic()
            entry = self.buffer.next_batch(
                timeout=max(0.0, min(0.25, rem)))
            if entry is None and rem <= 0:
                break
        if entry is None:
            with self._lock:
                self._empties += 1
            return {"type": "empty", "id": rid}, None
        rec = replay.games_to_record(entry.games, entry.version,
                                     entry.seq)
        with self._lock:
            self._takes += 1
        obs_registry.counter("replaynet_batches_out_total").inc()
        return {"type": "batch", "id": rid, "seq": entry.seq,
                "record": rec}, entry

    # --------------------------------------------------------- stats

    def stats(self) -> dict:
        """The probes' ``replaynet`` block (the reference's schema)."""
        wire = self._core.counters()
        with self._lock:
            requests = self._requests
            errors = self._errors
            unhandled = self._unhandled
            puts = self._puts
            put_games = self._put_games
            dup_hits = self._dup_hits
            refused = self._refused
            takes = self._takes
            empties = self._empties
            requeued = self._requeued
            injected = self._faults
            kills = self._kills
            put_kills = self._put_kills
            take_kills = self._take_kills
            conn_kills = self._conn_kills
            window = len(self._dedup)
        return {
            "proto": protocol.PROTO_VERSION,
            "schema": replay.RECORD_SCHEMA,
            "draining": wire["draining"],
            "conns": {
                "live": wire["live"],
                "max": self.max_conns,
                "accepted": wire["accepted"],
                "shed": wire["shed"],
            },
            "requests": {
                "total": requests,
                "errors": errors,
                "unhandled": unhandled,
            },
            "ingest": {
                "puts": puts,
                "games": put_games,
                "dup_hits": dup_hits,
                "refused": refused,
            },
            "takes": {
                "batches": takes,
                "empties": empties,
                "requeued": requeued,
            },
            "faults": {
                "injected": injected,
                "kills": kills,
                "put_kills": put_kills,
                "take_kills": take_kills,
                "conn_kills": conn_kills,
            },
            "buffer": {
                "fill": self.buffer.fill,
                "capacity": self.buffer.capacity,
                "ingested_games": self.buffer.ingested_games,
            },
            "dedup_window": {
                "size": window,
                "max": self.dedup_window,
            },
            "evict": self.evict,
            "drain_s": self.drain_s,
        }


class _ConnAbort(Exception):
    """Internal: an injected kill aborts this connection (the client
    re-ships; the dedup window absorbs the retry)."""


def main(argv=None) -> int:
    """Launch a replay service and serve until SIGTERM (the
    supervisor's drain -- stop accepting, finish in-flight requests,
    persist the dedup window, leave the spill for the next
    incarnation, exit 0) or Ctrl-C."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Networked replay service over a ReplayBuffer")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9464)
    ap.add_argument("--capacity", type=int, default=None,
                    help="buffer capacity in entries (default 8)")
    ap.add_argument("--spill-dir", default=None,
                    help="crash-safe spill directory (durability "
                         "across restarts; restored at startup)")
    ap.add_argument("--max-conns", type=int, default=None,
                    help=f"connection cap (default {MAX_CONNS})")
    ap.add_argument("--drain-s", type=float, default=None,
                    help=f"drain grace in seconds (default {DRAIN_S:g})")
    ap.add_argument("--dedup-window", type=int, default=None,
                    help=f"dedup id window (default {DEDUP_WINDOW})")
    ap.add_argument("--evict", action="store_true",
                    help="sliding-window mode: a full buffer evicts "
                         "the oldest entry instead of refusing "
                         "(sampling learners; NOT lossless)")
    ap.add_argument("--fresh", action="store_true",
                    help="discard any existing spill instead of "
                         "restoring it")
    ap.add_argument("--metrics", default=None,
                    help="JSONL path for drain/lifecycle events")
    a = ap.parse_args(argv)

    from rocalphago_tpu_torch.runtime.supervisor import Supervisor

    metrics = None
    if a.metrics:
        from rocalphago_tpu_torch.io.metrics import MetricsLogger

        metrics = MetricsLogger(a.metrics, echo=False)
    service = ReplayService(host=a.host, port=a.port,
                            capacity=a.capacity,
                            spill_dir=a.spill_dir,
                            max_conns=a.max_conns,
                            drain_s=a.drain_s,
                            dedup_window=a.dedup_window,
                            evict=a.evict, metrics=metrics)
    if a.fresh:
        service.buffer.discard_spill()
    else:
        restored = service.recover()
        if restored:
            print(f"replaynet: restored {restored} spilled entries",
                  flush=True)
    service.start()
    sup = Supervisor(metrics=metrics)
    sup.install_sigterm()
    print(f"replaynet: serving on {a.host}:{service.port}",
          flush=True)
    try:
        while not sup.draining:
            time.sleep(0.2)
    except KeyboardInterrupt:
        sup.request_drain(reason="keyboard")
    service.drain(reason="sigterm")
    service.buffer.close()
    if metrics is not None:
        obs_registry.log_to(metrics)
        metrics.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
