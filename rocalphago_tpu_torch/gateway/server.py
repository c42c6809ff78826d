"""The gateway socket server: one connection ↔ one pool session.

The port of the reference package's ``gateway/server.py``, with its
defaults and no environment knob: 64 connections, no SLO, a 10 s
drain. A threaded stdlib server over a :class:`~rocalphago_tpu_torch.
serve.sessions.ServePool` (or a :class:`~rocalphago_tpu_torch.multisize.
pool.MultiSizePool`: ``new_game``'s ``board`` then routes to the member
pool of that size). Each accepted connection gets a handler thread, a
ladder-wrapped session (admission-controlled by the pool), and its own
server-side :class:`~rocalphago_tpu_torch.engine.pygo.GameState`; the
wire is NDJSON (:mod:`~rocalphago_tpu_torch.gateway.protocol`). The
session searches on the pool's device; a handler thread's genmove is
the session player's own (no autograd graph, no host read beyond the
session's).

Load shedding is STRUCTURED, never a hang: past ``max_conns`` the
accept loop answers with an ``overload`` error frame (carrying
``retry_after_s``) and closes; a pool at its session cap turns
``new_game`` into the same refusal. Every shed is counted
(``gateway_connections_total{result=}``, ``gateway_errors_total
{code=}``) so ``/metrics`` sees pressure before clients do.

Per-request SLO: ``slo_ms`` arms a :class:`~rocalphago_tpu_torch.
runtime.deadline.Deadline` per genmove -- the session's anytime search
answers inside it, and the reply reports whether the deadline fired.

Faults: the handler runs each request behind the ``gateway.conn``
barrier (:mod:`rocalphago_tpu_torch.runtime.faults`) -- an injected
transient fails THAT request with a typed ``internal`` error, an
injected kill aborts the connection; either way the session is closed,
the admission slot released, and nothing escapes the handler:
``requests.unhandled`` in the probe counts any exception of the
dispatch itself (a kernel wrapper's raise included), which answers as
an ``internal`` frame.

Drain: :meth:`GatewayServer.drain` -- or SIGTERM through the supervisor
in :func:`main` -- stops the accept loop, lets in-flight moves finish,
nudges idle connections with a read-side shutdown (their handlers say
goodbye and close their sessions), joins every handler within
``drain_s``, and leaves the process free to exit 0.

The accept loop, admission refusals, connection registry and the
three-step drain are the shared :class:`~rocalphago_tpu_torch.net.
server.LineServerCore` (composed); this module keeps the
gateway-specific parts: session mapping, dispatch, the per-request SLO
and the probe.

Run it as::

    python -m rocalphago_tpu_torch.gateway.server --policy P.json \
        --value V.json [--sizes 9,13,19] [--port 9462] [--http-port 9463] \
        [--playouts 100] [--slo-ms 2000] [--metrics gateway.jsonl] \
        [--spill DIR] [--device cpu]

``--spill DIR`` follows a rollout spill pointer with a
:class:`~rocalphago_tpu_torch.rollout.hotswap.SpillWatcher`: promoted
params hot-swap into the live pool.
"""

from __future__ import annotations

import threading
import time

from rocalphago_tpu_torch.engine import pygo
from rocalphago_tpu_torch.gateway import protocol
from rocalphago_tpu_torch.interface.gtp import (
    move_to_vertex,
    parse_color,
    vertex_to_move,
)
from rocalphago_tpu_torch.interface.resilient import percentile
from rocalphago_tpu_torch.net.server import LineServerCore
from rocalphago_tpu_torch.obs import registry as obs_registry
from rocalphago_tpu_torch.obs import torchobs
from rocalphago_tpu_torch.runtime import faults
from rocalphago_tpu_torch.runtime.deadline import Deadline
from rocalphago_tpu_torch.serve.admission import AdmissionError

#: connection cap, per-genmove SLO (None = off) and drain grace: the
#: reference's defaults
MAX_CONNS = 64
SLO_MS = None
DRAIN_S = 10.0

#: retry hint a shed/refused client receives (seconds)
RETRY_AFTER_S = 1.0

#: wire-latency samples kept for the probe's p50/p99
_LAT_KEEP = 512


class _Game:
    """One live game on one connection: the pool session plus the
    server-side rules state the session's player searches from."""

    def __init__(self, session, board: int, komi: float,
                 arm: str | None = None):
        self.session = session
        self.board = board
        self.state = pygo.GameState(size=board, komi=komi)
        #: canary arm ("candidate"/"incumbent") when a controller is
        #: routing; None otherwise
        self.arm = arm
        #: colors THIS connection genmoved -- an outcome only counts
        #: for the canary when exactly one side was served here
        self.served: set = set()
        self.finished = False


class GatewayServer:
    """Threaded NDJSON front end over a serve pool (module docstring).

    Parameters: ``pool`` (ServePool or MultiSizePool), ``host``/
    ``port`` (0 = ephemeral), ``max_conns`` / ``slo_ms`` / ``drain_s``
    (None = :data:`MAX_CONNS` / :data:`SLO_MS` / :data:`DRAIN_S`),
    ``metrics`` (drain-phase events land there), ``canary`` (a
    duck-typed controller -- ``assign()``, ``state``, ``record(arm,
    won=)`` -- routing a slice of new sessions to a staged params
    version).
    """

    def __init__(self, pool, host: str = "127.0.0.1", port: int = 0,
                 max_conns: int | None = None,
                 slo_ms: float | None = None,
                 drain_s: float | None = None, metrics=None,
                 canary=None):
        self.pool = pool
        self.host = host
        self._port_arg = int(port)
        self.metrics = metrics
        #: optional canary controller routing a slice of new sessions
        #: to a staged candidate version
        self.canary = canary
        self.max_conns = MAX_CONNS if max_conns is None else int(max_conns)
        self.slo_ms = SLO_MS if slo_ms is None else float(slo_ms)
        self.drain_s = DRAIN_S if drain_s is None else float(drain_s)
        self._max_frame = protocol.max_frame_bytes()
        self._lock = threading.Lock()
        self._shed = 0               # guarded-by: self._lock
        self._requests = 0           # guarded-by: self._lock
        self._errors = 0             # guarded-by: self._lock
        self._genmoves = 0           # guarded-by: self._lock
        self._unhandled = 0          # guarded-by: self._lock
        self._faults = 0             # guarded-by: self._lock
        self._kills = 0              # guarded-by: self._lock
        self._lat: list = []         # guarded-by: self._lock
        self._closed = False
        self._live_g = obs_registry.gauge("gateway_conns_live")
        self._acc_c = obs_registry.counter("gateway_connections_total",
                                           result="accepted")
        self._shed_c = obs_registry.counter("gateway_connections_total",
                                            result="shed")
        self._wire_h = obs_registry.histogram("gateway_wire_seconds")
        # accept/admission/registry/drain: the shared wire core
        self._core = LineServerCore(
            host=host, port=port, max_conns=self.max_conns,
            drain_s=self.drain_s, handler=self._handle,
            refusal=self._refusal_frame, name="gateway",
            metrics=metrics, live_gauge=self._live_g,
            accepted_counter=self._acc_c, shed_counter=self._shed_c)

    # ------------------------------------------------------ lifecycle

    def start(self) -> "GatewayServer":
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
        """Graceful stop: refuse new work, finish in-flight moves,
        close every session, quiesce every thread (module docstring).
        Idempotent; bounded by ``timeout`` (default ``drain_s``)."""
        self._core.drain(reason=reason, timeout=timeout)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.drain(reason="close")

    def __enter__(self) -> "GatewayServer":
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
            f"gateway {code}: {self.max_conns} connections live",
            retry_after_s=RETRY_AFTER_S)

    def _send(self, conn, msg: dict) -> bool:
        return self._core.send(conn, msg)

    def _count_error(self, code: str) -> None:
        obs_registry.counter("gateway_errors_total", code=code).inc()
        with self._lock:
            self._errors += 1

    def _handle(self, conn, reader, cid: int) -> None:
        game = None
        try:
            self._send(conn, protocol.hello_frame(
                self._boards(), self._default_board(), self.slo_ms))
            n = 0
            while True:
                if self._core.draining:
                    self._send(conn, {"type": "goodbye",
                                      "reason": "draining"})
                    break
                try:
                    msg = protocol.read_frame(reader, self._max_frame)
                except protocol.ProtocolError as e:
                    self._count_error(e.code)
                    self._send(conn, protocol.error_frame(
                        e.code, str(e)))
                    if e.fatal:
                        break
                    continue
                if msg is None:
                    break              # disconnect / torn frame
                n += 1
                with self._lock:
                    self._requests += 1
                rid = msg.get("id")
                # the per-request fault wall: a transient fails this request, a kill this
                # connection -- never the server
                try:
                    faults.barrier("gateway.conn", iteration=n)
                except faults.InjectedKill as e:
                    with self._lock:
                        self._kills += 1
                    obs_registry.counter("gateway_faults_total",
                                         kind="kill").inc()
                    self._send(conn, protocol.error_frame(
                        "internal", f"connection aborted: {e}",
                        id=rid))
                    break
                except Exception as e:  # noqa: BLE001 -- injected
                    with self._lock:
                        self._faults += 1
                    obs_registry.counter("gateway_faults_total",
                                         kind="fault").inc()
                    self._count_error("internal")
                    self._send(conn, protocol.error_frame(
                        "internal", f"transient fault: {e}", id=rid))
                    continue
                try:
                    reply, game = self._dispatch(msg, game)
                except Exception as e:  # noqa: BLE001 -- fault wall:
                    #   the connection must answer, the server live on
                    with self._lock:
                        self._unhandled += 1
                    self._count_error("internal")
                    reply = protocol.error_frame(
                        "internal", f"{type(e).__name__}: {e}",
                        id=rid)
                if reply is not None and not self._send(conn, reply):
                    break
        finally:
            if game is not None:
                game.session.close()

    # ------------------------------------------------------ dispatch

    def _dispatch(self, msg: dict, game):
        """One request → (reply frame, game). Refusals are typed
        error frames; only genuine bugs raise (counted unhandled)."""
        rid = msg.get("id")
        mtype = msg.get("type")
        obs_registry.counter("gateway_requests_total",
                             type=str(mtype)).inc()
        if mtype == "hello":
            proto = msg.get("proto", protocol.PROTO_VERSION)
            if proto != protocol.PROTO_VERSION:
                self._count_error("bad_proto")
                return protocol.error_frame(
                    "bad_proto",
                    f"server speaks proto {protocol.PROTO_VERSION}, "
                    f"client pinned {proto}", id=rid), game
            return {"type": "ok", "id": rid,
                    "proto": protocol.PROTO_VERSION}, game
        if mtype == "new_game":
            return self._new_game(msg, game)
        if mtype == "close":
            if game is not None:
                game.session.close()
            return {"type": "ok", "id": rid}, None
        if mtype in ("play", "genmove", "komi"):
            if game is None:
                self._count_error("no_game")
                return protocol.error_frame(
                    "no_game", f"{mtype} before new_game",
                    id=rid), game
            if mtype == "komi":
                try:
                    komi = float(msg.get("komi", game.state.komi))
                except (TypeError, ValueError) as e:
                    self._count_error("bad_request")
                    return protocol.error_frame(
                        "bad_request", f"unparseable komi: {e}",
                        id=rid), game
                game.session.set_komi(komi)
                game.state.komi = komi
                return {"type": "ok", "id": rid}, game
            if mtype == "play":
                return self._play(msg, game), game
            return self._genmove(msg, game), game
        self._count_error("unknown_type")
        return protocol.error_frame(
            "unknown_type", f"unknown message type {mtype!r}",
            id=rid), game

    def _boards(self) -> tuple:
        pool = self.pool
        return (tuple(pool.sizes) if hasattr(pool, "pool_for")
                else (pool.board,))

    def _default_board(self) -> int:
        pool = self.pool
        return (pool.default_size if hasattr(pool, "pool_for")
                else pool.board)

    def _new_game(self, msg: dict, game):
        rid = msg.get("id")
        # client fields parse BEFORE any side effect: a malformed
        # value is a typed refusal, never a leaked session or a
        # torn-down previous game
        try:
            board = int(msg.get("board", self._default_board()))
            komi = msg.get("komi")
            if komi is not None:
                komi = float(komi)
        except (TypeError, ValueError) as e:
            self._count_error("bad_request")
            return protocol.error_frame(
                "bad_request",
                f"unparseable new_game field: {e}", id=rid), game
        if game is not None:
            game.session.close()
            game = None
        try:
            if hasattr(self.pool, "pool_for"):
                session = self.pool.open_session(size=board)
            else:
                if board != self.pool.board:
                    raise KeyError(board)
                session = self.pool.open_session()
        except KeyError:
            self._count_error("bad_board")
            return protocol.error_frame(
                "bad_board",
                f"board {board} not served (serving "
                f"{list(self._boards())})", id=rid), None
        except AdmissionError as e:
            # the pool's AdmissionController said no: the structured
            # refusal the load balancer backs off on
            self._count_error("overload")
            self._shed_c.inc()
            with self._lock:
                self._shed += 1
            return protocol.error_frame(
                "overload", str(e), id=rid,
                retry_after_s=RETRY_AFTER_S), None
        try:
            if komi is not None:
                session.set_komi(komi)
            eff_komi = komi if komi is not None \
                else float(session.raw.pool.cfg.komi)
            arm = None
            if self.canary is not None:
                pin = self.canary.assign()
                if pin is not None:
                    session.pin_version(pin)
                    arm = "candidate"
                elif self.canary.state == "running":
                    arm = "incumbent"
            game = _Game(session, board, eff_komi, arm=arm)
        except BaseException:
            # the admission slot must come back even on a genuine
            # bug -- a raise between open and _Game would otherwise
            # strand the session until restart
            session.close()
            raise
        return {"type": "ok", "id": rid, "board": board,
                "komi": eff_komi}, game

    def _play(self, msg: dict, game) -> dict:
        rid = msg.get("id")
        state = game.state
        prev = state.current_player
        try:
            color = parse_color(str(msg.get("color", "")))
            move = vertex_to_move(str(msg.get("move", "")),
                                  game.board)
            state.current_player = color
            if state.is_end_of_game:
                raise _GameOver()
            if move is not None and not state.is_legal(move):
                raise ValueError("illegal move")
            state.do_move(move, color)
        except _GameOver:
            state.current_player = prev
            self._count_error("game_over")
            return protocol.error_frame(
                "game_over", "the game has ended", id=rid)
        except Exception as e:  # noqa: BLE001 -- refusal, state intact
            state.current_player = prev
            self._count_error("illegal_move")
            return protocol.error_frame("illegal_move", str(e),
                                        id=rid)
        if state.is_end_of_game:
            self._finish_game(game)
        return {"type": "ok", "id": rid}

    def _genmove(self, msg: dict, game) -> dict:
        rid = msg.get("id")
        state = game.state
        if state.is_end_of_game:
            self._count_error("game_over")
            return protocol.error_frame(
                "game_over", "the game has ended", id=rid)
        try:
            color = parse_color(str(msg.get("color", "")))
        except ValueError as e:
            self._count_error("bad_request")
            return protocol.error_frame("bad_request", str(e),
                                        id=rid)
        prev = state.current_player
        state.current_player = color
        # per-request SLO: the deadline arms inside the session's
        # anytime search (min of this and the pool's own SLO)
        slo_s = None if self.slo_ms is None else self.slo_ms / 1e3
        deadline = Deadline.after(slo_s)
        game.session.raw.set_move_time(slo_s)
        t0 = time.monotonic()
        try:
            move = game.session.get_move(state)
            if move is not None and not state.is_legal(move):
                move = None            # final guard, like the engine
            state.do_move(move, color)
        except Exception:
            state.current_player = prev
            raise
        dt = time.monotonic() - t0
        self._wire_h.observe(dt)
        game.served.add(color)
        if state.is_end_of_game:
            self._finish_game(game)
        with self._lock:
            self._genmoves += 1
            self._lat.append(dt)
            if len(self._lat) > _LAT_KEEP:
                del self._lat[: len(self._lat) - _LAT_KEEP]
        return {"type": "move", "id": rid,
                "move": move_to_vertex(move, game.board),
                "elapsed_ms": round(dt * 1e3, 3),
                "slo_hit": bool(not deadline.unlimited
                                and deadline.expired()),
                "rung": getattr(game.session.player, "last_rung",
                                None)}

    def _finish_game(self, game) -> None:
        """Game over: feed the canary ONE decided outcome, once --
        and only when this connection genmoved exactly one side (a
        self-play connection has no arm-attributable winner)."""
        if game.finished:
            return
        game.finished = True
        if self.canary is None or game.arm is None:
            return
        if len(game.served) != 1:
            return
        winner = game.state.get_winner()
        if winner == 0:
            return                     # draw: not a decided game
        color = next(iter(game.served))
        self.canary.record(game.arm, won=(winner == color))

    # --------------------------------------------------------- stats

    def stats(self) -> dict:
        """The probes' ``gateway`` block (the reference's schema)."""
        wire = self._core.counters()
        with self._lock:
            shed = self._shed
            requests = self._requests
            errors = self._errors
            genmoves = self._genmoves
            unhandled = self._unhandled
            injected = self._faults
            kills = self._kills
            lat = sorted(self._lat)
        p50 = percentile(lat, 0.5)
        p99 = percentile(lat, 0.99)
        return {
            "proto": protocol.PROTO_VERSION,
            "draining": wire["draining"],
            "conns": {
                "live": wire["live"],
                "max": self.max_conns,
                "accepted": wire["accepted"],
                # at-accept conn sheds (core) + pool-admission sheds
                "shed": wire["shed"] + shed,
            },
            "requests": {
                "total": requests,
                "errors": errors,
                "genmoves": genmoves,
                "unhandled": unhandled,
            },
            "faults": {
                "injected": injected,
                "kills": kills,
            },
            "wire_ms": {
                "p50": None if p50 is None else round(p50 * 1e3, 3),
                "p99": None if p99 is None else round(p99 * 1e3, 3),
            },
            "slo_ms": self.slo_ms,
            "drain_s": self.drain_s,
            "boards": list(self._boards()),
            "default_board": self._default_board(),
        }


class _GameOver(Exception):
    """Internal: a move was requested after the game ended."""


def main(argv=None) -> int:
    """Launch a gateway over saved models and serve until SIGTERM (the
    supervisor's drain: stop accepting, finish in-flight moves, close
    sessions, exit 0) or Ctrl-C. The pool runs on the card unless
    ``--device`` names another device; with no card it raises."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Network play gateway over a serve pool")
    ap.add_argument("--policy", required=True,
                    help="policy model JSON spec")
    ap.add_argument("--value", required=True,
                    help="value model JSON spec")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9462)
    ap.add_argument("--http-port", type=int, default=9463,
                    help="/healthz + /metrics port (0 disables)")
    ap.add_argument("--playouts", type=int, default=100)
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-genmove SLO in ms (default off)")
    ap.add_argument("--max-conns", type=int, default=None,
                    help=f"connection cap (default {MAX_CONNS})")
    ap.add_argument("--sizes", default=None,
                    help="comma list of board sizes for a multi-size "
                         "pool (needs FCN heads)")
    ap.add_argument("--metrics", default=None,
                    help="JSONL path for drain/degradation events")
    ap.add_argument("--spill", default=None,
                    help="rollout spill dir to watch (the gate's pool dir, "
                         "or a ParamsPublisher's spill_dir): promoted "
                         "params hot-swap into the live pool, no restart")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pool (default cuda; 'cpu' "
                         "to run on the CPU)")
    a = ap.parse_args(argv)

    from rocalphago_tpu_torch.device import resolve_device
    from rocalphago_tpu_torch.gateway.httpapi import GatewayHTTP
    from rocalphago_tpu_torch.models.nn_util import NeuralNetBase
    from rocalphago_tpu_torch.runtime.supervisor import Supervisor

    dev = resolve_device(a.device)
    metrics = None
    if a.metrics:
        from rocalphago_tpu_torch.io.metrics import MetricsLogger

        metrics = MetricsLogger(a.metrics, echo=False)
    policy = NeuralNetBase.load_model(a.policy, device=dev)
    value = NeuralNetBase.load_model(a.value, device=dev)
    if a.sizes:
        from rocalphago_tpu_torch.multisize import MultiSizePool

        sizes = tuple(int(s) for s in a.sizes.split(",") if s.strip())
        pool = MultiSizePool(value, policy, sizes=sizes,
                             n_sim=a.playouts, metrics=metrics)
    else:
        from rocalphago_tpu_torch.serve.sessions import ServePool

        pool = ServePool(value, policy, n_sim=a.playouts,
                         metrics=metrics)
    pool.warm()
    watcher = None
    if a.spill:
        from rocalphago_tpu_torch.rollout.hotswap import (
            HotSwapper,
            SpillWatcher,
        )

        watcher = SpillWatcher(
            a.spill, HotSwapper(pool, metrics=metrics),
            policy.module, value.module, metrics=metrics).start()
    server = GatewayServer(pool, host=a.host, port=a.port,
                           max_conns=a.max_conns, slo_ms=a.slo_ms,
                           metrics=metrics).start()
    http = None
    if a.http_port:
        http = GatewayHTTP(server, host=a.host,
                           port=a.http_port).start()
    sup = Supervisor(metrics=metrics)
    sup.install_sigterm()
    print(f"gateway: serving on {a.host}:{server.port} "
          f"(http {'off' if http is None else http.port})", flush=True)
    try:
        while not sup.draining:
            time.sleep(0.2)
    except KeyboardInterrupt:
        sup.request_drain(reason="keyboard")
    server.drain(reason="sigterm")
    if watcher is not None:
        watcher.stop()
    if http is not None:
        http.close()
    pool.close()
    if metrics is not None:
        torchobs.flush_untracked()
        obs_registry.log_to(metrics)
        metrics.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
