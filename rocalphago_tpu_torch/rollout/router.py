"""The federated gateway router: N replicas behind one front door.

The port of the reference package's ``rollout/router.py``, with its
defaults and no environment knob (64 connections, a 10 s drain, a 1 s
health poll). A thin NDJSON tier on the shared wire core
(:class:`~rocalphago_tpu_torch.net.server.LineServerCore`) federating
N :class:`~rocalphago_tpu_torch.gateway.server.GatewayServer` replicas
of either package (one wire):

* **Sticky sessions** -- one accepted connection maps to one backend
  connection (one replica session slot) for its whole life; frames
  pass through with the router re-correlating ids.
* **Spillover** -- a replica refusing ``new_game`` with ``overload``
  is not the client's problem: the router retries the game on the
  next least-loaded healthy replica and only refuses when the whole
  fleet is saturated (the refusal then carries ``retry_after_s``).
* **Drain-aware failover** -- a replica saying ``draining`` (or
  dropping the connection mid-game) triggers a reconnect through the
  shared :func:`~rocalphago_tpu_torch.net.client.call_with_backoff`
  loop, a replay of the game log onto the new replica, and a re-send
  of the in-flight request: at most ONE retried genmove per failover.
* **Health and convergence** -- a poll thread reads each replica's
  ``/healthz`` (or its in-process handles), tracking ``draining``,
  reachability and the serve pool's params version;
  :meth:`RolloutRouter.await_convergence` is the fleet-wide promotion
  barrier ("every replica serves version >= v").

The router touches no device and imports no torch. The lock is a plain
``threading`` lock; each attribute it guards says so in a
``# guarded-by:`` comment.
"""

from __future__ import annotations

import json
import threading
import time

from rocalphago_tpu_torch.gateway import protocol
from rocalphago_tpu_torch.gateway.client import (
    GameLog,
    GatewayClient,
    GatewayClosed,
    GatewayError,
    GatewayRefused,
)
from rocalphago_tpu_torch.net import client as net_client
from rocalphago_tpu_torch.net.server import LineServerCore
from rocalphago_tpu_torch.obs import registry as obs_registry

#: connection cap, drain grace and health poll cadence (seconds): the
#: reference's defaults
MAX_CONNS = 64
DRAIN_S = 10.0
HEALTH_S = 1.0

#: retry hint a fleet-saturated client receives (seconds)
RETRY_AFTER_S = 1.0


class NoReplicaAvailable(Exception):
    """Every eligible replica refused or is unreachable; carries
    ``retry_after_s`` so the shared backoff loop classifies it as
    transient and honors the fleet's pacing."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.retry_after_s = RETRY_AFTER_S


class Replica:
    """One federated gateway: its wire address, its optional health
    surface (``http_port`` → ``/healthz``, or ``gateway`` for an
    in-process :class:`~rocalphago_tpu_torch.gateway.server.
    GatewayServer` handle), and the router-side routing state."""

    def __init__(self, host: str, port: int,
                 http_port: int | None = None, gateway=None,
                 name: str | None = None):
        self.host = host
        self.port = int(port)
        self.http_port = http_port
        self.gateway = gateway
        self.name = name or f"{host}:{port}"
        # routing state -- guarded-by the owning router's lock
        self.healthy = True
        self.draining = False
        self.sessions = 0          # live routed connections
        self.routed = 0            # connections ever routed here
        self.params_version: int | None = None
        self.rollout_version: int | None = None

    def probe(self) -> dict | None:
        """One health read: the ``/healthz`` JSON (in-process when a
        ``gateway`` handle was given), or None when unreachable."""
        if self.gateway is not None:
            g = self.gateway
            return {"status": ("draining" if g.draining else "ok"),
                    "serve": g.pool.stats(), "gateway": g.stats()}
        if self.http_port is None:
            return None
        import urllib.error
        import urllib.request

        url = f"http://{self.host}:{self.http_port}/healthz"
        try:
            with urllib.request.urlopen(url, timeout=2.0) as r:
                return json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            # 503 while draining still carries the body
            try:
                return json.loads(e.read().decode("utf-8"))
            except (OSError, ValueError):
                return None
        except (OSError, ValueError):
            return None


class RolloutRouter:
    """The federation front door (module docstring).

    ``replicas`` is a list of :class:`Replica`; health starts
    optimistic (everyone eligible) and converges from the first poll.
    ``max_conns``/``drain_s``/``health_s`` default to :data:`MAX_CONNS`/
    :data:`DRAIN_S`/:data:`HEALTH_S`.
    """

    def __init__(self, replicas, host: str = "127.0.0.1",
                 port: int = 0, max_conns: int | None = None,
                 drain_s: float | None = None,
                 health_s: float | None = None, metrics=None):
        if not replicas:
            raise ValueError("a router needs at least one replica")
        self.replicas = list(replicas)
        self.host = host
        self.metrics = metrics
        self.max_conns = int(MAX_CONNS if max_conns is None
                             else max_conns)
        self.drain_s = float(DRAIN_S if drain_s is None else drain_s)
        self.health_s = float(HEALTH_S if health_s is None
                              else health_s)
        self._max_frame = protocol.max_frame_bytes()
        self._lock = threading.Lock()
        self._spillovers = 0         # guarded-by: self._lock
        self._failovers = 0          # guarded-by: self._lock
        self._retried_genmoves = 0   # guarded-by: self._lock
        self._routed = 0             # guarded-by: self._lock
        self._closed = False
        self._health_stop = threading.Event()
        self._live_g = obs_registry.gauge("router_conns_live")
        self._acc_c = obs_registry.counter("router_connections_total",
                                           result="accepted")
        self._shed_c = obs_registry.counter("router_connections_total",
                                            result="shed")
        self._spill_c = obs_registry.counter("router_spillovers_total")
        self._fail_c = obs_registry.counter("router_failovers_total")
        self._retry_c = obs_registry.counter(
            "router_retried_genmoves_total")
        self._core = LineServerCore(
            host=host, port=port, max_conns=self.max_conns,
            drain_s=self.drain_s, handler=self._handle,
            refusal=self._refusal_frame, name="router",
            metrics=metrics, live_gauge=self._live_g,
            accepted_counter=self._acc_c, shed_counter=self._shed_c)
        self._health_thread = threading.Thread(
            target=self._health_loop, name="router-health",
            daemon=True)

    # ------------------------------------------------------ lifecycle

    def start(self) -> "RolloutRouter":
        self._core.start()
        self._health_thread.start()
        return self

    @property
    def port(self) -> int:
        return self._core.port

    @property
    def draining(self) -> bool:
        return self._core.draining

    def drain(self, reason: str = "requested",
              timeout: float | None = None) -> None:
        self._health_stop.set()
        self._core.drain(reason=reason, timeout=timeout)
        if self._health_thread.is_alive():
            self._health_thread.join(timeout=5.0)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.drain(reason="close")

    def __enter__(self) -> "RolloutRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------- health

    def poll_health_once(self) -> None:
        """One probe sweep over the fleet (the health thread's body;
        callable inline from tests)."""
        for rep in self.replicas:
            info = rep.probe()
            with self._lock:
                if info is None:
                    # unreachable only counts against replicas that
                    # HAVE a health surface; a bare address stays
                    # eligible until the wire refuses it
                    rep.healthy = (rep.gateway is None
                                   and rep.http_port is None)
                    rep.draining = False
                    continue
                rep.healthy = True
                rep.draining = (info.get("status") == "draining"
                                or bool(info.get("gateway", {})
                                        .get("draining")))
                serve = info.get("serve", {})
                params = serve.get("params")
                if params is not None:
                    rep.params_version = params.get("version")
                elif "params_version" in serve:   # multisize block
                    rep.params_version = serve.get("params_version")

    def _health_loop(self) -> None:
        while not self._health_stop.is_set():
            self.poll_health_once()
            self._health_stop.wait(self.health_s)

    def await_convergence(self, version: int,
                          timeout: float = 30.0) -> bool:
        """Block until every non-draining replica's serve pool
        reports params version ≥ ``version`` (the fleet-wide
        promotion barrier). False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.poll_health_once()
            with self._lock:
                reps = [r for r in self.replicas if not r.draining]
                done = reps and all(
                    r.params_version is not None
                    and r.params_version >= version for r in reps)
            if done:
                return True
            time.sleep(min(0.05, self.health_s))
        return False

    # ------------------------------------------------------- routing

    def _eligible(self, exclude=()) -> list:
        with self._lock:
            reps = [r for r in self.replicas
                    if r.healthy and not r.draining
                    and r.name not in exclude]
            return sorted(reps, key=lambda r: (r.sessions, r.name))

    def _connect_backend(self, exclude=()):
        """Least-loaded-first connect sweep; raises
        :class:`NoReplicaAvailable` (transient, with a retry hint)
        when the whole eligible fleet refuses or is unreachable."""
        for rep in self._eligible(exclude):
            try:
                backend = GatewayClient(rep.host, rep.port,
                                        timeout=30.0)
            except GatewayRefused as e:
                with self._lock:
                    rep.draining = (e.code == "draining") \
                        or rep.draining
                continue
            except (GatewayClosed, OSError):
                with self._lock:
                    rep.healthy = False
                continue
            with self._lock:
                rep.sessions += 1
                rep.routed += 1
                self._routed += 1
            obs_registry.counter("router_routed_total",
                                 replica=rep.name).inc()
            return backend, rep
        raise NoReplicaAvailable(
            f"no replica available (fleet of {len(self.replicas)})")

    def _release(self, rep) -> None:
        with self._lock:
            rep.sessions = max(0, rep.sessions - 1)

    def _refusal_frame(self, code: str) -> dict:
        obs_registry.counter("router_errors_total", code=code).inc()
        return protocol.error_frame(
            code, f"router {code}: {self.max_conns} connections live",
            retry_after_s=RETRY_AFTER_S)

    def _send(self, conn, msg: dict) -> bool:
        return self._core.send(conn, msg)

    def _emit(self, phase: str, **fields) -> None:
        if self.metrics is not None:
            self.metrics.log("router", phase=phase, **fields)

    # ------------------------------------------------------- handler

    def _handle(self, conn, reader, cid: int) -> None:
        try:
            backend, rep = self._connect_backend()
        except NoReplicaAvailable as e:
            self._send(conn, protocol.error_frame(
                "overload", str(e), retry_after_s=RETRY_AFTER_S))
            return
        log = GameLog()
        try:
            hello = dict(backend.hello)
            hello["name"] = "rocalphago-router"
            if not self._send(conn, hello):
                return
            while True:
                if self._core.draining:
                    self._send(conn, {"type": "goodbye",
                                      "reason": "draining"})
                    break
                try:
                    msg = protocol.read_frame(reader, self._max_frame)
                except protocol.ProtocolError as e:
                    self._send(conn, protocol.error_frame(
                        e.code, str(e)))
                    if e.fatal:
                        break
                    continue
                if msg is None:
                    break
                rid = msg.get("id")
                try:
                    reply, backend, rep = self._route(msg, backend,
                                                      rep, log)
                except Exception as e:  # noqa: BLE001 -- the routed
                    # conversation is unrecoverable (no replica can
                    # continue it): a typed refusal, never a hang,
                    # and the failover path already tore the dead
                    # backend down
                    backend, rep = None, None
                    retry = getattr(e, "retry_after_s",
                                    RETRY_AFTER_S)
                    self._send(conn, protocol.error_frame(
                        "overload",
                        f"no replica can continue this game: {e}",
                        id=rid, retry_after_s=retry))
                    break
                reply = dict(reply)
                if rid is None:
                    reply.pop("id", None)
                else:
                    reply["id"] = rid
                if not self._send(conn, reply):
                    break
        finally:
            if backend is not None:
                backend.close()
            if rep is not None:
                self._release(rep)

    def _route(self, msg: dict, backend, rep, log: GameLog):
        """Forward one frame, absorbing replica failures: returns
        ``(reply, backend, rep)`` with the backend possibly moved to
        another replica (spillover/failover)."""
        mtype = msg.get("type")
        forward = dict(msg)
        forward.pop("id", None)
        try:
            try:
                reply = backend.request(forward)
            except GatewayRefused as e:
                if mtype == "new_game":
                    backend, rep = self._spillover(backend, rep, e)
                    reply = backend.request(forward)
                else:
                    raise GatewayClosed(
                        f"replica refused mid-game ({e.code})")
        except (GatewayClosed, OSError):
            backend, rep, reply = self._failover(forward, backend,
                                                 rep, log, mtype)
        except GatewayError as e:
            # a typed refusal passes through as the frame it was
            return self._error_reply(e), backend, rep
        self._track(mtype, msg, reply, log)
        return reply, backend, rep

    def _error_reply(self, e: GatewayError) -> dict:
        msg = str(e)
        if msg.startswith(f"{e.code}: "):
            msg = msg[len(e.code) + 2:]
        return protocol.error_frame(e.code, msg,
                                    retry_after_s=e.retry_after_s)

    def _track(self, mtype, msg, reply, log: GameLog) -> None:
        """Keep the per-connection game log replayable (the failover
        replay source)."""
        if reply.get("type") == "error":
            return
        if mtype == "new_game":
            log.start(reply.get("board"), reply.get("komi"))
        elif mtype == "play":
            log.play(str(msg.get("color", "")), str(msg.get("move",
                                                            "")))
        elif mtype == "genmove" and reply.get("type") == "move":
            log.play(str(msg.get("color", "")), reply.get("move"))
        elif mtype == "komi":
            log.set_komi(msg.get("komi"))
        elif mtype == "close":
            log.clear()

    def _spillover(self, backend, rep, refusal):
        """``new_game`` overload on one replica → the next one."""
        try:
            nb, nr = self._connect_backend(exclude=(rep.name,))
        except NoReplicaAvailable:
            # the WHOLE fleet is saturated: surface the original
            # structured refusal (retry_after_s intact); the current
            # backend stays up -- the conversation continues on it
            raise refusal
        backend.close()
        self._release(rep)
        with self._lock:
            self._spillovers += 1
        self._spill_c.inc()
        self._emit("spillover", replica=rep.name, code=refusal.code)
        return nb, nr

    def _failover(self, forward, backend, rep, log: GameLog, mtype):
        """Mid-conversation replica loss: reconnect (shared backoff,
        honoring retry hints), replay the game, re-send the in-flight
        request -- the ≤ 1 retried genmove the soak green-gates on."""
        backend.close()
        self._release(rep)
        with self._lock:
            self._failovers += 1
            rep.healthy = rep.gateway is not None and \
                not rep.gateway.draining
            if mtype == "genmove":
                self._retried_genmoves += 1
        self._fail_c.inc()
        if mtype == "genmove":
            self._retry_c.inc()
        self._emit("failover", replica=rep.name, request=str(mtype))

        # prefer a DIFFERENT replica, but a single-replica fleet may
        # only come back on the one that dropped (post-restart)
        excl = (rep.name,) if len(self.replicas) > 1 else ()

        def attempt():
            nb, nr = self._connect_backend(exclude=excl)
            try:
                if log.active:
                    log.replay(nb)
                return nb, nr, nb.request(forward)
            except BaseException:
                nb.close()
                self._release(nr)
                raise

        return net_client.call_with_backoff(
            attempt, attempts=4, key="router.failover")

    # --------------------------------------------------------- stats

    def stats(self) -> dict:
        """The probes' ``router`` block (the reference's schema;
        ``replicas`` is the per-replica map)."""
        wire = self._core.counters()
        with self._lock:
            replicas = {
                r.name: {"healthy": r.healthy,
                         "draining": r.draining,
                         "sessions": r.sessions,
                         "routed": r.routed,
                         "params_version": r.params_version}
                for r in self.replicas}
            spillovers = self._spillovers
            failovers = self._failovers
            retried = self._retried_genmoves
            routed = self._routed
        return {
            "proto": protocol.PROTO_VERSION,
            "draining": wire["draining"],
            "conns": {
                "live": wire["live"],
                "max": self.max_conns,
                "accepted": wire["accepted"],
                "shed": wire["shed"],
            },
            "routed": routed,
            "spillovers": spillovers,
            "failovers": failovers,
            "retried_genmoves": retried,
            "drain_s": self.drain_s,
            "health_s": self.health_s,
            "replicas": replicas,
        }


class RouterHTTP:
    """``/healthz`` + ``/metrics`` sidecar for the router (the shape
    :class:`~rocalphago_tpu_torch.gateway.httpapi.GatewayHTTP` gives a
    single gateway; the router's health JSON carries its ``router``
    stats block instead of a pool's)."""

    def __init__(self, router: RolloutRouter, host: str = "127.0.0.1",
                 port: int = 0):
        from http.server import (
            BaseHTTPRequestHandler,
            ThreadingHTTPServer,
        )

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802 -- quiet
                pass

            def _reply(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 -- http.server contract
                if self.path == "/metrics":
                    self._reply(200,
                                obs_registry.render_text().encode(),
                                "text/plain; version=0.0.4")
                    return
                if self.path == "/healthz":
                    draining = router.draining
                    body = json.dumps({
                        "status": ("draining" if draining else "ok"),
                        "router": router.stats(),
                    }, sort_keys=True).encode()
                    self._reply(503 if draining else 200, body,
                                "application/json")
                    return
                self._reply(404, b"not found\n", "text/plain")

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1}, name="router-http")

    def start(self) -> "RouterHTTP":
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def close(self) -> None:
        self._httpd.shutdown()
        self._thread.join(timeout=10.0)
        self._httpd.server_close()


def _parse_replica(spec: str) -> Replica:
    """``host:port[:http_port]`` → :class:`Replica`."""
    parts = spec.split(":")
    if len(parts) not in (2, 3):
        raise ValueError(
            f"replica spec {spec!r} is not host:port[:http_port]")
    http = int(parts[2]) if len(parts) == 3 else None
    return Replica(parts[0], int(parts[1]), http_port=http)


def main(argv=None) -> int:
    """Run a router over already-running gateway replicas until
    SIGTERM (drain, exit 0) or Ctrl-C."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Federated gateway router over gateway replicas")
    ap.add_argument("--replica", action="append", required=True,
                    help="host:port[:http_port] -- repeat per replica")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9464)
    ap.add_argument("--http-port", type=int, default=9465,
                    help="/healthz + /metrics port (0 disables)")
    ap.add_argument("--max-conns", type=int, default=None)
    ap.add_argument("--metrics", default=None,
                    help="JSONL path for router/drain events")
    a = ap.parse_args(argv)

    from rocalphago_tpu_torch.runtime.supervisor import Supervisor

    metrics = None
    if a.metrics:
        from rocalphago_tpu_torch.io.metrics import MetricsLogger

        metrics = MetricsLogger(a.metrics, echo=False)
    router = RolloutRouter(
        [_parse_replica(s) for s in a.replica], host=a.host,
        port=a.port, max_conns=a.max_conns, metrics=metrics).start()
    http = None
    if a.http_port:
        http = RouterHTTP(router, host=a.host,
                          port=a.http_port).start()
    sup = Supervisor(metrics=metrics)
    sup.install_sigterm()
    print(f"router: serving on {a.host}:{router.port} over "
          f"{len(router.replicas)} replicas "
          f"(http {'off' if http is None else http.port})", flush=True)
    try:
        while not sup.draining:
            time.sleep(0.2)
    except KeyboardInterrupt:
        sup.request_drain(reason="keyboard")
    router.drain(reason="sigterm")
    if http is not None:
        http.close()
    if metrics is not None:
        obs_registry.log_to(metrics)
        metrics.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
