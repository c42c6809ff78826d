"""Gateway client: the protocol handle plus the synthetic-load rig.

A copy of the reference package's ``gateway/client.py``; it speaks to
either package's gateway. :class:`GatewayClient` is the blocking
request/response handle (the GTP bridge, ``interface/gtp.py
--connect``, and ``chip_smoke.py``'s gateway phase use it). A
structured refusal (``overload``/``draining``) surfaces as
:class:`GatewayRefused` carrying the server's ``retry_after_s`` so
callers back off instead of spinning; a dropped connection is
:class:`GatewayClosed`.

:func:`connect_with_retry` is the backoff-aware way in: it wraps the
constructor in the shared :func:`rocalphago_tpu_torch.net.client.
call_with_backoff` loop, so a shed client sleeps at least the server's
``retry_after_s`` and succeeds on a later attempt once a slot frees.
:class:`ResilientGatewayClient` reconnects, replays the live game from
its :class:`GameLog` and retries.

:func:`run_load` drives N concurrent synthetic games (one connection
each, barrier-started) and returns per-genmove latencies plus
shed/disconnect counts: the measurement half of the wire-tax A/B.

The client holds no model and touches no device.
"""

from __future__ import annotations

import socket
import threading
import time

from rocalphago_tpu_torch.gateway import protocol
from rocalphago_tpu_torch.net import client as net_client


class GatewayError(Exception):
    """A typed error frame; ``code`` is one of
    :data:`~rocalphago_tpu_torch.gateway.protocol.ERROR_CODES`."""

    def __init__(self, code: str, msg: str,
                 retry_after_s: float | None = None):
        super().__init__(f"{code}: {msg}")
        self.code = code
        self.retry_after_s = retry_after_s


class GatewayRefused(GatewayError):
    """The gateway shed this connection/request (``overload`` or
    ``draining``) — retry elsewhere or after ``retry_after_s``."""


class GatewayClosed(Exception):
    """The connection dropped mid-conversation (kill, drain nudge,
    network)."""


_REFUSAL_CODES = ("overload", "draining")


def _raise_error(frame: dict) -> None:
    code = frame.get("code", "internal")
    msg = frame.get("msg", "")
    retry = frame.get("retry_after_s")
    if code in _REFUSAL_CODES:
        raise GatewayRefused(code, msg, retry_after_s=retry)
    raise GatewayError(code, msg, retry_after_s=retry)


class GatewayClient:
    """One wire connection (= one server-side session slot).

    Connecting reads the server's ``hello`` (board sizes, SLO) — or
    raises :class:`GatewayRefused` when the gateway sheds at accept.
    Request helpers raise :class:`GatewayError` on typed refusals
    and :class:`GatewayClosed` on disconnect; the game survives
    non-fatal errors (``illegal_move``, ``internal``) server-side.
    """

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self._reader = self.sock.makefile("rb")
        self._next_id = 0
        self.hello = self._recv()
        if self.hello.get("type") == "error":
            self.close()
            _raise_error(self.hello)
        self.boards = tuple(self.hello.get("boards", ()))
        self.default_board = self.hello.get("default_board")

    # --------------------------------------------------------- wire

    def _recv(self) -> dict:
        try:
            frame = protocol.read_frame(self._reader)
        except protocol.ProtocolError as e:
            raise GatewayClosed(f"unreadable frame: {e}")
        if frame is None:
            raise GatewayClosed("connection closed by gateway")
        return frame

    def request(self, msg: dict) -> dict:
        """Send one frame, return its (id-matched) reply. Unsolicited
        frames (``goodbye``) surface as :class:`GatewayClosed`."""
        self._next_id += 1
        msg = dict(msg, id=self._next_id)
        try:
            self.sock.sendall(protocol.encode_frame(msg))
        except OSError:
            raise GatewayClosed("send failed: connection closed")
        while True:
            reply = self._recv()
            if reply.get("type") == "goodbye":
                raise GatewayClosed(
                    f"gateway said goodbye "
                    f"({reply.get('reason', '?')})")
            if reply.get("id") == self._next_id:
                if reply.get("type") == "error":
                    _raise_error(reply)
                return reply
            # a reply to nothing we asked: protocol confusion
            raise GatewayClosed(f"unexpected frame {reply!r}")

    # -------------------------------------------------------- games

    def new_game(self, board: int | None = None,
                 komi: float | None = None) -> dict:
        msg: dict = {"type": "new_game"}
        if board is not None:
            msg["board"] = int(board)
        if komi is not None:
            msg["komi"] = float(komi)
        return self.request(msg)

    def play(self, color: str, vertex: str) -> dict:
        return self.request({"type": "play", "color": color,
                             "move": vertex})

    def genmove(self, color: str) -> dict:
        return self.request({"type": "genmove", "color": color})

    def set_komi(self, komi: float) -> dict:
        return self.request({"type": "komi", "komi": float(komi)})

    def close_game(self) -> dict:
        return self.request({"type": "close"})

    def close(self) -> None:
        # the makefile reader holds a reference on the underlying fd:
        # closing only the socket object would leave the fd open (no
        # FIN) and the server's handler blocked in readline forever
        try:
            self._reader.close()
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def connect_with_retry(host: str, port: int, *, timeout: float = 60.0,
                       attempts: int = 6, base_delay: float = 0.25,
                       max_delay: float = 5.0, seed: int = 0,
                       sleep=time.sleep) -> GatewayClient:
    """Connect like :class:`GatewayClient`, but ride out sheds.

    A :class:`GatewayRefused` (``overload``/``draining``) or a
    dropped connection retries on the shared reconnect/backoff loop,
    sleeping at least the refusal's ``retry_after_s`` each round;
    the final attempt's exception propagates unchanged. ``sleep`` is
    injectable so tests assert the schedule instead of waiting it.
    """
    return net_client.call_with_backoff(
        lambda: GatewayClient(host, port, timeout=timeout),
        attempts=attempts, base_delay=base_delay,
        max_delay=max_delay, seed=seed, key="gateway.connect",
        sleep=sleep)


class GameLog:
    """Enough client-side state to reconstruct a live game on
    another replica: the admitted board/komi plus every landed move
    in order (:class:`ResilientGatewayClient` replays it)."""

    def __init__(self):
        self.active = False
        self.board: int | None = None
        self.komi: float | None = None
        self.moves: list = []          # (color, vertex) play order

    def start(self, board, komi) -> None:
        self.active = True
        self.board = board
        self.komi = komi
        self.moves = []

    def play(self, color: str, vertex: str) -> None:
        self.moves.append((color, vertex))

    def set_komi(self, komi) -> None:
        self.komi = komi

    def clear(self) -> None:
        self.active = False
        self.board = None
        self.komi = None
        self.moves = []

    def replay(self, client) -> None:
        """Re-create the game on ``client`` (a fresh connection to
        any replica serving the same board)."""
        client.new_game(board=self.board, komi=self.komi)
        for color, vertex in self.moves:
            client.play(color, vertex)


class ResilientGatewayClient:
    """A :class:`GatewayClient` surface that survives a drain, a
    kill or a shed transparently.

    Every request runs inside the shared
    :func:`~rocalphago_tpu_torch.net.client.call_with_backoff` loop: a
    dropped connection (:class:`GatewayClosed`: a drain nudge, a
    kill) or a structured refusal
    (:class:`GatewayRefused`, honoring its ``retry_after_s``)
    reconnects, replays the live game from the :class:`GameLog`, and
    retries the in-flight request. Typed game errors
    (``illegal_move``, ``game_over`` …) propagate unchanged — they
    are answers, not outages. ``reconnects`` counts recoveries.
    """

    def __init__(self, host: str, port: int, timeout: float = 60.0,
                 attempts: int = 6, base_delay: float = 0.25,
                 max_delay: float = 5.0, seed: int = 0,
                 sleep=time.sleep):
        self.host = host
        self.port = port
        self.timeout = timeout
        self._retry = dict(attempts=attempts, base_delay=base_delay,
                           max_delay=max_delay, seed=seed,
                           sleep=sleep)
        self.log = GameLog()
        self.reconnects = 0
        self._client = connect_with_retry(host, port,
                                          timeout=timeout,
                                          **self._retry)
        self.hello = self._client.hello
        self.boards = self._client.boards
        self.default_board = self._client.default_board

    # --------------------------------------------------------- wire

    def _reconnect(self) -> None:
        self._client = connect_with_retry(self.host, self.port,
                                          timeout=self.timeout,
                                          **self._retry)
        self.reconnects += 1
        if self.log.active:
            self.log.replay(self._client)

    def _request(self, msg: dict) -> dict:
        def attempt():
            if self._client is None:
                self._reconnect()
            try:
                return self._client.request(dict(msg))
            except (GatewayRefused, GatewayClosed):
                # this connection is spent; the next attempt starts
                # clean (reconnect + replay)
                client, self._client = self._client, None
                client.close()
                raise

        return net_client.call_with_backoff(
            attempt, key="gateway.reconnect", **self._retry)

    # -------------------------------------------------------- games

    def new_game(self, board: int | None = None,
                 komi: float | None = None) -> dict:
        msg: dict = {"type": "new_game"}
        if board is not None:
            msg["board"] = int(board)
        if komi is not None:
            msg["komi"] = float(komi)
        reply = self._request(msg)
        self.log.start(reply.get("board"), reply.get("komi"))
        return reply

    def play(self, color: str, vertex: str) -> dict:
        reply = self._request({"type": "play", "color": color,
                               "move": vertex})
        self.log.play(color, vertex)
        return reply

    def genmove(self, color: str) -> dict:
        reply = self._request({"type": "genmove", "color": color})
        if reply.get("type") == "move":
            self.log.play(color, reply.get("move"))
        return reply

    def set_komi(self, komi: float) -> dict:
        reply = self._request({"type": "komi", "komi": float(komi)})
        self.log.set_komi(float(komi))
        return reply

    def close_game(self) -> dict:
        reply = self._request({"type": "close"})
        self.log.clear()
        return reply

    def close(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None


# ------------------------------------------------------ load generator


def drive_game(client: GatewayClient, moves: int,
               board: int | None = None,
               latencies: list | None = None) -> int:
    """One synthetic game: alternate-color genmoves until ``moves``
    moves landed (re-opening on natural game end). Returns the move
    count; per-genmove wall times append to ``latencies``."""
    client.new_game(board=board)
    colors = ("b", "w")
    done = 0
    while done < moves:
        try:
            t0 = time.monotonic()
            client.genmove(colors[done % 2])
            if latencies is not None:
                latencies.append(time.monotonic() - t0)
            done += 1
        except GatewayError as e:
            if e.code != "game_over":
                raise
            client.new_game(board=board)
    client.close_game()
    return done


def run_load(host: str, port: int, conns: int, moves: int,
             board: int | None = None,
             timeout: float = 120.0) -> dict:
    """N concurrent synthetic games against a gateway.

    Barrier-started so every connection ramps together (the same
    idiom as the reference's serve benchmark). Returns moves/sheds/
    disconnect/error counts, the elapsed wall time and every
    per-genmove latency.
    """
    start = threading.Barrier(conns + 1)
    lock = threading.Lock()
    out = {"moves": 0, "sheds": 0, "disconnects": 0, "errors": 0,
           "latencies_s": []}

    def worker():
        lat: list = []
        sheds = drops = errors = 0
        try:
            start.wait(timeout)
            client = GatewayClient(host, port, timeout=timeout)
            try:
                drive_game(client, moves, board=board,
                           latencies=lat)
            finally:
                client.close()
        except GatewayRefused:
            sheds = 1
        except GatewayClosed:
            drops = 1
        except Exception:  # noqa: BLE001 — counted, load goes on
            errors = 1
        with lock:
            # len(lat) counts the moves that actually landed, even
            # when the game was cut short by a kill or drain
            out["moves"] += len(lat)
            out["sheds"] += sheds
            out["disconnects"] += drops
            out["errors"] += errors
            out["latencies_s"].extend(lat)

    threads = [threading.Thread(target=worker,
                                name=f"gateway-load-{i}")
               for i in range(conns)]
    for t in threads:
        t.start()
    t0 = time.monotonic()
    start.wait(timeout)
    for t in threads:
        t.join(timeout=timeout)
    out["elapsed_s"] = time.monotonic() - t0
    return out
