"""The shared line-server core: accept, admit, hand off, drain.

A copy of the reference package's ``net/server.py``.
:class:`LineServerCore` is the timeout-listener accept loop, the
structured admission refusal (``overload``/``draining`` error frames,
never a hang), the per-connection handler threads and registry, and the
bounded three-step graceful drain. It is **composed, not inherited**:
the owning server passes its conversation handler and its refusal-frame
function in and keeps its own lock for its own request counters; the
core keeps its own lock for the connection registry (two small locks
with no nesting). The locks are plain ``threading.Lock``\\ s; each
attribute they guard says so in a ``# guarded-by:`` comment.

What the owner supplies:

* ``handler(conn, reader, cid)`` -- the whole conversation, run on a
  dedicated thread; the core closes the socket and unregisters the
  connection when it returns (the owner's fault wall lives inside);
* ``refusal(code)`` -- builds the typed error frame for an at-accept
  shed (``code`` is ``"overload"`` or ``"draining"``); the owner counts
  the error and attaches its ``retry_after_s``;
* optional live/accepted/shed metrics instruments (the owner names
  them).

Drain, in three bounded steps: stop accepting (close the listener --
its 0.2 s timeout is the only portable way to pop a blocked
``accept()``), nudge idle connections with a read-side shutdown and
join handlers within ``drain_s``, then cut stragglers with
``SHUT_RDWR`` + close, re-snapshotting the registry until it empties or
the tail expires. Phase events land on the owner's metrics logger as
``{name}_requested`` / ``{name}_accept_stopped`` / ``{name}_drained``.
"""

from __future__ import annotations

import socket
import threading

from rocalphago_tpu_torch.net import protocol
from rocalphago_tpu_torch.runtime.deadline import Deadline


class LineServerCore:
    """Threaded NDJSON accept/admission/drain core (module docstring).
    ``port=0`` binds an ephemeral port; ``name`` prefixes thread names
    and drain-phase events."""

    def __init__(self, *, host: str = "127.0.0.1", port: int = 0,
                 max_conns: int = 64, drain_s: float = 10.0,
                 handler, refusal, name: str = "net", metrics=None,
                 live_gauge=None, accepted_counter=None,
                 shed_counter=None):
        self.host = host
        self._port_arg = int(port)
        self.max_conns = int(max_conns)
        self.drain_s = float(drain_s)
        self.metrics = metrics
        self.name = name
        self._handler = handler
        self._refusal = refusal
        self._live_g = live_gauge
        self._acc_c = accepted_counter
        self._shed_c = shed_counter
        self._lock = threading.Lock()
        self._conns: dict = {}       # guarded-by: self._lock
        self._live = 0               # guarded-by: self._lock
        self._next_cid = 0           # guarded-by: self._lock
        self._accepted = 0           # guarded-by: self._lock
        self._shed = 0               # guarded-by: self._lock
        self._draining = False       # guarded-by: self._lock
        self._sock: socket.socket | None = None
        self._bound_port: int | None = None
        self._accept_thread: threading.Thread | None = None

    # ------------------------------------------------------ lifecycle

    def start(self) -> "LineServerCore":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self._port_arg))
        s.listen(128)
        # a timeout on the listener is the only portable way to wake the
        # accept loop on drain: closing a socket from another thread
        # does NOT interrupt a blocked accept() on Linux
        s.settimeout(0.2)
        self._sock = s
        self._bound_port = s.getsockname()[1]
        t = threading.Thread(target=self._accept_loop,
                             name=f"{self.name}-accept")
        t.start()
        self._accept_thread = t
        return self

    @property
    def port(self) -> int:
        # cached at bind time so the address survives drain (the
        # listener socket is closed first)
        return self._bound_port

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def counters(self) -> dict:
        """Snapshot for the owner's probe: live/accepted/shed
        connections plus the draining flag."""
        with self._lock:
            return {"live": self._live, "accepted": self._accepted,
                    "shed": self._shed, "draining": self._draining}

    def _emit(self, phase: str, **fields) -> None:
        if self.metrics is not None:
            self.metrics.log("drain", phase=phase, **fields)

    def drain(self, reason: str = "requested",
              timeout: float | None = None) -> None:
        """Graceful stop: refuse new work, finish what is in flight,
        quiesce every handler thread (module docstring). Idempotent;
        bounded by ``timeout`` (default ``drain_s``)."""
        timeout = self.drain_s if timeout is None else timeout
        with self._lock:
            already = self._draining
            self._draining = True
        if already:
            return
        self._emit(f"{self.name}_requested", reason=reason)
        # 1. stop accepting: closing the listener pops the accept loop
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        self._emit(f"{self.name}_accept_stopped")
        # 2. nudge idle connections: a read-side shutdown EOFs their
        # next readline; handlers finish the request in flight, say
        # goodbye on the still-open write side and return
        with self._lock:
            conns = list(self._conns.values())
        for conn, _t in conns:
            try:
                conn.shutdown(socket.SHUT_RD)
            except OSError:
                pass
        deadline = Deadline.after(timeout)
        for _conn, t in conns:
            t.join(timeout=max(0.05, deadline.remaining() or 0.05))
        # 3. stragglers -- connections admitted just before _draining
        # was set and registered after step 2's snapshot included -- get
        # the read-side nudge again plus the write side cut; close()
        # alone does not wake a blocked readline on Linux, so loop the
        # shutdown until _conns empties or the tail expires
        tail = Deadline.after(5.0)
        while True:
            with self._lock:
                leftover = list(self._conns.values())
            if not leftover or tail.expired():
                break
            for conn, _t in leftover:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
            for _conn, t in leftover:
                t.join(timeout=max(0.05, tail.remaining() or 0.05))
        with self._lock:
            live = self._live
        self._emit(f"{self.name}_drained", live_conns=live)

    # -------------------------------------------------------- accept

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                with self._lock:
                    if self._draining:
                        return
                continue
            except OSError:
                return                 # listener closed: drain/close
            with self._lock:
                refuse = None
                if self._draining:
                    refuse = "draining"
                elif self._live >= self.max_conns:
                    refuse = "overload"
                    self._shed += 1
                else:
                    self._live += 1
                    self._accepted += 1
                    cid = self._next_cid
                    self._next_cid += 1
                if self._live_g is not None:
                    self._live_g.set(self._live)
            if refuse is not None:
                if refuse == "overload" and self._shed_c is not None:
                    self._shed_c.inc()
                self.send(conn, self._refusal(refuse))
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            if self._acc_c is not None:
                self._acc_c.inc()
            t = threading.Thread(target=self._run_conn,
                                 args=(conn, cid),
                                 name=f"{self.name}-conn-{cid}")
            with self._lock:
                self._conns[cid] = (conn, t)
            t.start()

    # ------------------------------------------------------- handler

    def send(self, conn, msg: dict) -> bool:
        """One frame onto one socket; False when the peer is gone
        mid-reply (the handler treats that as a disconnect)."""
        try:
            conn.sendall(protocol.encode_frame(msg))
            return True
        except (OSError, ValueError):
            return False

    def _run_conn(self, conn, cid: int) -> None:
        reader = conn.makefile("rb")
        try:
            self._handler(conn, reader, cid)
        finally:
            try:
                reader.close()     # drops the makefile's fd reference
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                self._conns.pop(cid, None)
                self._live = max(0, self._live - 1)
                if self._live_g is not None:
                    self._live_g.set(self._live)
