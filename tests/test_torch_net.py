"""The port's shared wire core (``rocalphago_tpu_torch/net``) against
the reference's (``rocalphago_tpu/net``), on the CPU; no pool.

Both packages speak one wire, so the bar is byte equality: over a table
of frames, ``encode_frame`` writes the reference's bytes and
``read_frame`` returns the reference's dict, ``None`` or
``ProtocolError(code, fatal)``, frame after frame off the same stream.
``error_frame`` builds the same refusals and rejects the same codes;
``default_transient`` classifies the same exceptions; ``call_with_backoff``
sleeps the reference's schedule for the same seed and key, with and
without a refusal's ``retry_after_s``. The ``LineServerCore`` of each
package echoes, sheds past its cap and drains with the same bytes on
the wire and the same events, and a frame either core sends is read by
the other package's reader into the same dict.
"""

import io
import socket
import threading
import time

import pytest

from rocalphago_tpu.gateway import client as ref_gw_client
from rocalphago_tpu.net import client as ref_client
from rocalphago_tpu.net import protocol as ref_protocol
from rocalphago_tpu.net import server as ref_server
from rocalphago_tpu_torch.gateway import client as gw_client
from rocalphago_tpu_torch.net import client, protocol, server

LIMIT = 32
CODES = ("bad_request", "overload", "draining", "internal")

FRAMES = [
    {"type": "new_game", "id": 3, "board": 5, "komi": 5.5},
    {"z": 1, "a": 2, "m": {"y": [1, 2.5, None], "b": True}},
    {"type": "play", "color": "b", "move": "pass"},
    {"msg": "héllo wörld ☃ 碁", "type": "error", "code": "internal"},
    {"type": "move", "elapsed_ms": 12.345, "slo_hit": False, "rung": None},
    {"nested": {"k": {"deep": [{"x": -0.0}, 1e-300, 1e300]}}},
    {},
]

# (name, wire bytes): each read off one stream until a disconnect or
# a fatal error
STREAMS = [
    ("empty", b""),
    ("one frame", b'{"type": "ok"}\n'),
    ("unsorted keys", b'{"b": 1, "a": 2}\n'),
    ("unicode escapes", b'{"s": "\\u00e9\\u2603"}\n'),
    ("raw utf-8", '{"s": "碁"}\n'.encode("utf-8")),
    ("torn tail", b'{"type": "ok"}\n{"type": "o'),
    ("torn only", b'{"type": "ok"'),
    ("blank lines", b"\n\n" + b'{"type": "ok"}\n' + b"\n"),
    ("blank then torn", b"\n \n\t\n"),
    ("crlf", b'{"type": "ok"}\r\n'),
    ("exactly the limit", b'{"a": "' + b"x" * 22 + b'"}\n'),
    ("limit + 1 with the newline", b'{"a": "' + b"x" * 23 + b'"}\n'),
    ("over the limit mid-line", b'{"pad": "' + b"x" * 100 + b'"}\n'),
    ("blank line at the limit", b" " * (LIMIT - 1) + b"\n{}\n"),
    ("bad json", b"{oops}\n" + b'{"type": "ok"}\n'),
    ("a list", b"[1, 2]\n"),
    ("a string", b'"str"\n'),
    ("a number", b"7\n"),
    ("null", b"null\n"),
    ("bad utf-8", b'{"s": "\xff\xfe"}\n'),
    ("two frames", b'{"id": 1}\n{"id": 2}\n'),
]


def read_all(mod, wire: bytes, limit: int = LIMIT) -> list:
    """Every outcome of ``read_frame`` over one stream: dicts, then
    ``None`` or the error's ``(code, fatal)``; stops at a disconnect or
    a fatal error (a non-fatal error reads on)."""
    reader = io.BytesIO(wire)
    out = []
    for _ in range(16):
        try:
            frame = mod.read_frame(reader, limit)
        except mod.ProtocolError as e:
            out.append(("error", e.code, e.fatal, str(e)))
            if e.fatal:
                break
            continue
        out.append(frame)
        if frame is None:
            break
    return out


@pytest.mark.parametrize("msg", FRAMES, ids=range(len(FRAMES)))
def test_encode_frame_is_the_references_bytes(msg):
    wire = protocol.encode_frame(msg)
    assert wire == ref_protocol.encode_frame(msg)
    assert wire.endswith(b"\n") and wire.count(b"\n") == 1
    assert wire == protocol.encode_frame(dict(reversed(msg.items())))
    assert protocol.read_frame(io.BytesIO(wire), 1 << 16) == msg


@pytest.mark.parametrize("name,wire", STREAMS, ids=[s[0] for s in STREAMS])
def test_read_frame_is_the_references(name, wire):
    got = read_all(protocol, wire)
    assert got == read_all(ref_protocol, wire), name
    assert got, name


def test_read_frame_rules():
    """The rules the table holds both packages to, stated."""
    exact, over = STREAMS[10][1], STREAMS[11][1]
    assert len(exact) == LIMIT and len(over) == LIMIT + 1
    assert read_all(protocol, exact) == [{"a": "x" * 22}, None]
    assert read_all(protocol, over)[0][1:3] == ("frame_too_big", True)
    assert read_all(protocol, b'{"type": "o') == [None]
    assert read_all(protocol, b"\n\n{}\n\n") == [{}, None]
    for bad in (b"{oops}\n", b"[1]\n", b"7\n"):
        assert read_all(protocol, bad)[0][1:3] == ("bad_request", False)


@pytest.mark.parametrize("args", [
    ("overload", "full", 7, 1.0),
    ("draining", "bye", None, 0.12345),
    ("internal", "boom", "abc", None),
    ("bad_request", "", 0, 2),
    ("overload", "x", None, 1e-4),
])
def test_error_frame_is_the_references(args):
    code, msg, rid, retry = args
    got = protocol.error_frame(code, msg, id=rid, retry_after_s=retry,
                               codes=CODES)
    assert got == ref_protocol.error_frame(code, msg, id=rid,
                                           retry_after_s=retry, codes=CODES)
    assert protocol.encode_frame(got) == ref_protocol.encode_frame(got)


def test_error_frame_enforces_the_vocabulary():
    for mod in (protocol, ref_protocol):
        with pytest.raises(AssertionError):
            mod.error_frame("not_a_code", "nope", codes=CODES)
        # without a vocabulary any code passes, as in the reference
        assert mod.error_frame("anything", "m") == {
            "type": "error", "code": "anything", "msg": "m"}


class _Hinted(Exception):
    def __init__(self, hint):
        super().__init__("hinted")
        self.retry_after_s = hint


class ThingClosed(Exception):
    pass


class ThingRefused(Exception):
    pass


EXCEPTIONS = [
    OSError("x"), TimeoutError(), ConnectionResetError(),
    ConnectionRefusedError(), socket.timeout(), BrokenPipeError(),
    ValueError("x"), RuntimeError("x"), KeyError(1), AssertionError(),
    KeyboardInterrupt(), _Hinted(None), _Hinted(0.5), ThingClosed(),
    ThingRefused(), gw_client.GatewayClosed("x"),
    gw_client.GatewayRefused("overload", "x", retry_after_s=1.0),
    gw_client.GatewayError("illegal_move", "x"),
    gw_client.GatewayError("overload", "x", retry_after_s=1.0),
    ref_gw_client.GatewayClosed("x"),
    ref_gw_client.GatewayRefused("draining", "x", retry_after_s=1.0),
    ref_gw_client.GatewayError("internal", "x"),
]


@pytest.mark.parametrize("exc", EXCEPTIONS,
                         ids=[f"{i}-{type(e).__name__}"
                              for i, e in enumerate(EXCEPTIONS)])
def test_default_transient_is_the_references(exc):
    assert client.default_transient(exc) == ref_client.default_transient(exc)


def schedule(mod, fails: list, **kw):
    """The sleeps of ``mod.call_with_backoff`` over a function raising
    ``fails`` in turn, then returning; and the outcome."""
    sleeps = []
    it = iter(fails)

    def fn():
        e = next(it, None)
        if e is not None:
            raise e
        return "done"

    try:
        out = mod.call_with_backoff(fn, sleep=sleeps.append, **kw)
    except Exception as e:  # noqa: BLE001 -- compared below
        out = (type(e).__name__, str(e))
    return sleeps, out


@pytest.mark.parametrize("case", [
    dict(fails=[OSError("a")] * 5),
    dict(fails=[OSError("a")] * 5, seed=7, key="gateway.connect"),
    dict(fails=[OSError("a")] * 3, base_delay=0.01, max_delay=0.05,
         key="gateway.reconnect"),
    dict(fails=[_Hinted(1.0), OSError("b"), _Hinted(0.01)], seed=3),
    dict(fails=[_Hinted(2.5)] * 6, attempts=6),
    dict(fails=[OSError("a"), ValueError("bug")]),
    dict(fails=[OSError("a")] * 3, attempts=3),
    dict(fails=[ThingClosed()] * 2, transient=lambda e: True),
    dict(fails=[OSError("a")], transient=lambda e: False),
], ids=range(9))
def test_call_with_backoff_sleeps_the_references_schedule(case):
    got = schedule(client, **case)
    assert got == schedule(ref_client, **case)
    hints = [getattr(e, "retry_after_s", None) for e in case["fails"]]
    for s, h in zip(got[0], hints):
        assert h is None or s >= h


def test_call_with_backoff_needs_an_attempt():
    for mod in (client, ref_client):
        with pytest.raises(ValueError):
            mod.call_with_backoff(lambda: 1, attempts=0)


# --------------------------------------------------------- the core


class Recorder:
    """A ``MetricsLogger``-shaped sink."""

    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append((event, fields))


class Count:
    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def set(self, v):
        self.value = v


def echo_core(pkg_server, pkg_protocol, **kw):
    """A core whose handler says hello, then echoes each frame back
    with ``echo: true``; refusals carry ``retry_after_s`` 1.0."""
    metrics = Recorder()
    gauges = dict(live_gauge=Count(), accepted_counter=Count(),
                  shed_counter=Count())

    def handler(conn, reader, cid):
        core.send(conn, {"type": "hello", "cid": cid})
        while True:
            if core.draining:
                core.send(conn, {"type": "goodbye", "reason": "draining"})
                return
            try:
                msg = pkg_protocol.read_frame(reader, 1024)
            except pkg_protocol.ProtocolError as e:
                core.send(conn, pkg_protocol.error_frame(e.code, str(e)))
                if e.fatal:
                    return
                continue
            if msg is None:
                return
            time.sleep(msg.get("sleep", 0))     # a request in flight
            core.send(conn, dict(msg, echo=True))

    def refusal(code):
        return pkg_protocol.error_frame(code, f"echo {code}",
                                        retry_after_s=1.0)

    core = pkg_server.LineServerCore(handler=handler, refusal=refusal,
                                     name="echo", metrics=metrics,
                                     **gauges, **kw)
    return core.start(), metrics, gauges


def settle(core, timeout=10.0):
    deadline = time.monotonic() + timeout
    while core.counters()["live"] and time.monotonic() < deadline:
        time.sleep(0.01)
    assert core.counters()["live"] == 0, core.counters()


def recv_line(sock_file) -> bytes:
    return sock_file.readline(1 << 16)


def conversation(port: int) -> list:
    """Raw bytes of one echo conversation: hello, frames (one bad, one
    blank line), then an oversized line that drops the connection."""
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        f = s.makefile("rb")
        out.append(recv_line(f))
        for wire in (protocol.encode_frame({"b": 1, "a": "é"}), b"\n",
                     b"{nope\n", protocol.encode_frame({"id": 9}),
                     b'{"pad": "' + b"x" * 2000 + b'"}\n'):
            s.sendall(wire)
            if wire.strip():
                out.append(recv_line(f))
        out.append(recv_line(f))            # the drop: EOF
        f.close()
    return out


def test_line_server_cores_echo_the_same_bytes():
    port_core, _, _ = echo_core(server, protocol)
    ref_core, _, _ = echo_core(ref_server, ref_protocol)
    try:
        got = conversation(port_core.port)
        assert got == conversation(ref_core.port)
        assert got[-1] == b"" and b"frame_too_big" in got[-2]
        settle(port_core)
        settle(ref_core)
        assert port_core.counters() == ref_core.counters() == {
            "live": 0, "accepted": 1, "shed": 0, "draining": False}
    finally:
        port_core.drain()
        ref_core.drain()


def test_frames_cross_between_the_packages():
    """A frame the port's core sends reads with the reference's reader
    into the same dict, and the reverse."""
    msg = {"type": "play", "color": "w", "move": "C3", "id": 4,
           "note": "ünïcode"}
    for core_pkg, reader_pkg in ((server, ref_protocol),
                                 (ref_server, protocol)):
        core, _, _ = echo_core(core_pkg, reader_pkg)
        try:
            with socket.create_connection(("127.0.0.1", core.port),
                                          timeout=10) as s:
                f = s.makefile("rb")
                assert reader_pkg.read_frame(f, 1024) == {"type": "hello",
                                                          "cid": 0}
                s.sendall(reader_pkg.encode_frame(msg))
                assert reader_pkg.read_frame(f, 1024) == dict(msg, echo=True)
                f.close()
            settle(core)
        finally:
            core.drain()


def test_cores_shed_past_the_cap_and_drain_alike():
    def run(pkg_server, pkg_protocol):
        core, metrics, gauges = echo_core(pkg_server, pkg_protocol,
                                          max_conns=1, drain_s=2.0)
        held = socket.create_connection(("127.0.0.1", core.port), timeout=10)
        hf = held.makefile("rb")
        hello = recv_line(hf)
        with socket.create_connection(("127.0.0.1", core.port),
                                      timeout=10) as s:
            f = s.makefile("rb")
            shed = [recv_line(f), recv_line(f)]
            f.close()
        counters = core.counters()
        # a request in flight when the drain starts: its reply, then
        # goodbye; an idle connection is only nudged (EOF)
        held.sendall(pkg_protocol.encode_frame({"sleep": 0.6}))
        time.sleep(0.2)
        t = threading.Thread(target=core.drain, kwargs={"reason": "test"})
        t.start()
        bye = [recv_line(hf), recv_line(hf), recv_line(hf)]
        t.join(timeout=30)
        hf.close()
        held.close()
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", core.port), timeout=2.0)
        core.drain(reason="again")           # idempotent
        return dict(hello=hello, shed=shed, counters=counters, bye=bye,
                    after=core.counters(), events=metrics.events,
                    gauges={k: g.value for k, g in gauges.items()})

    got = run(server, protocol)
    assert got == run(ref_server, ref_protocol)
    assert protocol.read_frame(io.BytesIO(got["shed"][0]), 1024) == {
        "type": "error", "code": "overload", "msg": "echo overload",
        "retry_after_s": 1.0}
    assert got["shed"][1] == b""
    assert got["bye"] == [
        protocol.encode_frame({"sleep": 0.6, "echo": True}),
        protocol.encode_frame({"type": "goodbye", "reason": "draining"}), b""]
    assert [e for e, _ in got["events"]] == ["drain"] * 3
    assert [f["phase"] for _, f in got["events"]] == [
        "echo_requested", "echo_accept_stopped", "echo_drained"]
    assert got["events"][0][1]["reason"] == "test"
    assert got["events"][2][1]["live_conns"] == 0
    assert got["counters"] == {"live": 1, "accepted": 1, "shed": 1,
                               "draining": False}
    assert got["gauges"] == {"live_gauge": 0, "accepted_counter": 1,
                             "shed_counter": 1}
