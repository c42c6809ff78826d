"""The port's play gateway (``rocalphago_tpu_torch/gateway``) and GTP
``--connect`` against the reference's, on the CPU.

Both packages serve one wire, so the bar is byte equality of frames.
The reference's pool and the port's run on the same 2 × 8 float32 5×5
nets (carried across with ``params_from_flax``), one connection at a
time, so each genmove is a batch of one and both searches pick the
same move (``tests/test_torch_serve.py`` holds the pools' root visits
equal). Over raw sockets, one scripted conversation gives the same
frames from both servers, ``elapsed_ms`` aside; the same script passes
through either package's client to either package's server; every
refusal, both fault kinds and the drain write the same frames and
events; the probes' schemas and the ``gateway_*`` series are the
reference's; multi-size routing, the GTP bridge's transcripts and the
reconnecting client's backoff schedule are the reference's. The
gateway CLI raises with no card unless ``--device cpu``, and then
serves and drains on SIGTERM. No wall-clock SLO tighter than 30 s is
asserted: the servers' SLO is 30 s, never hit.
"""

import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.gateway import client as ref_client
from rocalphago_tpu.gateway import protocol as ref_protocol
from rocalphago_tpu.gateway.httpapi import GatewayHTTP as RefHTTP
from rocalphago_tpu.gateway.server import GatewayServer as RefServer
from rocalphago_tpu.interface import gtp as ref_gtp
from rocalphago_tpu.io.metrics import MetricsLogger as RefMetrics
from rocalphago_tpu.models import CNNPolicy as RefPolicy
from rocalphago_tpu.models import CNNValue as RefValue
from rocalphago_tpu.multisize import MultiSizePool as RefMultiSize
from rocalphago_tpu.obs import registry as ref_registry
from rocalphago_tpu.runtime import faults as ref_faults
from rocalphago_tpu.serve import ServePool as RefPool
from rocalphago_tpu_torch.gateway import client, protocol
from rocalphago_tpu_torch.gateway.httpapi import GatewayHTTP
from rocalphago_tpu_torch.gateway.server import GatewayServer
from rocalphago_tpu_torch.interface import gtp
from rocalphago_tpu_torch.io.metrics import MetricsLogger, read_jsonl
from rocalphago_tpu_torch.models import CNNPolicy, CNNValue
from rocalphago_tpu_torch.models.weights import params_from_flax
from rocalphago_tpu_torch.multisize import MultiSizePool
from rocalphago_tpu_torch.obs import registry
from rocalphago_tpu_torch.runtime import faults
from rocalphago_tpu_torch.serve import ServePool
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 5
FEATS = ("board", "ones")
VFEATS = FEATS + ("color",)
N_SIM = 8
SLO_MS = 30000.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUCT = os.path.join(ROOT, "results/zero_r5/target_compare/puct")

# each package's modules, side by side
PORT = dict(name="port", protocol=protocol, client=client, server=GatewayServer,
            http=GatewayHTTP, faults=faults, registry=registry, gtp=gtp,
            metrics=MetricsLogger)
REF = dict(name="ref", protocol=ref_protocol, client=ref_client,
           server=RefServer, http=RefHTTP, faults=ref_faults,
           registry=ref_registry, gtp=ref_gtp, metrics=RefMetrics)


@pytest.fixture(autouse=True)
def _clean_fault_plans():
    yield
    faults.install(None)
    ref_faults.install(None)


@pytest.fixture(scope="module")
def nets():
    """2 × 8 FCN nets of both packages, carried across in float32."""
    kw = dict(board=SIZE, layers=2, filters_per_layer=8)
    with jax.enable_checks(False):
        rp = RefPolicy(FEATS, seed=1, **kw)
        rv = RefValue(VFEATS, seed=2, **kw)
        pp = CNNPolicy(FEATS, init_weights=False, device="cpu",
                       dtype=torch.float32, **kw)
        pv = CNNValue(VFEATS, init_weights=False, device="cpu",
                      dtype=torch.float32, **kw)
        for ref, port in ((rp, pp), (rv, pv)):
            ref.module = ref.module.clone(dtype=jnp.float32)
            ref._apply = jax.jit(ref.module.apply)
            port.module.load_state_dict(params_from_flax(
                jax.tree.map(np.asarray, ref.params)))
    return rp, rv, pp, pv


@pytest.fixture(scope="module")
def pools(nets):
    """One warm pool of each package; tests read stat DELTAS."""
    rp, rv, pp, pv = nets
    kw = dict(n_sim=N_SIM, max_sessions=4, batch_sizes=(1, 2, 4),
              max_wait_us=2000)
    with jax.enable_checks(False):
        ref = RefPool(rv, rp, **kw)
        ref.warm()
    port = ServePool(pv, pp, **kw)
    port.warm()
    yield {"port": port, "ref": ref}
    port.close()
    ref.close()


@pytest.fixture(scope="module")
def servers(pools):
    """One long-lived gateway of each package; shedding and drain tests
    build their own."""
    out = {k: (PORT if k == "port" else REF)["server"](
        p, max_conns=4, slo_ms=SLO_MS).start() for k, p in pools.items()}
    yield out
    for s in out.values():
        s.close()


def settle(server, pool=None, timeout: float = 10.0) -> None:
    """Wait until the gateway released every connection slot (and the
    pool every session): an abrupt close is observed at the server's
    next read, so admission asserts must not race it."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        live = server.stats()["conns"]["live"]
        pool_live = 0 if pool is None else pool.stats()["sessions"]["live"]
        if live == 0 and pool_live == 0:
            return
        time.sleep(0.02)
    raise AssertionError(f"gateway did not settle: {server.stats()['conns']}")


class Wire:
    """A frame-level client: raw reply lines, the hello first."""

    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=60.0)
        self.reader = self.sock.makefile("rb")
        self.hello = self.line()

    def line(self) -> bytes:
        return self.reader.readline(1 << 20)

    def send(self, raw: bytes, reply: bool = True) -> bytes | None:
        self.sock.sendall(raw)
        return self.line() if reply else None

    def req(self, msg: dict) -> bytes:
        return self.send(protocol.encode_frame(msg))

    def close(self) -> None:
        self.reader.close()
        self.sock.close()


def timeless(raw: bytes) -> bytes:
    """A reply line with ``elapsed_ms`` (the one wall-clock field) left
    out, re-encoded; any other line as it came."""
    if b'"elapsed_ms"' not in raw:
        return raw
    frame = json.loads(raw)
    assert frame.pop("elapsed_ms") >= 0.0
    return protocol.encode_frame(frame)


def vertex_besides(move: str) -> str:
    return next(v for v in ("C3", "B2", "D4") if v != move)


def scripted(port: int) -> list:
    """The byte-equality script over raw frames: hello, new_game with
    komi, genmove, play, komi, close, then a second game on the same
    connection."""
    w = Wire(port)
    try:
        out = [w.hello,
               w.req({"type": "hello", "id": 1, "proto": 1}),
               w.req({"type": "new_game", "id": 2, "komi": 6.5}),
               w.req({"type": "genmove", "id": 3, "color": "b"})]
        move = json.loads(out[-1])["move"]
        out += [w.req({"type": "play", "id": 4, "color": "w",
                       "move": vertex_besides(move)}),
                w.req({"type": "komi", "id": 5, "komi": 5.5}),
                w.req({"type": "close", "id": 6}),
                w.req({"type": "new_game", "id": 7}),
                w.req({"type": "genmove", "id": 8, "color": "w"}),
                w.req({"type": "play", "id": 9, "color": "b",
                       "move": "pass"}),
                w.req({"type": "genmove", "id": 10, "color": "w"}),
                w.req({"type": "close", "id": 11})]
    finally:
        w.close()
    return out


def test_scripted_conversation_is_byte_equal(servers, pools):
    port_pool = pools["port"]
    seen = []

    def hook(mod, args, out):
        seen.append((threading.current_thread().name,
                     torch.is_grad_enabled(), out.requires_grad))

    hooks = [m.register_forward_hook(hook)
             for m in port_pool.evaluator.version_params()]
    before = servers["port"].stats()
    try:
        got = scripted(servers["port"].port)
    finally:
        for h in hooks:
            h.remove()
    want = scripted(servers["ref"].port)
    assert got[0] == want[0] == ref_protocol.encode_frame(
        ref_protocol.hello_frame((SIZE,), SIZE, SLO_MS))
    assert [timeless(x) for x in got] == [timeless(x) for x in want]
    replies = [json.loads(x) for x in got]
    assert [r["type"] for r in replies] == [
        "hello", "ok", "ok", "move", "ok", "ok", "ok", "ok", "move", "ok",
        "move", "ok"]
    assert replies[3]["rung"] == "search" and replies[3]["slo_hit"] is False
    # the handler threads' genmoves built no autograd graph
    assert seen and not any(g or r for _, g, r in seen)
    for k in ("port", "ref"):
        settle(servers[k], pools[k])
    after = servers["port"].stats()
    assert after["requests"]["genmoves"] == before["requests"]["genmoves"] + 3
    assert after["requests"]["unhandled"] == before["requests"]["unhandled"]
    assert after["conns"]["accepted"] == before["conns"]["accepted"] + 1


def client_script(mod, port: int) -> list:
    """The same conversation through a package's ``GatewayClient``."""
    c = mod.GatewayClient("127.0.0.1", port)
    try:
        out = [c.hello, c.request({"type": "hello", "proto": 1}),
               c.new_game(komi=6.5), c.genmove("b")]
        out += [c.play("w", vertex_besides(out[-1]["move"])),
                c.set_komi(5.5), c.close_game(), c.new_game(),
                c.genmove("w"), c.close_game()]
    finally:
        c.close()
    for r in out:
        r.pop("elapsed_ms", None)
    return out


@pytest.mark.parametrize("client_pkg,server_key", [
    ("port", "ref"), ("ref", "port"), ("port", "port"), ("ref", "ref")])
def test_clients_and_servers_cross_packages(servers, pools, client_pkg,
                                            server_key):
    mod = client if client_pkg == "port" else ref_client
    got = client_script(mod, servers[server_key].port)
    assert got == client_script(ref_client, servers["ref"].port)
    settle(servers[server_key], pools[server_key])


# (name, requests): raw lines or dicts, a reply read for each but
# blank lines
REFUSALS = [
    ("bad_proto", [{"type": "hello", "id": 1, "proto": 99},
                   {"type": "hello", "id": 2}]),
    ("unknown_type", [{"type": "flarb", "id": 1}, {"id": 2},
                      {"type": "new_game", "id": 3},
                      {"type": "close", "id": 4}]),
    ("no_game", [{"type": "genmove", "id": 1, "color": "b"},
                 {"type": "play", "id": 2, "color": "b", "move": "C3"},
                 {"type": "komi", "id": 3, "komi": 7.5},
                 {"type": "close", "id": 4}]),
    ("illegal_move", [{"type": "new_game", "id": 1},
                      {"type": "play", "id": 2, "color": "b", "move": "C3"},
                      {"type": "play", "id": 3, "color": "w", "move": "C3"},
                      {"type": "play", "id": 4, "color": "w", "move": "Z9"},
                      {"type": "play", "id": 5, "color": "w", "move": "C"},
                      {"type": "play", "id": 6, "color": "x", "move": "B2"},
                      {"type": "play", "id": 7, "color": "w"},
                      {"type": "genmove", "id": 8, "color": "w"},
                      {"type": "genmove", "id": 9, "color": "q"},
                      {"type": "close", "id": 10}]),
    ("bad_board", [{"type": "new_game", "id": 1, "board": 9},
                   {"type": "genmove", "id": 2, "color": "b"}]),
    ("malformed_new_game", [{"type": "new_game", "id": i, "komi": "abc"}
                            for i in range(5)]
     + [{"type": "new_game", "id": 5, "komi": [6.5]},
        {"type": "new_game", "id": 6, "board": "five"},
        {"type": "new_game", "id": 7, "board": None},
        {"type": "genmove", "id": 8, "color": "b"}]),
    ("malformed_komi", [{"type": "new_game", "id": 1},
                        {"type": "komi", "id": 2, "komi": {"k": 1}},
                        {"type": "komi", "id": 3, "komi": "x"},
                        {"type": "genmove", "id": 4, "color": "b"},
                        {"type": "close", "id": 5}]),
    ("bad_json", [b"{this is not json\n", b"[1, 2]\n",
                  {"type": "hello", "id": 1, "proto": 1}]),
    ("blank_line", [b"\n", b"  \n", {"type": "hello", "id": 1,
                                     "proto": 1}]),
    ("no_id", [{"type": "close"}, {"type": "flarb"},
               {"type": "genmove", "color": "b"}]),
    ("game_over", [{"type": "new_game", "id": 1},
                   {"type": "play", "id": 2, "color": "b", "move": "pass"},
                   {"type": "play", "id": 3, "color": "w", "move": "pass"},
                   {"type": "genmove", "id": 4, "color": "b"},
                   {"type": "play", "id": 5, "color": "b", "move": "C3"},
                   {"type": "close", "id": 6},
                   {"type": "new_game", "id": 7}]),
    ("oversized", [b'{"pad": "' + b"x" * (protocol.max_frame_bytes() + 16)
                   + b'"}\n', b""]),
]


#: the refusal each case must show
EXPECTED = {"bad_proto": "bad_proto", "unknown_type": "unknown_type",
            "no_game": "no_game", "illegal_move": "illegal_move",
            "bad_board": "bad_board", "malformed_new_game": "bad_request",
            "malformed_komi": "bad_request", "bad_json": "bad_request",
            "blank_line": None, "no_id": "unknown_type",
            "game_over": "game_over", "oversized": "frame_too_big"}


def refusal_lines(port: int, requests) -> list:
    w = Wire(port)
    out = [w.hello]
    try:
        for r in requests:
            if r == b"":
                out.append(w.line())         # the drop: EOF
                continue
            raw = protocol.encode_frame(r) if isinstance(r, dict) else r
            out.append(w.send(raw, reply=bool(raw.strip())))
    finally:
        w.close()
    return out


@pytest.mark.parametrize("name,requests", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_every_refusal_is_the_references_frame(servers, pools, name,
                                               requests):
    before = servers["port"].stats()["requests"]
    got = refusal_lines(servers["port"].port, requests)
    want = refusal_lines(servers["ref"].port, requests)
    assert [timeless(x) for x in got if x] == [
        timeless(x) for x in want if x]
    assert got.count(None) == want.count(None)
    codes = [json.loads(x).get("code") for x in got if x]
    assert EXPECTED[name] in codes, codes
    if name == "oversized":
        assert got[-1] == b"" and codes[-1] == "frame_too_big"
    for k in ("port", "ref"):
        settle(servers[k], pools[k])
    after = servers["port"].stats()["requests"]
    assert after["unhandled"] == before["unhandled"]
    assert pools["port"].stats()["sessions"]["live"] == 0


def test_connection_cap_sheds_alike(pools):
    out = {}
    for pkg in (PORT, REF):
        pool = pools[pkg["name"]]
        srv = pkg["server"](pool, max_conns=1).start()
        try:
            hog = Wire(srv.port)
            shed = Wire(srv.port)
            out[pkg["name"]] = [hog.hello, shed.hello, shed.line()]
            shed.close()
            hog.close()
            settle(srv)
            readmitted = Wire(srv.port)
            readmitted.close()
            settle(srv)
            out[pkg["name"]].append(srv.stats()["conns"])
        finally:
            srv.close()
    assert out["port"] == out["ref"]
    frame = json.loads(out["port"][1])
    assert (frame["code"], frame["retry_after_s"]) == ("overload", 1.0)
    assert out["port"][2] == b""
    assert out["port"][3] == {"live": 0, "max": 1, "accepted": 2,
                              "shed": 1}


def test_pool_admission_cap_sheds_new_game_alike(pools):
    out = {}
    for pkg in (PORT, REF):
        pool = pools[pkg["name"]]
        srv = pkg["server"](pool, max_conns=8).start()
        wires = []
        try:
            for i in range(pool.stats()["sessions"]["max"]):
                wires.append(Wire(srv.port))
                wires[-1].req({"type": "new_game", "id": i})
            extra = Wire(srv.port)
            wires.append(extra)
            lines = [extra.req({"type": "new_game", "id": 9})]
            lines.append(wires[0].req({"type": "close", "id": 10}))
            lines.append(extra.req({"type": "new_game", "id": 11}))
            out[pkg["name"]] = lines + [srv.stats()["conns"]["shed"]]
        finally:
            for w in wires:
                w.close()
            settle(srv, pool)
            srv.close()
    assert out["port"] == out["ref"]
    frame = json.loads(out["port"][0])
    assert frame["code"] == "overload" and frame["retry_after_s"] == 1.0
    assert out["port"][3] == 1


def fault_lines(pkg, srv, plan_kill: str, plan_transient: str) -> list:
    pkg["faults"].install(None)
    w = Wire(srv.port)
    out = [w.req({"type": "new_game", "id": 1})]
    pkg["faults"].install(plan_transient)
    out.append(w.req({"type": "genmove", "id": 2, "color": "b"}))
    pkg["faults"].install(None)
    out.append(w.req({"type": "genmove", "id": 3, "color": "b"}))
    pkg["faults"].install(plan_kill)
    out.append(w.req({"type": "genmove", "id": 4, "color": "w"}))
    out.append(w.line())                     # dropped
    pkg["faults"].install(None)
    w.close()
    return out


def test_fault_plans_give_the_same_frames(servers, pools):
    kill, transient = ("kill@gateway.conn:p=1.0,seed=3",
                       "io_error@gateway.conn:p=1.0,seed=5")
    before = servers["port"].stats()
    got = fault_lines(PORT, servers["port"], kill, transient)
    settle(servers["port"], pools["port"])
    after = servers["port"].stats()
    want = fault_lines(REF, servers["ref"], kill, transient)
    settle(servers["ref"], pools["ref"])
    assert [timeless(x) for x in got] == [timeless(x) for x in want]
    assert [json.loads(x).get("code") for x in got[:4]] == [
        None, "internal", None, "internal"]
    assert got[-1] == b""
    assert after["faults"]["kills"] == before["faults"]["kills"] + 1
    assert after["faults"]["injected"] == before["faults"]["injected"] + 1
    assert after["requests"]["unhandled"] == before["requests"]["unhandled"]
    # the server lives on
    assert client_script(client, servers["port"].port)


def drain_run(pkg, pool, path) -> dict:
    metrics = pkg["metrics"](str(path), echo=False)
    srv = pkg["server"](pool, max_conns=4, metrics=metrics).start()
    http = pkg["http"](srv).start()
    idle = Wire(srv.port)
    busy = Wire(srv.port)
    out = {}
    try:
        idle.req({"type": "new_game", "id": 1})
        busy.req({"type": "new_game", "id": 1})
        # a request in flight when the drain starts: it is answered,
        # then goodbye; the idle connection is nudged out (EOF)
        pkg["faults"].install("sleep@gateway.conn=0.6")
        busy.send(protocol.encode_frame({"type": "genmove", "id": 2,
                                         "color": "b"}), reply=False)
        time.sleep(0.2)
        pkg["faults"].install(None)
        t = threading.Thread(target=srv.drain, kwargs={"reason": "test"})
        t.start()
        out["busy"] = [busy.line(), busy.line(), busy.line()]
        out["idle"] = idle.line()
        t.join(timeout=30)
        assert srv.draining
        settle(srv, pool)
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", srv.port), timeout=2.0)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{http.port}/healthz",
                                   timeout=10)
        out["status"] = ei.value.code
        body = json.loads(ei.value.read())
        out["health"] = (body["status"], body["gateway"]["draining"],
                         body["gateway"]["conns"]["live"])
        srv.drain(reason="again")            # idempotent
    finally:
        idle.close()
        busy.close()
        http.close()
        srv.close()
        metrics.close()
    out["events"] = [{k: v for k, v in r.items() if k != "time"}
                     for r in read_jsonl(str(path))]
    return out


def test_drain_writes_the_same_events(pools, tmp_path):
    got = drain_run(PORT, pools["port"], tmp_path / "port.jsonl")
    want = drain_run(REF, pools["ref"], tmp_path / "ref.jsonl")
    got["busy"] = [timeless(x) for x in got["busy"]]
    want["busy"] = [timeless(x) for x in want["busy"]]
    assert got == want
    assert json.loads(got["busy"][0])["type"] == "move"
    assert got["busy"][1:] == [protocol.encode_frame(
        {"type": "goodbye", "reason": "draining"}), b""]
    assert got["idle"] == b""
    assert got["status"] == 503 and got["health"] == ("draining", True, 0)
    assert [e["phase"] for e in got["events"]] == [
        "gateway_requested", "gateway_accept_stopped", "gateway_drained"]


def key_tree(d):
    """The nested key structure of a probe block."""
    if isinstance(d, dict):
        return {k: key_tree(v) for k, v in d.items()}
    return None


def test_probe_schemas_are_the_references(servers, pools):
    bodies = {}
    for pkg in (PORT, REF):
        srv = servers[pkg["name"]]
        http = pkg["http"](srv).start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{http.port}/healthz",
                    timeout=10) as r:
                assert r.status == 200
                bodies[pkg["name"]] = json.loads(r.read())
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"http://127.0.0.1:{http.port}/nope",
                                       timeout=10)
            assert ei.value.code == 404
        finally:
            http.close()
    port, ref = bodies["port"], bodies["ref"]
    assert set(port) == set(ref) == {"status", "serve", "gateway"}
    assert port["status"] == "ok"
    # the gateway block and the stats(), both ways (values are counts)
    assert key_tree(port["gateway"]) == key_tree(ref["gateway"])
    assert key_tree(servers["port"].stats()) == key_tree(
        servers["ref"].stats())
    assert key_tree(port["serve"]) == key_tree(ref["serve"])
    assert port["gateway"]["proto"] == ref["gateway"]["proto"] == 1
    assert port["gateway"]["slo_ms"] == SLO_MS


def test_gateway_series_are_the_references(servers, pools):
    """The ``gateway_*`` series (names and label sets) that the same
    traffic touches, and the families ``/metrics`` renders."""
    touched = {}
    for pkg in (PORT, REF):
        reg, srv = pkg["registry"], servers[pkg["name"]]
        before = reg.snapshot()
        refusal_lines(srv.port, REFUSALS[1][1] + REFUSALS[3][1])
        fault_lines(pkg, srv, "kill@gateway.conn:p=1.0,seed=3",
                    "io_error@gateway.conn:p=1.0,seed=5")
        settle(srv, pools[pkg["name"]])
        after = reg.snapshot()
        keys = set()
        for kind in ("counters", "gauges", "histograms"):
            for k, v in after[kind].items():
                if k.startswith("gateway_") and v != before[kind].get(k):
                    keys.add((kind, k))
        touched[pkg["name"]] = keys
        text = reg.render_text()
        touched[pkg["name"] + "_families"] = {
            ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE gateway_")}
    assert touched["port"] == touched["ref"]
    assert touched["port_families"] == touched["ref_families"] == {
        "gateway_conns_live", "gateway_connections_total",
        "gateway_errors_total", "gateway_faults_total",
        "gateway_requests_total", "gateway_wire_seconds"}
    assert ("counters", 'gateway_errors_total{code="illegal_move"}') in \
        touched["port"]


def test_multisize_routing_by_board(nets):
    rp, rv, pp, pv = nets
    out = {}
    for pkg, pol, val, cls in ((PORT, pp, pv, MultiSizePool),
                               (REF, rp, rv, RefMultiSize)):
        with jax.enable_checks(False):
            mpool = cls(val, pol, sizes=(5, 7), n_sim=4, batch_sizes=(1, 2))
        srv = pkg["server"](mpool, max_conns=2).start()
        try:
            c = pkg["client"].GatewayClient("127.0.0.1", srv.port)
            try:
                lines = [c.boards, c.default_board, c.new_game(board=7),
                         c.genmove("b")]
                with pytest.raises(pkg["client"].GatewayError) as ei:
                    c.new_game(board=9)
                lines.append((ei.value.code, str(ei.value)))
                lines.append(c.new_game())
            finally:
                c.close()
            settle(srv)
        finally:
            srv.close()
            mpool.close()
        lines[3].pop("elapsed_ms")
        out[pkg["name"]] = lines
    assert out["port"] == out["ref"]
    assert out["port"][:3] == [(5, 7), 5, {"type": "ok", "id": 1,
                                           "board": 7, "komi": 7.5}]
    assert out["port"][4][0] == "bad_board"


GTP_SCRIPT = ("protocol_version\nname\nversion\nknown_command genmove\n"
              "known_command frob\nlist_commands\nboardsize 5\nboardsize 19\n"
              "clear_board\nkomi 6.5\ngenmove b\nplay w pass\n"
              "play w Z9\ngenmove w\nfrobnicate\n# a comment\n\n"
              "7 name\n1 quit\nname\n")


def bridge_transcript(pkg, port: int) -> str:
    c = pkg["client"].GatewayClient("127.0.0.1", port)
    out = io.StringIO()
    try:
        pkg["gtp"].run_bridge(pkg["gtp"].GatewayBridge(c),
                              instream=io.StringIO(GTP_SCRIPT),
                              outstream=out)
    finally:
        c.close()
    return out.getvalue()


def test_gtp_bridge_transcripts_are_the_references(servers, pools):
    got = bridge_transcript(PORT, servers["port"].port)
    assert got == bridge_transcript(REF, servers["ref"].port)
    # the port's bridge over the reference's server, too
    assert bridge_transcript(PORT, servers["ref"].port) == got
    assert got.count("= rocalphago-gateway") == 1
    assert "? unacceptable size" in got and got.endswith("=1\n\n")
    for k in ("port", "ref"):
        settle(servers[k], pools[k])


def test_gtp_connect_needs_no_model_and_no_device(servers, pools,
                                                  monkeypatch, capsys):
    from rocalphago_tpu_torch.models import NeuralNetBase

    def no(*a, **k):
        raise AssertionError("the --connect path loaded a model")

    monkeypatch.setattr(NeuralNetBase, "load_model", no)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "boardsize 5\nclear_board\nkomi 6.5\ngenmove b\nplay w pass\n"
        "genmove b\nquit\n"))
    gtp.main(["--connect", f"127.0.0.1:{servers['port'].port}"])
    replies = [r for r in capsys.readouterr().out.split("\n\n") if r]
    assert len(replies) == 7 and all(r.startswith("=") for r in replies)
    assert gtp.vertex_to_move(replies[3][2:], SIZE) is not None \
        or replies[3] == "= pass"
    settle(servers["port"], pools["port"])


@pytest.mark.parametrize("server_key", ["port", "ref"])
def test_gtp_connect_reports_a_refusal(pools, server_key, monkeypatch):
    """Against a full gateway ``--connect`` backs off the client's
    default budget (each sleep at least the refusal's hint; recorded,
    not slept) and exits with the structured refusal."""
    sleeps = []

    class Recorded(client.ResilientGatewayClient):
        def __init__(self, host, port):
            super().__init__(host, port, sleep=sleeps.append)

    monkeypatch.setattr(client, "ResilientGatewayClient", Recorded)
    pkg = PORT if server_key == "port" else REF
    srv = pkg["server"](pools[server_key], max_conns=1).start()
    holder = Wire(srv.port)
    try:
        with pytest.raises(SystemExit) as ei:
            gtp.main(["--connect", f"127.0.0.1:{srv.port}"])
        msg = str(ei.value)
        assert msg.startswith("gateway refused: overload") and "retry" in msg
        assert len(sleeps) == 5 and min(sleeps) >= 1.0
    finally:
        holder.close()
        settle(srv)
        srv.close()


def test_gtp_connect_argument_errors(capsys):
    for argv in (["--connect", "no-port-here"], ["--connect", "host:"],
                 []):
        with pytest.raises(SystemExit) as ei:
            gtp.main(argv)
        assert ei.value.code == 2
    err = capsys.readouterr().err
    assert "--connect wants HOST:PORT" in err
    assert "--policy is required (unless --connect)" in err


def resilient_run(pkg, pool) -> dict:
    """A shed ridden out (the injected sleep frees the slot), then a
    connection the server cuts mid-game recovered by reconnect and
    replay."""
    srv = pkg["server"](pool, max_conns=1).start()
    hog = Wire(srv.port)
    sleeps = []

    def sleep(s):
        sleeps.append(s)
        if hog.sock.fileno() != -1:
            hog.close()
            settle(srv)

    c = pkg["client"].ResilientGatewayClient(
        "127.0.0.1", srv.port, attempts=4, base_delay=0.01, max_delay=0.05,
        seed=11, sleep=sleep)
    try:
        moves = [c.new_game(komi=6.5), c.genmove("b")]
        moves.append(c.play("w", vertex_besides(moves[-1]["move"])))
        # the server cuts this connection mid-game
        with srv._core._lock:
            conns = [conn for conn, _ in srv._core._conns.values()]
        for conn in conns:
            conn.shutdown(socket.SHUT_RDWR)
        settle(srv)
        moves.append(c.genmove("b"))         # reconnect + replay
        moves.append(c.genmove("w"))
        with pytest.raises(pkg["client"].GatewayError) as ei:
            c.play("b", "pass")
            c.play("w", "pass")
            c.genmove("b")
        out = dict(sleeps=sleeps, reconnects=c.reconnects,
                   log=list(c.log.moves), code=ei.value.code,
                   shed=srv.stats()["conns"]["shed"])
    finally:
        c.close()
        settle(srv, pool)
        srv.close()
    for m in moves:
        m.pop("elapsed_ms", None)
    out["moves"] = moves
    return out


def test_resilient_client_is_the_references(pools):
    got = resilient_run(PORT, pools["port"])
    assert got == resilient_run(REF, pools["ref"])
    assert got["sleeps"][0] >= 1.0           # the refusal's hint
    assert len(got["sleeps"]) == 2 and got["reconnects"] == 1
    assert got["code"] == "game_over" and got["shed"] == 1


def test_gateway_cli_needs_a_card_or_an_explicit_cpu(tmp_path):
    spec = [os.path.join(PUCT, "policy.json"), os.path.join(PUCT,
                                                            "value.json")]
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    argv = [sys.executable, "-m", "rocalphago_tpu_torch.gateway.server",
            "--policy", spec[0], "--value", spec[1], "--port", "0",
            "--http-port", "0", "--playouts", "4"]
    res = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    # --device cpu: serves, answers, drains on SIGTERM and exits 0
    metrics = str(tmp_path / "gateway.jsonl")
    proc = subprocess.Popen(argv + ["--device", "cpu", "--metrics", metrics],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("gateway: serving on 127.0.0.1:"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        port = int(line.split(":")[2].split()[0])
        c = client.GatewayClient("127.0.0.1", port)
        try:
            assert c.boards == (9,)
            c.new_game()
            assert c.genmove("b")["rung"] == "search"
        finally:
            c.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    events = read_jsonl(metrics)
    assert [e["phase"] for e in events if e["event"] == "drain"
            and e.get("phase", "").startswith("gateway")] == [
        "gateway_requested", "gateway_accept_stopped", "gateway_drained"]
    assert events[-1]["event"] == "registry"
