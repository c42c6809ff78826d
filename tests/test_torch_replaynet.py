"""The port's replay over the wire (``rocalphago_tpu_torch/replaynet``,
``ReplayBuffer.requeue``, the zero CLI's ``--replay-connect``) against
the reference's, on the CPU.

Both packages speak one wire, so the bar is byte equality: one scripted
request table over raw sockets (hello, put and its ack, a duplicate,
overload with ``retry_after_s``, evict mode, draining, bad schema,
unknown type, bad proto, transient and kill faults) gives the same
frames from either service; either package's client holds the same
conversation with either package's service; the synthetic actor's
games and ``game_id``\\ s are the reference's; a spool WAL written by
one package's client (torn tail and crash windows included) flushes
from the other's; a drained service's spill restores into either
package's next incarnation; ``requeue`` moves the reference's entries;
the actor CLI's kill and resume ships every game exactly once; and one
``--replay-connect`` learn in each package, from the same wire game,
lands within PR 9's zero-learn tolerance (1e-5 + 1e-4·|x| on each
update, float32). No wall-clock bound is asserted, and no test waits
out a backoff (``sleep=`` no-ops).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.data import replay as ref_replay
from rocalphago_tpu.replaynet import actor as ref_actor
from rocalphago_tpu.replaynet import client as ref_client
from rocalphago_tpu.replaynet import protocol as ref_protocol
from rocalphago_tpu.replaynet.server import ReplayService as RefService
from rocalphago_tpu.runtime import faults as ref_faults
from rocalphago_tpu_torch.data import replay
from rocalphago_tpu_torch.replaynet import actor, client, protocol
from rocalphago_tpu_torch.replaynet.server import ReplayService
from rocalphago_tpu_torch.runtime import faults
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT = dict(name="port", replay=replay, actor=actor, client=client,
            protocol=protocol, service=ReplayService, faults=faults)
REF = dict(name="ref", replay=ref_replay, actor=ref_actor,
           client=ref_client, protocol=ref_protocol, service=RefService,
           faults=ref_faults)
PKGS = {"port": PORT, "ref": REF}


def nosleep(_s):
    """Backoff sleeps are asserted, never waited."""


@pytest.fixture(autouse=True)
def _clean_fault_plans():
    yield
    faults.install(None)
    ref_faults.install(None)


def make_games(pkg, seed=0, t=3, b=2, a=26):
    r = np.random.default_rng(seed)
    return pkg["replay"].ZeroGames(
        actions=r.integers(0, a, (t, b)).astype(np.int32),
        live=r.integers(0, 2, (t, b)).astype(bool),
        visits=r.integers(0, 5, (t, b, a)).astype(np.int32),
        winners=r.integers(-1, 2, (b,)).astype(np.int32),
        finished=r.integers(0, 2, (b,)).astype(bool),
    )


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Raw:
    """One raw NDJSON connection keeping every frame's bytes."""

    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        self.reader = self.sock.makefile("rb")
        self.frames = [self.reader.readline()]       # the hello

    def ask(self, msg: dict) -> bytes:
        self.sock.sendall(protocol.encode_frame(msg))
        line = self.reader.readline()
        self.frames.append(line)
        return line

    def close(self) -> None:
        self.reader.close()
        self.sock.close()


def record(pkg, games, version=0) -> dict:
    return pkg["replay"].games_to_record(games, version)


# ------------------------------------------------------ the wire, raw

def table_core(pkg) -> list:
    """hello, put/ack, dup ack, overload, bad schema, bad record,
    unknown type, bad proto, batch, empty, stats."""
    svc = pkg["service"](capacity=1).start()
    try:
        c = Raw(svc.port)
        a, b = make_games(pkg, 1), make_games(pkg, 2)
        c.ask({"type": "hello", "id": 1, "proto": 1})
        c.ask({"type": "put_games", "id": 2, "record": record(pkg, a, 3)})
        c.ask({"type": "put_games", "id": 3, "record": record(pkg, a, 3)})
        c.ask({"type": "put_games", "id": 4, "record": record(pkg, b)})
        bad = record(pkg, b)
        bad["schema"] = pkg["replay"].RECORD_SCHEMA + 1
        c.ask({"type": "put_games", "id": 5, "record": bad})
        c.ask({"type": "put_games", "id": 6, "record": "nope"})
        c.ask({"type": "genmove", "id": 7})
        c.ask({"type": "hello", "id": 8, "proto": 2})
        c.ask({"type": "next_batch", "id": 9, "timeout_s": 0})
        c.ask({"type": "next_batch", "id": 10, "timeout_s": 0})
        c.ask({"type": "stats", "id": 11})
        c.close()
        assert svc.stats()["requests"]["unhandled"] == 0
        return c.frames
    finally:
        svc.close()


def table_modes(pkg) -> list:
    """Evict mode slides the window; a closed buffer refuses with
    ``draining``."""
    svc = pkg["service"](capacity=1, evict=True).start()
    try:
        c = Raw(svc.port)
        for i in range(2):
            c.ask({"type": "put_games", "id": i,
                   "record": record(pkg, make_games(pkg, 10 + i))})
        svc.buffer.close()
        c.ask({"type": "put_games", "id": 2,
               "record": record(pkg, make_games(pkg, 12))})
        c.ask({"type": "stats", "id": 3})
        c.close()
        return c.frames
    finally:
        svc.close()


def table_faults(pkg) -> list:
    """A transient and a kill at ``replay.put``, then a transient at
    ``replay.conn``: typed ``internal`` frames, the kill's connection
    dropped, nothing ingested twice."""
    svc = pkg["service"](capacity=4).start()
    f = pkg["faults"]
    try:
        c = Raw(svc.port)
        rec = record(pkg, make_games(pkg, 20))
        f.install("io_error@replay.put:1")
        c.ask({"type": "put_games", "id": 1, "record": rec})
        f.install("kill@replay.put:1")
        c.ask({"type": "put_games", "id": 2, "record": rec})
        c.frames.append(c.reader.readline())          # b"": dropped
        c.close()
        f.install("io_error@replay.conn:1")
        d = Raw(svc.port)
        d.ask({"type": "put_games", "id": 1, "record": rec})
        f.install(None)
        d.ask({"type": "put_games", "id": 2, "record": rec})
        d.ask({"type": "put_games", "id": 3, "record": rec})
        d.ask({"type": "stats", "id": 4})
        d.close()
        return c.frames + d.frames
    finally:
        f.install(None)
        svc.close()


TABLES = {"core": table_core, "modes": table_modes, "faults": table_faults}


@pytest.mark.parametrize("table", list(TABLES))
def test_both_services_write_the_same_frames(table):
    got = TABLES[table](PORT)
    want = TABLES[table](REF)
    assert got == want
    frames = [json.loads(f) for f in got if f]
    types = [f.get("code", f["type"]) for f in frames]
    if table == "core":
        assert types == ["hello", "ok", "ok", "ok", "overload", "bad_schema",
                         "bad_request", "unknown_type", "bad_proto", "batch",
                         "empty", "stats"]
        assert frames[3]["dup"] and frames[4]["retry_after_s"] == 1.0
    elif table == "modes":
        assert types == ["hello", "ok", "ok", "draining", "stats"]
        assert frames[-1]["replaynet"]["evict"]
    else:
        assert types[:3] == ["hello", "internal", "internal"]
        assert got[3] == b""                          # the kill dropped it
        stats = frames[-1]["replaynet"]
        assert stats["ingest"]["puts"] == 1 and stats["ingest"][
            "dup_hits"] == 1 and stats["faults"] == {
            "injected": 2, "kills": 1, "put_kills": 1, "take_kills": 0,
            "conn_kills": 0}


# --------------------------------------------- clients × services

def conversation(client_pkg: str, server_pkg: str) -> dict:
    C, S = PKGS[client_pkg], PKGS[server_pkg]
    svc = S["service"](capacity=4).start()
    try:
        with C["client"].ReplayClient("127.0.0.1", svc.port, attempts=2,
                                      sleep=nosleep) as c:
            g = make_games(C, 5)
            gid = c.put_games(g, version=7)
            again = c.put_games(g, version=7)
            batch = c.next_batch()
            empty = c.next_batch(timeout_s=0.0)
            stats = c.stats()
            with pytest.raises(C["client"].ReplayRefused):
                for i in range(5):
                    c.put_games(make_games(C, 30 + i))
            return dict(gid=gid, again=again, dup=c.dup_acks, batch=batch,
                        empty=empty, stats=stats, shipped=c.shipped,
                        games=c.shipped_games)
    finally:
        svc.close()


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("port", "port"), ("port", "ref"), ("ref", "port"), ("ref", "ref")])
def test_every_pairing_holds_the_same_conversation(client_pkg, server_pkg):
    got = conversation(client_pkg, server_pkg)
    assert got == conversation("ref", "ref")
    assert got["dup"] == 1 and got["empty"] is None
    assert got["batch"]["record"]["game_id"] == got["gid"]


@pytest.mark.parametrize("seed,k,i", [(0, 0, 0), (7, 1, 3), (5, 3, 11)])
def test_synthetic_games_and_ids_are_the_references(seed, k, i):
    kw = dict(batch=2, plies=4, board=5)
    got = actor.synth_games(seed, k, i, **kw)
    want = ref_actor.synth_games(seed, k, i, **kw)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert replay.compute_game_id(got) == ref_replay.compute_game_id(want)
    assert got.visits.shape == (4, 2, 26)


# ---------------------------------------------------------- requeue

def requeue_trail(pkg, spill_dir) -> dict:
    buf = pkg["replay"].ReplayBuffer(2, spill_dir=spill_dir)
    for i in range(2):
        assert buf.put(make_games(pkg, 40 + i), version=i)
    first = buf.next_batch(timeout=0)
    assert buf.requeue(first)
    # capacity overshoots by the requeued entry, never drops it
    second = buf.next_batch(timeout=0)
    assert buf.requeue(second) and buf.fill == 2
    n_spilled = len([f for f in os.listdir(spill_dir)
                     if f.startswith("entry.")])
    order = []
    while buf.fill:
        e = buf.next_batch(timeout=0)
        order.append((e.seq, e.version, pkg["replay"].compute_game_id(
            e.games)))
    buf.close()
    closed = buf.requeue(first)
    left = sorted(os.listdir(spill_dir))
    return dict(first=first.seq, order=order, n_spilled=n_spilled,
                closed=closed, left=left, ingested=buf.ingested_games)


def test_requeue_moves_the_references_entries(tmp_path):
    got = requeue_trail(PORT, str(tmp_path / "port"))
    want = requeue_trail(REF, str(tmp_path / "ref"))
    assert got == want
    assert got["order"][0][0] == got["first"] and got["n_spilled"] == 2
    assert got["closed"] is False and got["left"] == []


# ------------------------------------------------ spool WAL, both ways

@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_a_spool_flushes_from_the_other_package(tmp_path, writer, reader):
    W, R = PKGS[writer], PKGS[reader]
    spool = str(tmp_path / "wal")
    port = free_port()
    w = W["client"].ReplayClient("127.0.0.1", port, spool_dir=spool,
                                 attempts=2, sleep=nosleep, timeout=2.0)
    gids = [w.put_games(make_games(W, i), version=i) for i in range(3)]
    assert w.degraded and w.spool_depth == 3
    w.close()
    with open(os.path.join(spool, "game.00000003.json"), "w") as f:
        f.write('{"torn')                      # a torn tail
    svc = R["service"](host="127.0.0.1", port=port, capacity=8).start()
    try:
        r = R["client"].ReplayClient("127.0.0.1", port, spool_dir=spool,
                                     attempts=2, sleep=nosleep)
        assert r._spool_next == 4
        assert r.flush() == 3                  # the torn entry dropped
        assert not r.degraded and r.spool_depth == 0
        assert r.produced_ids() == set(gids)
        for want in range(3):
            assert r.next_batch()["record"]["version"] == want
        r.close()
    finally:
        svc.close()


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_crash_windows_resume_across_the_packages(tmp_path, writer, reader):
    """The acked ledger and the server's dedup window: a spool file whose
    id is in the ledger is unlinked, one that reached the server is
    deduped, whichever package wrote them."""
    W, R = PKGS[writer], PKGS[reader]
    spool = str(tmp_path / "wal")
    svc = R["service"](capacity=8).start()
    try:
        w = W["client"].ReplayClient("127.0.0.1", svc.port,
                                     spool_dir=spool, attempts=2,
                                     sleep=nosleep)
        g0, g1, g2 = (make_games(W, i) for i in range(3))
        w.put_games(g0)
        w.put_games(g1)
        w.close()
        for idx, g in ((7, g0), (8, g2)):
            rec = W["replay"].games_to_record(
                g, 0, game_id=W["replay"].compute_game_id(g))
            with open(os.path.join(spool, f"game.{idx:08d}.json"), "w") as f:
                json.dump(rec, f)
        with R["client"].ReplayClient("127.0.0.1", svc.port,
                                      sleep=nosleep) as other:
            other.put_games(g2)                # reached the server
        r = R["client"].ReplayClient("127.0.0.1", svc.port,
                                     spool_dir=spool, attempts=2,
                                     sleep=nosleep)
        assert r._spool_next == 9
        assert r.flush() == 1 and r.dup_acks == 1 and r.spool_depth == 0
        assert svc.stats()["ingest"]["puts"] == 3
        r.close()
    finally:
        svc.close()


# ------------------------------------------------ restart + recovery

@pytest.mark.parametrize("first,second", [("port", "port"), ("port", "ref"),
                                          ("ref", "port")])
def test_a_restart_recovers_buffer_and_window(tmp_path, first, second):
    A, B = PKGS[first], PKGS[second]
    spill = str(tmp_path / "spill")
    svc = A["service"](capacity=8, spill_dir=spill).start()
    games = [make_games(A, 50 + i) for i in range(3)]
    with A["client"].ReplayClient("127.0.0.1", svc.port,
                                  sleep=nosleep) as c:
        gids = [c.put_games(g, version=i) for i, g in enumerate(games)]
    svc.drain(reason="test")
    svc.buffer.close()
    assert os.path.exists(os.path.join(spill, "dedup.json"))
    time.sleep(0.002)      # a later millisecond: the reference's spill tag
    svc2 = B["service"](capacity=8, spill_dir=spill)
    assert svc2.recover() == 3
    svc2.start()
    try:
        with B["client"].ReplayClient("127.0.0.1", svc2.port,
                                      sleep=nosleep) as c:
            c.put_games(games[1], version=1)
            assert c.dup_acks == 1              # the old acks still dedup
            for i, gid in enumerate(gids):      # FIFO across the restart
                reply = c.next_batch()
                assert reply["record"]["game_id"] == gid
                assert reply["record"]["version"] == i
        st = svc2.stats()
        assert st["ingest"]["puts"] == 0 and st["dedup_window"]["size"] == 3
    finally:
        svc2.close()


# --------------------------------------------------- learner adapter

def test_remote_buffer_duck_types_as_the_learners(tmp_path):
    from rocalphago_tpu_torch.training.learner import ZeroLearner

    svc = ReplayService(capacity=4).start()
    try:
        games = make_games(PORT, 2)
        with client.ReplayClient("127.0.0.1", svc.port,
                                 sleep=nosleep) as c:
            c.put_games(games, version=7)
            c.put_games(make_games(PORT, 3), version=8)
        rbuf = client.RemoteReplayBuffer(client.ReplayClient(
            "127.0.0.1", svc.port, sleep=nosleep))
        seen = []

        def learn(state, got):
            seen.append(got)
            return state, {}

        learner = ZeroLearner(learn, rbuf)
        state, _, entry = learner.step("state", timeout=1.0)
        assert state == "state" and entry.version == 7 and entry.seq == 0
        np.testing.assert_array_equal(seen[0].visits, games.visits)
        ref_buf = ref_client.RemoteReplayBuffer(ref_client.ReplayClient(
            "127.0.0.1", svc.port, sleep=nosleep))
        e = ref_buf.sample(timeout=1.0)            # the reference's reads
        assert (e.seq, e.version) == (1, 8)
        assert rbuf.sample(timeout=0.0) is None    # drained
        ref_buf.close()
        rbuf.close()
        assert rbuf.closed and rbuf.next_batch() is None
    finally:
        svc.close()
    dead = client.RemoteReplayBuffer(client.ReplayClient(
        "127.0.0.1", free_port(), attempts=2, sleep=nosleep, timeout=1.0))
    assert dead.next_batch(timeout=0.0) is None    # an outage is empty
    dead.close()


# ------------------------------------------------------- the actor CLI

def test_actor_cli_kill_and_resume_ship_each_game_once(tmp_path):
    svc = ReplayService(capacity=32).start()
    spool = str(tmp_path / "a1")
    argv = ["--connect", f"127.0.0.1:{svc.port}", "--spool-dir", spool,
            "--actor-id", "1", "--games", "10", "--seed", "5"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "rocalphago_tpu_torch.replaynet.actor",
             *argv, "--rate-s", "0.05"], cwd=ROOT, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        t_end = time.monotonic() + 60
        while svc.stats()["ingest"]["puts"] < 3:
            assert proc.poll() is None, proc.stderr.read()
            assert time.monotonic() < t_end
            time.sleep(0.02)
        proc.send_signal(signal.SIGKILL)           # mid-run
        proc.wait(timeout=30)
        proc.stderr.close()
        assert actor.main(argv) == 0               # resumes where it died
        assert actor.main(argv) == 0               # and again: nothing new
        st = svc.stats()
        assert st["ingest"]["puts"] == 10 and st["ingest"]["games"] == 20
        ingested = set()
        with client.ReplayClient("127.0.0.1", svc.port,
                                 sleep=nosleep) as c:
            while True:
                got = c.next_batch()
                if got is None:
                    break
                ingested.add(got["record"]["game_id"])
        with client.ReplayClient("127.0.0.1", svc.port,
                                 spool_dir=spool) as c:
            produced = c.produced_ids()
        want = {ref_replay.compute_game_id(ref_actor.synth_games(5, 1, i))
                for i in range(10)}
        assert produced == ingested == want
    finally:
        svc.close()


def test_actor_selfplay_needs_a_card_or_an_explicit_cpu(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = ReplayService(capacity=4).start()
    try:
        argv = ["--connect", f"127.0.0.1:{svc.port}", "--spool-dir",
                str(tmp_path / "a"), "--games", "1", "--mode", "selfplay",
                "--batch", "2", "--move-limit", "4", "--sims", "2"]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            actor.main(argv)
        assert actor.main(argv + ["--device", "cpu"]) == 0
        with client.ReplayClient("127.0.0.1", svc.port,
                                 sleep=nosleep) as c:
            rec = c.next_batch()["record"]
        games, version = replay.record_to_games(rec)
        assert version == 0 and games.visits.shape == (4, 2, 26)
        assert games.visits.dtype == np.int32
    finally:
        svc.close()


# ------------------------------------------- --replay-connect, both

LR = 0.05
ATOL = 1e-5            # float32: summation order only (PR 9's)
RTOL = 1e-4


PLIES = 10            # one replay segment in both learners


def wire_game():
    """One self-play record of the port's engine: the zero tests' seeded
    sensible play (4 games), its first ``PLIES`` plies."""
    from test_torch_zero import make_record

    games = make_record(7, "visits", False)
    return games._replace(actions=games.actions[:PLIES],
                          live=games.live[:PLIES],
                          visits=games.visits[:PLIES])


@pytest.fixture(scope="module")
def wire_specs(tmp_path_factory):
    from rocalphago_tpu_torch.models import CNNPolicy, CNNValue

    d = tmp_path_factory.mktemp("wire_specs")
    feats = ("board", "ones", "liberties")
    CNNPolicy(feats, board=5, layers=2, filters_per_layer=8, seed=1,
              device="cpu").save_model(str(d / "policy.json"))
    CNNValue(feats + ("color",), board=5, layers=2, filters_per_layer=8,
             seed=2, device="cpu").save_model(str(d / "value.json"))
    return str(d / "policy.json"), str(d / "value.json")


def float32_loading(monkeypatch):
    """Both CLIs load their specs in float32 (the zero parity tests'
    type), so the two learns differ by summation order only."""
    from rocalphago_tpu.models import nn_util as ref_nn
    from rocalphago_tpu_torch.models import nn_util

    port_load = nn_util.NeuralNetBase.load_model
    ref_load = ref_nn.NeuralNetBase.load_model

    def port32(json_file, device=None, dtype=None):
        return port_load(json_file, device=device, dtype=torch.float32)

    def ref32(json_file):
        net = ref_load(json_file)
        net.module = net.module.clone(dtype=jnp.float32)
        net._apply = jax.jit(net.module.apply)
        return net

    monkeypatch.setattr(nn_util.NeuralNetBase, "load_model",
                        staticmethod(port32))
    monkeypatch.setattr(ref_nn.NeuralNetBase, "load_model",
                        staticmethod(ref32))


def learn_over_the_wire(pkg, specs, out, games) -> tuple:
    """Serve ``games`` on a service of ``pkg``'s package and run that
    package's zero CLI for one iteration with ``--replay-connect``;
    returns (old, new) flax trees of both nets and the iteration row."""
    from rocalphago_tpu_torch.models.weights import read_flax_msgpack

    svc = pkg["service"](capacity=4).start()
    try:
        with pkg["client"].ReplayClient("127.0.0.1", svc.port,
                                        sleep=nosleep) as c:
            c.put_games(pkg["replay"].ZeroGames(*games))
        if pkg is PORT:
            from rocalphago_tpu_torch.training.zero import run_training
            extra = ["--device", "cpu"]
        else:
            from rocalphago_tpu.training.zero import run_training
            extra = []
        with jax.enable_checks(False):
            run_training([*specs, out, "--game-batch", "4", "--move-limit",
                          str(PLIES), "--sims", "4", "--iterations", "1",
                          "--no-gating", "--learning-rate", str(LR),
                          "--seed", "3", "--replay-connect",
                          f"127.0.0.1:{svc.port}", *extra])
        st = svc.stats()
        assert st["takes"]["batches"] == 1 and st["requests"]["unhandled"] == 0
    finally:
        svc.close()
    spec_dir = os.path.dirname(specs[0])
    trees = []
    for name in ("policy", "value"):
        old = read_flax_msgpack(os.path.join(spec_dir, json.load(open(
            os.path.join(spec_dir, f"{name}.json")))["weights_file"]))
        new = read_flax_msgpack(os.path.join(out,
                                             f"{name}.00001.flax.msgpack"))
        trees.append((old, new))
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    (it,) = [r for r in rows if r["event"] == "iteration"]
    (rig,) = [r for r in rows if r["event"] == "actor_learner"]
    assert rig["actors"] == 0 and rig["lockstep"] is False
    return trees, it


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def test_replay_connect_learns_as_the_reference(tmp_path, monkeypatch,
                                                wire_specs):
    float32_loading(monkeypatch)
    games = wire_game()
    got, got_it = learn_over_the_wire(PORT, wire_specs, str(tmp_path / "p"),
                                      games)
    want, want_it = learn_over_the_wire(REF, wire_specs, str(tmp_path / "r"),
                                        games)
    moved = 0.0
    for (go, gn), (wo, wn) in zip(got, want):
        go, gn, wo, wn = flat(go), flat(gn), flat(wo), flat(wn)
        assert go.keys() == wo.keys() == gn.keys() == wn.keys()
        for k in go:
            np.testing.assert_array_equal(go[k], wo[k])
            g, w = (go[k] - gn[k]) / LR, (wo[k] - wn[k]) / LR
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=k)
            moved = max(moved, float(np.abs(w).max()))
    assert moved > 1e-3
    for k in ("policy_loss", "value_loss"):
        np.testing.assert_allclose(got_it[k], want_it[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
