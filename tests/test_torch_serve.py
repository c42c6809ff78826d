"""The port's serve pool (``rocalphago_tpu_torch/serve``) against the
reference's, on the CPU.

The batching evaluator is driven by hand (``start=False`` and
``drain_once``) for coalescing and padding; the max-wait flush only has
to serve a lone request at all. A full queue sheds
(``EvaluatorOverload``) into the ladder's ``overload`` reason; the
session cap refuses a fifth game. A pooled genmove equals the port's
standalone ``DeviceMCTSPlayer`` bit for bit (root visits and move), and
the reference's ``ServePool`` on 2 × 8 float32 nets carried across: the
same move and the same root visits, exactly (the evaluations differ in
float32 summation order only, which flips no selection on these
positions). The fleet driver plays the threaded sessions' moves; params versions pin and retire; the ``stats()`` and probe
schemas are the reference's; a soak under a fault plan and a hang keeps
every session served. The GTP ``--serve`` entry runs on the CPU.
"""

import io
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.interface.gtp import GTPEngine as RefEngine
from rocalphago_tpu.models import CNNPolicy as RefPolicy
from rocalphago_tpu.models import CNNValue as RefValue
from rocalphago_tpu.serve import ServePool as RefPool
from rocalphago_tpu_torch.engine import pygo, torchgo
from rocalphago_tpu_torch.interface import gtp
from rocalphago_tpu_torch.io.metrics import MetricsLogger, read_jsonl
from rocalphago_tpu_torch.models import CNNPolicy, CNNValue
from rocalphago_tpu_torch.models.weights import params_from_flax
from rocalphago_tpu_torch.runtime import faults
from rocalphago_tpu_torch.search import device_mcts
from rocalphago_tpu_torch.serve import (
    AdmissionController,
    AdmissionError,
    BatchingEvaluator,
    EvaluatorOverload,
    ServePool,
)
from rocalphago_tpu_torch.serve.evaluator import default_batch_sizes
from torch_port_helpers import one_torch_thread, random_games  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 5
FEATS = ("board", "ones")
VFEATS = FEATS + ("color",)
N_SIM = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GUMBEL = os.path.join(ROOT, "results/zero_r5/target_compare/gumbel")


@pytest.fixture(autouse=True)
def _clean_fault_plan():
    yield
    faults.install(None)


@pytest.fixture(scope="module")
def nets():
    """2 × 8 nets of both packages, carried across in float32."""
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
def pool(nets):
    _, _, pp, pv = nets
    p = ServePool(pv, pp, n_sim=N_SIM, max_sessions=4,
                  batch_sizes=(1, 2, 4), max_wait_us=2000)
    p.warm()
    yield p
    p.close()


def positions():
    return [pygo.GameState(size=SIZE)] + random_games(SIZE, 3, 3, 10,
                                                      seed=21)


def port_copy(st):
    """A reference host state replayed on the port's host rules."""
    out = pygo.GameState(size=st.size, komi=st.komi)
    for mv in st.history:
        out.do_move(mv)
    return out


def fresh(pool, batch):
    return torchgo.new_states(pool.cfg, batch, device="cpu")


def evaluator(pool, **kw):
    kw.setdefault("batch_sizes", (1, 2, 4))
    return BatchingEvaluator(pool.search.eval_with,
                             *pool.evaluator.version_params(), **kw)


def stepped(pool, batch, action=7):
    st = fresh(pool, batch)
    return torchgo.step(pool.cfg, st, torch.full((batch,), action))


# ------------------------------------------------------------ batcher

def test_coalesces_whole_requests_and_pads(pool):
    ev = evaluator(pool, start=False)
    try:
        parts = [fresh(pool, 1), stepped(pool, 1), fresh(pool, 1)]
        reqs = [ev.submit(p) for p in parts]
        ev.drain_once()
        assert ev.batches == 1 and ev.rows_total == 3
        assert ev.padded_total == 4
        direct = ev.eval_direct(device_mcts_rows(parts, pad_to=4))
        for i, r in enumerate(reqs):
            p, v = r.result(timeout=30)
            assert torch.equal(p, direct[0][i:i + 1])
            assert torch.equal(v, direct[1][i:i + 1])
        # a request larger than the largest size is refused
        with pytest.raises(ValueError, match="exceeds"):
            ev.submit(fresh(pool, 5))
    finally:
        ev.close()


def device_mcts_rows(parts, pad_to):
    from rocalphago_tpu_torch.serve.evaluator import cat_states, pad_rows

    return pad_rows(cat_states(parts), pad_to)


def test_max_wait_flushes_a_partial_batch(pool):
    """Four live sessions make the fill target 4; a lone request is
    flushed by the max-wait clock, padded to size 1."""
    adm = AdmissionController(max_sessions=4)
    for _ in range(4):
        adm.admit_session()
    ev = evaluator(pool, max_wait_us=1000, admission=adm)
    try:
        p, v = ev.evaluate(fresh(pool, 1), timeout=60)
        assert p.shape == (1, SIZE * SIZE + 1) and v.shape == (1,)
        assert ev.batches == 1 and ev.padded_total == 1
    finally:
        ev.close()


def test_padded_rows_are_bit_ignored(pool):
    from rocalphago_tpu_torch.serve.evaluator import cat_states, pad_rows

    real = cat_states([fresh(pool, 1), stepped(pool, 1)])
    pad_a = pad_rows(real, 4)
    pad_b = cat_states([real, stepped(pool, 2, action=12)])
    pa, va = pool.evaluator.eval_direct(pad_a)
    pb, vb = pool.evaluator.eval_direct(pad_b)
    assert torch.equal(pa[:2], pb[:2]) and torch.equal(va[:2], vb[:2])
    ev = evaluator(pool, start=False)
    try:
        req = ev.submit(cat_states([real, fresh(pool, 1)]))
        ev.drain_once()
        pq, vq = req.result(timeout=30)
        assert torch.equal(pq[:2], pa[:2]) and torch.equal(vq[:2], va[:2])
    finally:
        ev.close()


def test_bounded_queue_sheds_past_the_row_bound(pool):
    adm = AdmissionController(max_sessions=4, queue_rows=2)
    ev = evaluator(pool, admission=adm, start=False)
    r1, r2 = ev.submit(fresh(pool, 1)), ev.submit(fresh(pool, 1))
    with pytest.raises(EvaluatorOverload):
        ev.submit(fresh(pool, 1))
    assert adm.queue_sheds == 1 and adm.stats()["queue_sheds"] == 1
    ev.drain_once()
    for r in (r1, r2):
        assert r.result(timeout=30)[0].shape[0] == 1
    ev.close()
    with pytest.raises(RuntimeError, match="closed"):
        ev.submit(fresh(pool, 1))


def test_batch_size_ladder_defaults():
    assert default_batch_sizes() == (1, 8, 32, 64, 256)
    assert default_batch_sizes(256) == (1, 8, 32, 64, 256)
    assert default_batch_sizes(48) == (1, 8, 32, 48)
    assert default_batch_sizes(4) == (1, 4)
    from rocalphago_tpu.serve.evaluator import \
        default_batch_sizes as ref_sizes

    for cap in (None, 1, 4, 48, 64, 100, 256, 1000):
        assert default_batch_sizes(cap) == ref_sizes(cap)


def test_overloaded_pool_degrades_to_the_policy_rung(pool):
    """``queue_rows=0`` sheds every leaf: the search and reduced rungs
    both overload, and the raw policy rung serves."""
    sess = pool.open_session()
    bound = pool.admission.queue_rows
    sheds0 = pool.admission.queue_sheds
    try:
        pool.admission.queue_rows = 0
        st = pygo.GameState(size=SIZE)
        mv = sess.get_move(st)
        assert mv is not None and st.is_legal(mv)
        assert sess.player.last_rung == "policy"
        assert sess.player.reasons.get("overload", 0) == 2
        assert pool.admission.queue_sheds == sheds0 + 2
    finally:
        pool.admission.queue_rows = bound
        sess.close()


def test_session_admission_cap(pool):
    sessions = [pool.open_session() for _ in range(4)]
    try:
        with pytest.raises(AdmissionError):
            pool.open_session()
        assert pool.admission.session_rejects >= 1
    finally:
        sessions[0].close()
    try:
        pool.open_session().close()      # the freed slot admits again
    finally:
        for s in sessions[1:]:
            s.close()
    assert pool.admission.live_sessions == 0


# ------------------------------------------------ equal to standalone

class Recorder:
    """Records every ``root_stats`` visits row a search reads."""

    def __init__(self, monkeypatch, target, name="root_stats"):
        self.visits = []
        orig = getattr(target, name)

        def rec(tree):
            out = orig(tree)
            self.visits.append(np.asarray(out[0]).copy())
            return out

        monkeypatch.setattr(target, name, staticmethod(rec)
                            if isinstance(target, type) else rec)


def test_pooled_genmove_is_the_standalone_players(pool, nets, monkeypatch):
    _, _, pp, pv = nets
    rec = Recorder(monkeypatch, device_mcts.DeviceMCTS, "root_stats")
    sess = pool.open_session(resilient=False)
    try:
        for st in positions():
            alone = device_mcts.DeviceMCTSPlayer(pv, pp, n_sim=N_SIM)
            want = alone.get_move(st)
            got = sess.get_move(st)
            assert got == want
            np.testing.assert_array_equal(rec.visits[-1], rec.visits[-2])
            assert int(rec.visits[-1].sum()) == N_SIM
    finally:
        sess.close()


def test_pooled_genmove_is_the_reference_pools(pool, nets, monkeypatch):
    rp, rv, _, _ = nets
    rec = Recorder(monkeypatch, device_mcts.DeviceMCTS, "root_stats")
    with jax.enable_checks(False):
        ref = RefPool(rv, rp, n_sim=N_SIM, max_sessions=4,
                      batch_sizes=(1, 8), max_wait_us=2000)
        ref_rec = Recorder(monkeypatch, ref.search)
        try:
            ref_sess = ref.open_session(resilient=False)
            sess = pool.open_session(resilient=False)
            try:
                for st in random_games(SIZE, 4, 2, 12, seed=33):
                    want = ref_sess.get_move(st)
                    got = sess.get_move(port_copy(st))
                    assert got == want
                    np.testing.assert_array_equal(rec.visits[-1],
                                                  ref_rec.visits[-1])
            finally:
                sess.close()
        finally:
            ref.close()


def test_fleet_driver_plays_the_threaded_sessions_moves(pool):
    """Threaded sessions and the lockstep driver on one size ladder of
    a single size, so every row is evaluated in a batch of 4 whichever
    way the threads' leaves coalesce (a row's float32 value may change
    with the batch size on the CPU too)."""
    sts = positions()
    pool = ServePool(pool.value, pool.policy, n_sim=N_SIM, max_sessions=4,
                     batch_sizes=(4,), max_wait_us=2000,
                     searcher=pool.search)
    sessions = [pool.open_session(resilient=False) for _ in sts]
    try:
        threaded = [None] * len(sts)

        def play(i):
            threaded[i] = sessions[i].get_move(sts[i])

        threads = [threading.Thread(target=play, args=(i,))
                   for i in range(len(sts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        drv = pool.driver(sessions)
        drv.warm()
        rows0 = pool.evaluator.rows_total
        assert drv.genmove_all(sts) == threaded
        assert drv.last_n_sim == N_SIM
        # one root convoy and one convoy a simulation, 4 rows each
        assert pool.evaluator.rows_total - rows0 == 4 * (N_SIM + 1)
    finally:
        pool.close()


# ---------------------------------------------------------- versions

def test_params_versions_pin_and_retire(pool, nets):
    _, _, pp, pv = nets
    ev = evaluator(pool, start=False)
    try:
        st = fresh(pool, 1)
        p0 = ev.eval_direct(st)[0]
        pinned = ev.acquire()
        assert pinned == 0
        v1 = ev.set_params(*pool.evaluator.version_params())
        assert v1 == 1 and ev.params_version == 1 and ev.swaps == 1
        assert ev.version_params(0) is not None      # pinned: alive
        req = ev.submit(st, version=0)
        ev.drain_once()
        assert torch.equal(req.result(timeout=30)[0], p0)
        ev.release(0)
        with pytest.raises(KeyError):
            ev.acquire(0)                            # retired
        with pytest.raises(KeyError):
            ev.submit(st, version=0)
        staged = ev.add_version(*pool.evaluator.version_params())
        assert staged == 2 and ev.params_version == 1
        ev.set_params(version=staged)
        ev.release(staged)
        assert ev.params_version == 2
        with pytest.raises(KeyError):
            ev.version_params(1)
    finally:
        ev.close()
    # the pool's hot swap takes state dicts; the facade nets follow
    sess = pool.open_session(resilient=False)
    try:
        before = {k: v.clone() for k, v in pp.module.state_dict().items()}
        doubled = {k: 2 * v for k, v in before.items()}
        v = pool.set_params(doubled, pv.module.state_dict())
        assert pool.params_version == v and pool.stats()["params"] == {
            "version": v, "swaps": v}
        assert torch.equal(pp.module.state_dict()["head.conv.weight"],
                           doubled["head.conv.weight"])
        sess.pin_version(0)                          # retired: falls back
        assert sess.get_move(pygo.GameState(size=SIZE)) is not None
        assert sess.params_version == v and sess.raw.pinned_version is None
        pool.set_params(before, pv.module.state_dict())
    finally:
        sess.close()


# --------------------------------------------------- schema and probes

def key_tree(d):
    if isinstance(d, dict):
        return {k: key_tree(v) for k, v in d.items()}
    return None


def test_stats_and_probe_keys_are_the_references(pool, nets):
    rp, rv, _, _ = nets
    with jax.enable_checks(False):
        ref = RefPool(rv, rp, n_sim=N_SIM, max_sessions=4,
                      batch_sizes=(1, 8), max_wait_us=2000)
        try:
            assert key_tree(pool.stats()) == key_tree(ref.stats())
            ref_sess = ref.open_session()
            sess = pool.open_session()
            try:
                ref_eng = RefEngine(ref_sess.player, serve_pool=ref)
                eng = gtp.GTPEngine(sess.player, serve_pool=pool)
                for e in (ref_eng, eng):
                    assert e.handle("boardsize 5")[0] == "=\n\n"
                    assert e.handle("genmove b")[0].startswith("= ")
                for cmd in ("rocalphago-health", "rocalphago-stats"):
                    got = json.loads(eng.handle(cmd)[0][2:])
                    want = json.loads(ref_eng.handle(cmd)[0][2:])
                    got.pop("registry", None)
                    want.pop("registry", None)
                    assert key_tree(got) == key_tree(want), cmd
                health = json.loads(eng.handle("rocalphago-health")[0][2:])
                assert health["serve"]["sessions"]["live"] == 1
                assert health["serve"]["warmed"] is True
                assert 0 < health["serve"]["evaluator"][
                    "batch_occupancy"] <= 1
                assert health["sims"] == {"last": N_SIM, "nominal": N_SIM}
                # the pool is found off the primary without the handle
                assert json.loads(gtp.GTPEngine(sess.player).handle(
                    "rocalphago-health")[0][2:])["serve"]["sessions"][
                        "live"] == 1
                assert "rocalphago-health" in eng.handle(
                    "list_commands")[0]
            finally:
                sess.close()
                ref_sess.close()
        finally:
            ref.close()


# ---------------------------------------------------------------- soak

def test_soak_faults_and_hang_do_not_stall_the_evaluator(pool, tmp_path):
    """Three sessions in threads under one transient evaluator fault
    (failing exactly one batch, whose sessions retry reduced) and one
    hung search rung (abandoned by that session's watchdog): every
    session plays every move legally, and the evaluator serves on."""
    path = tmp_path / "metrics.jsonl"
    metrics = MetricsLogger(str(path), echo=False)
    sessions = [pool.open_session() for _ in range(3)]
    for s in sessions:
        s.player.hang_timeout_s = 1.0
        s.player.metrics = metrics
    faults.install("io_error@serve.eval:5,sleep@iter2.serve.search=4")
    fails0 = pool.evaluator.failures
    games = [pygo.GameState(size=SIZE) for _ in sessions]
    errors = []

    def play(sess, game):
        try:
            for _ in range(3):
                mv = sess.get_move(game)
                assert mv is None or game.is_legal(mv)
                game.do_move(mv)
        except Exception as e:  # noqa: BLE001 -- must not happen
            errors.append(e)

    threads = [threading.Thread(target=play, args=(s, g))
               for s, g in zip(sessions, games)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    faults.install(None)
    try:
        assert not errors and all(not t.is_alive() for t in threads)
        assert all(g.turns_played == 3 for g in games)
        assert pool.evaluator.failures == fails0 + 1
        hangs = sorted(s.player.reasons.get("hang", 0) for s in sessions)
        assert hangs == [0, 0, 1]
        assert pool.evaluator.evaluate(fresh(pool, 1),
                                       timeout=30)[0].shape[0] == 1
        metrics.close()
        kinds = {e.get("reason") for e in read_jsonl(str(path))
                 if e.get("event") == "degradation"}
        assert {"hang", "transient_error"} <= kinds
    finally:
        # the search abandoned as hung runs on to its end: wait for it
        for t in threading.enumerate():
            if t.name.startswith("genmove-"):
                t.join(timeout=60)
        for s in sessions:
            s.close()


def test_gtp_serve_on_the_cpu(monkeypatch, capsys, tmp_path):
    """``--serve`` on the committed 9×9 nets: genmove, komi, both
    probes and quit; the session's pool shows in the probes, and the
    registry snapshot closes the metrics file."""
    metrics = str(tmp_path / "serve.jsonl")
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "boardsize 9\ngenmove b\nkomi 6.5\ngenmove w\nrocalphago-health\n"
        "rocalphago-stats\nquit\n"))
    gtp.main(["--serve", "--policy", os.path.join(GUMBEL, "policy.json"),
              "--value", os.path.join(GUMBEL, "value.json"), "--playouts",
              "4", "--device", "cpu", "--metrics", metrics])
    replies = capsys.readouterr().out.split("\n\n")
    assert replies[0] == "=" and replies[2] == "="
    for r in (replies[1], replies[3]):
        assert r.startswith("= ") and gtp.vertex_to_move(r[2:], 9)
    health = json.loads(replies[4][2:])
    assert health["status"] == "ok" and health["genmoves"] == 2
    assert health["serve"]["sessions"]["live"] == 1
    assert health["serve"]["evaluator"]["komi_batches"] >= 1
    stats = json.loads(replies[5][2:])
    assert stats["game"]["komi"] == 6.5
    assert 'serve_rung_total{rung="search"}' in \
        stats["registry"]["counters"]
    recs = read_jsonl(metrics)
    assert recs[-1]["event"] == "registry"
    assert any(r["event"] == "span" and r["name"] == "gtp.genmove"
               for r in recs)
    with pytest.raises(SystemExit, match="needs a --value"):
        gtp.main(["--serve", "--policy", os.path.join(GUMBEL, "policy.json"),
                  "--device", "cpu"])


def test_raw_serve_session_reports_the_players_errors(pool):
    """``open_session(resilient=False)`` is the raw player: a closed
    evaluator's error reaches the caller."""
    ev_pool = ServePool(pool.value, pool.policy, n_sim=2, max_sessions=1,
                        batch_sizes=(1,), searcher=pool.search)
    sess = ev_pool.open_session(resilient=False)
    ev_pool.evaluator.close()
    with pytest.raises(RuntimeError, match="closed"):
        sess.get_move(pygo.GameState(size=SIZE))
    ev_pool.close()
