"""The port's observability (``rocalphago_tpu_torch/obs``), the metrics
logger's ``echo`` switch and the tolerant JSONL reader, against the
reference's.

The same operations go through both registries and must give the same
``snapshot()`` and ``render_text()``, byte for byte; the same span
nesting through both tracers must emit the same records (wall-clock
fields aside). The watchdog's stall event names the open span, the
logger's emission stays whole under many threads, and the registry
snapshot reaches ``metrics.jsonl`` as a ``registry`` event.
"""

import json
import threading

import pytest

from rocalphago_tpu.io.metrics import MetricsLogger as RefLogger
from rocalphago_tpu.obs import registry as ref_registry
from rocalphago_tpu.obs import trace as ref_trace
from rocalphago_tpu_torch.io.metrics import MetricsLogger, read_jsonl
from rocalphago_tpu_torch.obs import registry, trace
from rocalphago_tpu_torch.runtime.watchdog import Watchdog
from torch_port_helpers import one_torch_thread  # noqa: F401

WALL = ("time", "dur_s", "start")


@pytest.fixture(autouse=True)
def _detached_trace():
    trace.configure(None)
    ref_trace.configure(None)
    yield
    trace.configure(None)
    ref_trace.configure(None)


def record_ops(reg):
    """One script of registry operations (the serving stack's names,
    labels and edges)."""
    reg.counter("serve_rung_total", rung="search").inc()
    reg.counter("serve_rung_total", rung="policy").inc(3)
    reg.counter("serve_degradation_total", rung="search",
                reason="overload").inc()
    reg.counter("serve_sheds_total", kind="queue_full", board="9").inc(2)
    reg.gauge("serve_sessions_live").set(4)
    reg.gauge("serve_queue_depth")
    occ = reg.histogram("serve_batch_occupancy",
                        edges=(0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0))
    for v in (0.125, 0.5, 1.0, 1.0, 0.05):
        occ.observe(v)
    lat = reg.histogram("serve_genmove_seconds")
    for v in (0.0004, 0.01, 0.3, 2.5, 75.0):
        lat.observe(v)
    rate = reg.histogram("device_mcts_sims_per_s",
                         edges=registry.RATE_EDGES)
    rate.observe(512.0)
    return reg


def test_registry_snapshot_and_text_are_the_references():
    got = record_ops(registry.Registry())
    want = record_ops(ref_registry.Registry())
    assert got.snapshot() == want.snapshot()
    assert json.dumps(got.snapshot()) == json.dumps(want.snapshot())
    assert got.render_text() == want.render_text()
    assert registry.DEFAULT_EDGES == ref_registry.DEFAULT_EDGES
    assert registry.RATE_EDGES == ref_registry.RATE_EDGES
    assert registry.COUNT_EDGES == ref_registry.COUNT_EDGES
    snap = got.snapshot()["histograms"]["serve_genmove_seconds"]
    for q in (0.0, 0.2, 0.5, 0.99, 1.0):
        assert registry.quantile_from_buckets(snap, q) == \
            ref_registry.quantile_from_buckets(snap, q)
    assert registry.quantile_from_buckets({"count": 0}, 0.5) is None
    with pytest.raises(ValueError, match="already registered"):
        got.gauge("serve_rung_total", rung="policy")
    with pytest.raises(ValueError, match="strictly"):
        registry.Histogram(edges=(1.0, 1.0))
    got.reset()
    assert got.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}}


def span_script(tr):
    with tr.span("gtp.genmove", turn=3):
        with tr.span("serve.search", turn=3):
            pass
        with pytest.raises(ValueError, match="boom"):
            with tr.span("serve.reduced"):
                raise ValueError("boom")
        with tr.span("serve.policy"):
            assert tr.current_path() == "gtp.genmove/serve.policy"
            assert tr.where() == "gtp.genmove/serve.policy"
    assert tr.current_path() is None and tr.open_spans() == {}
    tr.emit("custom", value=1)


def test_spans_emit_the_references_records(tmp_path):
    runs = {}
    for name, logger, tr in (("port", MetricsLogger, trace),
                             ("ref", RefLogger, ref_trace)):
        path = tmp_path / f"{name}.jsonl"
        with logger(str(path), echo=False) as log:
            tr.configure(log)
            span_script(tr)
            tr.configure(None)
        runs[name] = [{k: v for k, v in r.items() if k not in WALL}
                      for r in read_jsonl(str(path))]
    assert runs["port"] == runs["ref"]
    assert [r.get("path") for r in runs["port"]] == [
        "gtp.genmove/serve.search", "gtp.genmove/serve.reduced",
        "gtp.genmove/serve.policy", "gtp.genmove", None]
    assert runs["port"][1]["ok"] is False
    assert runs["port"][1]["error"] == "ValueError: boom"
    # a muted sink emits nothing; no sink emits nothing
    path = tmp_path / "muted.jsonl"
    with MetricsLogger(str(path), echo=False) as log:
        trace.configure(log, enabled=False)
        with trace.span("quiet"):
            pass
    assert read_jsonl(str(path)) == []


def test_where_prefers_the_deepest_span_across_threads():
    started, release = threading.Event(), threading.Event()

    def worker():
        with trace.span("deep"):
            with trace.span("deeper"):
                started.set()
                release.wait(30.0)

    with trace.span("outer"):
        t = threading.Thread(target=worker, name="w1")
        t.start()
        try:
            assert started.wait(30.0)
            assert trace.where() == "deep/deeper"
            assert trace.open_spans() == {"MainThread": "outer",
                                          "w1": "deep/deeper"}
        finally:
            release.set()
            t.join()
        assert trace.where() == "outer"
    assert trace.where() is None


def test_watchdog_stall_names_the_open_span():
    events = []
    done = threading.Event()

    class Log:
        def log(self, event, **kw):
            events.append((event, kw))
            done.set()

    with Watchdog(0.05, metrics=Log(), poll_s=0.01, name="t", exit=False):
        with trace.span("phase.outer"):
            with trace.span("inner"):
                assert done.wait(30.0)       # no beats: a stall
    stalls = [kw for ev, kw in events if ev == "stall"]
    assert stalls and stalls[0]["span"] == "phase.outer/inner"


def test_logger_echo_switch_and_registry_event(tmp_path, capsys):
    path = tmp_path / "m.jsonl"
    with MetricsLogger(str(path), echo=False) as quiet:
        quiet.log("degradation", rung="policy")
        registry.Registry().log_to(quiet)
        reg = record_ops(registry.Registry())
        reg.log_to(quiet)
        reg.log_to(None)
    assert capsys.readouterr().out == ""
    with MetricsLogger(str(path)) as loud:
        loud.log("degradation", rung="reduced", latency_s=0.5)
    assert "[degradation] rung=reduced latency_s=0.5000" in \
        capsys.readouterr().out
    recs = read_jsonl(str(path))
    assert [r["event"] for r in recs] == ["degradation", "registry",
                                          "registry", "degradation"]
    assert recs[2]["snapshot"] == json.loads(json.dumps(reg.snapshot()))
    # a torn last line is skipped; "raise" surfaces it
    with open(path, "a") as f:
        f.write('{"event": "torn')
    assert len(read_jsonl(str(path))) == 4
    with pytest.raises(ValueError):
        read_jsonl(str(path), on_error="raise")


def test_concurrent_emit_from_many_sessions(tmp_path):
    """Session threads interleaving logger events with registry
    updates through one logger lose and tear nothing."""
    n_threads, n_events = 8, 150
    path = tmp_path / "m.jsonl"
    reg = registry.Registry()
    c = reg.counter("emit_total")
    h = reg.histogram("emit_seconds")
    with MetricsLogger(str(path), echo=False) as log:
        ready = threading.Barrier(n_threads)

        def emit(tid):
            ready.wait()
            for i in range(n_events):
                log.write("span", tid=tid, i=i)
                log.log("degradation", tid=tid, i=i, rung="policy")
                c.inc()
                h.observe(0.001 * (i % 7))

        threads = [threading.Thread(target=emit, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    lines = path.read_text().splitlines()
    assert len(lines) == n_threads * n_events * 2
    recs = [json.loads(ln) for ln in lines]
    assert {r["tid"] for r in recs} == set(range(n_threads))
    assert c.value == n_threads * n_events
    assert h.snapshot()["count"] == n_threads * n_events


# -------------------------------------------------------------------------
# the encoder's, the device search's and self-play's telemetry


def _isolated(monkeypatch, module):
    """Point a registry module's process functions at a fresh registry
    for one test (the modules under test look them up per call)."""
    reg = module.Registry()
    for name in ("counter", "gauge", "histogram", "snapshot"):
        monkeypatch.setattr(module, name, getattr(reg, name))
    return reg


def _shape(snap):
    """A snapshot's names, labels and bucket edges, without values."""
    return {"counters": sorted(snap["counters"]),
            "gauges": sorted(snap["gauges"]),
            "histograms": {k: sorted(v["buckets"])
                           for k, v in snap["histograms"].items()}}


@pytest.mark.usefixtures("one_torch_thread")
def test_encode_search_selfplay_telemetry_is_the_references(monkeypatch,
                                                              tmp_path):
    """One scripted CPU run through each package: ``Preprocess`` (delta
    encodes, a reset, a scratch batch), a PUCT search under a deadline,
    a device player's move, two segments of policy self-play and a
    search self-play with playout caps and forced playouts. Both
    registries hold the same metric names, labels and bucket edges, the
    deterministic counters agree (not the simulations: each package
    draws its playout caps from its own stream), and both tracers emit
    the same ``encode`` span paths and tags."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from rocalphago_tpu.engine import jaxgo, pygo
    from rocalphago_tpu.features import Preprocess as RefPreprocess
    from rocalphago_tpu.models import CNNPolicy as RefPolicy
    from rocalphago_tpu.models import CNNValue as RefValue
    from rocalphago_tpu.search import device_mcts as ref_mcts
    from rocalphago_tpu.search import selfplay as ref_selfplay
    from rocalphago_tpu_torch.engine import pygo as tpygo
    from rocalphago_tpu_torch.engine import torchgo
    from rocalphago_tpu_torch.features import Preprocess
    from rocalphago_tpu_torch.models import CNNPolicy, CNNValue
    from rocalphago_tpu_torch.models.weights import params_from_flax
    from rocalphago_tpu_torch.runtime.deadline import Deadline
    from rocalphago_tpu_torch.search import device_mcts, selfplay

    port_reg = _isolated(monkeypatch, registry)
    ref_reg = _isolated(monkeypatch, ref_registry)
    size, n = 5, 25
    feats = ("board", "ladder_capture", "ladder_escape", "ones")
    plain, vplain = ("board", "ones"), ("board", "ones", "color")
    jcfg, cfg = jaxgo.GoConfig(size=size), torchgo.GoConfig(size=size)
    sts, st = [], pygo.GameState(size=size)
    rng = np.random.default_rng(3)
    for _ in range(3):
        moves = st.get_legal_moves()
        st.do_move(moves[rng.integers(len(moves))])
        sts.append(st.copy())

    def ref_policy(params, planes):
        return jnp.zeros((planes.shape[0], n))

    def ref_value(params, planes):
        return planes[..., 0].sum(axis=(1, 2)) / n

    def port_policy(planes):
        return torch.zeros((planes.shape[0], n))

    def port_value(planes):
        return planes[..., 0].sum(dim=(1, 2)) / n

    kw = dict(board=size, layers=2, filters_per_layer=4)
    rp, rv = RefPolicy(plain, seed=1, **kw), RefValue(vplain, seed=2, **kw)
    pp = CNNPolicy(plain, init_weights=False, device="cpu",
                   dtype=torch.float32, **kw)
    pv = CNNValue(vplain, init_weights=False, device="cpu",
                  dtype=torch.float32, **kw)
    for ref, port in ((rp, pp), (rv, pv)):
        ref.module = ref.module.clone(dtype=jnp.float32)
        port.module.load_state_dict(params_from_flax(
            jax.tree.map(np.asarray, ref.params)))

    spans = {}
    with jax.enable_checks(False):
        for name, logger, tr in (("port", MetricsLogger, trace),
                                 ("ref", RefLogger, ref_trace)):
            path = tmp_path / f"{name}.jsonl"
            with logger(str(path), echo=False) as log:
                tr.configure(log)
                if name == "port":
                    pre = Preprocess(feats, cfg=cfg, device="cpu")
                    for s in sts:
                        pre.advance(torchgo.from_pygo(cfg, [s], device="cpu"))
                    pre.reset_cache(reason="new_game")
                    pre.states_to_tensor(torchgo.from_pygo(cfg, sts,
                                                           device="cpu"))
                else:
                    pre = RefPreprocess(feats, cfg=jcfg)
                    for s in sts:
                        pre.advance(jaxgo.from_pygo(jcfg, s))
                    pre.reset_cache(reason="new_game")
                    pre.states_to_tensor(jax.tree.map(
                        lambda *x: jnp.stack(x),
                        *[jaxgo.from_pygo(jcfg, s) for s in sts]))
                tr.configure(None)
            spans[name] = [(r["path"], {k: v for k, v in r.items()
                                        if k in ("board", "batch", "delta",
                                                 "ok")})
                           for r in read_jsonl(str(path))
                           if r.get("event") == "span"]

        # a PUCT search under a deadline, and a player's move
        port_search = device_mcts.make_device_mcts(
            cfg, plain, vplain, port_policy, port_value, n_sim=8)
        port_search.run_chunked(torchgo.from_pygo(cfg, sts, device="cpu"),
                                4, deadline=Deadline.after(60.0))
        ref_search = ref_mcts.make_device_mcts(
            jcfg, plain, vplain, ref_policy, ref_value, n_sim=8)
        ref_search.run_chunked(None, None, jax.tree.map(
            lambda *x: jnp.stack(x), *[jaxgo.from_pygo(jcfg, s) for s in sts]),
            4, deadline=__import__(
                "rocalphago_tpu.runtime.deadline",
                fromlist=["Deadline"]).Deadline.after(60.0))
        device_mcts.DeviceMCTSPlayer(pv, pp, n_sim=4, sim_chunk=4).get_move(
            tpygo.GameState(size=size))
        ref_mcts.DeviceMCTSPlayer(rv, rp, n_sim=4, sim_chunk=4).get_move(
            pygo.GameState(size=size))

        # two segments of policy self-play
        selfplay.make_selfplay_chunked(cfg, plain, port_policy, port_policy,
                                       2, 4, chunk=2, device="cpu")(
            torch.Generator().manual_seed(0))
        ref_selfplay.make_selfplay_chunked(jcfg, plain, ref_policy,
                                           ref_policy, 2, 4, chunk=2)(
            None, None, jax.random.key(0))

        # search self-play with playout caps and forced playouts
        device_mcts.make_mcts_selfplay(
            cfg, plain, vplain, port_policy, port_value, batch=2,
            max_moves=2, n_sim=4, forced_k=1.0, cap_p=0.5, cap_cheap=2,
            record_visits=True, device="cpu")(torch.Generator().manual_seed(0))
        ref_mcts.make_mcts_selfplay(
            jcfg, plain, vplain, ref_policy, ref_value, batch=2, max_moves=2,
            n_sim=4, forced_k=1.0, cap_p=0.5, cap_cheap=2,
            record_visits=True)(None, None, jax.random.key(0))

    got, want = port_reg.snapshot(), ref_reg.snapshot()
    assert _shape(got) == _shape(want)
    families = ("encode_", "device_mcts_", "selfplay_", "policy_targets_")
    assert all(any(k.startswith(f) for k in got["counters"])
               or any(k.startswith(f) for k in got["histograms"])
               for f in families)
    for key in ("encode_delta_total", "encode_full_total",
                'encode_positions_total{board="5"}',
                'encode_cache_resets_total{reason="new_game"}',
                'encode_encoders_total{planes="ladder"}',
                "encode_incr_lanes_refreshed_total",
                "selfplay_plies_total"):
        assert got["counters"][key] == want["counters"][key], key
    for key in ("encode_pos_us{board=\"5\"}", "selfplay_segment_seconds",
                "selfplay_ply_seconds", "selfplay_sims_per_move",
                "device_mcts_sims_per_s", "device_mcts_get_move_seconds"):
        assert got["histograms"][key]["count"] \
            == want["histograms"][key]["count"], key
    assert spans["port"] == spans["ref"]
    assert [p for p, _ in spans["port"]] == ["encode"] * 4
