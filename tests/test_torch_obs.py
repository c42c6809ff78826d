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
