"""Launch tracking (``obs/torchobs.py``) against the reference's compile
tracking (``obs/jaxobs.py``), on the CPU.

* ``track``: the reference's call shapes (``track("name", fn)`` and the
  decorator) and delegation; the reference's wrapper times its calls,
  the port's keeps no timing (no ``calls``, ``stats()`` or EMA).
* The wrapped entry points: an ``ast`` scan of both packages finds the
  same entry names (the reference's donated programs share theirs, and
  have no attribute of their own in the port).
* ``kernel_launches_total{entry=,kernel=}``: launches of a stub kernel
  (the wrappers' own counting, on plain versions) land in the innermost
  tracked call of their thread, never in another thread's, and the
  entries' series plus ``untracked`` sum to the process totals -- for
  threads under a short switch interval, for the encoder and the
  device search, and through the zero CLI's ``metrics.jsonl``.
* The profiler helpers moved out of the zero CLI: idempotent, their
  ``profiler`` events, ``--profile-dir`` still writing
  ``zero.trace.json``, with the zero loop's spans in it.
* The span mirror: inside a capture a span is a profiler range on the
  capture's clock, outside one it opens none, its record is the same
  either way, and ``obs/trace.py`` still runs without torch.
"""

import ast
import copy
import json
import os
import subprocess
import sys
import threading
import time
import types

import pytest
import torch

from rocalphago_tpu.obs import jaxobs
from rocalphago_tpu.obs import registry as ref_registry
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.features import Preprocess
from rocalphago_tpu_torch.models import CNNPolicy, CNNValue
from rocalphago_tpu_torch.obs import registry, torchobs, trace
from rocalphago_tpu_torch.ops import _build, chase, labels, tree
from rocalphago_tpu_torch.search import device_mcts
from rocalphago_tpu_torch.training import zero
from torch_port_helpers import one_torch_thread, random_games  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("labels", "chase", "tree")


class Clock:
    """A scripted ``time`` module: each read advances by the next step."""

    def __init__(self, steps):
        self.steps = list(steps)
        self.t = 0.0

    def monotonic(self):
        self.t += self.steps.pop(0)
        return self.t


def series(reg, entry: str) -> dict:
    snap = reg.snapshot()["counters"]
    return {k: snap.get(f'kernel_launches_total{{entry="{entry}",'
                        f'kernel="{k}"}}') for k in KERNELS}


@pytest.fixture
def stub_kernels(monkeypatch):
    """Each op's wrapper replaced by its plain version plus the
    wrapper's counting, as a launch on the card counts; the process and
    untracked totals start from 0 and are restored afterwards."""
    monkeypatch.setattr(_build, "UNTRACKED", [0, 0, 0])
    for mod, names in ((labels, ("labels",)), (chase, ("chase",)),
                       (tree, ("descend", "backup"))):
        monkeypatch.setattr(mod, "launches", 0)
        for name in names:
            monkeypatch.setattr(mod, name, launching(mod, getattr(mod, name)))


def launching(mod, real):
    def stub(*args, **kwargs):
        mod.launches += 1
        _build.count_launch(mod.KERNEL)
        return real(*args, **kwargs)
    return stub


def launch(mod, n: int = 1) -> None:
    """``n`` launches of a stub kernel with nothing to compute."""
    for _ in range(n):
        launching(mod, lambda: None)()


# ------------------------------------------------------------ the wrapper


def test_track_matches_the_references_shapes_stats_and_timing(monkeypatch):
    """The reference's call shapes and delegation; its wrapper times
    each call, the port's keeps no timing at all."""
    monkeypatch.setattr(jaxobs, "time", Clock(
        [0.0, 2.0, 0.0, 0.5, 0.0, 0.25, 0.0, 1.0]))
    regs = (ref_registry.Registry(), registry.Registry())
    out = []
    for mod, reg in zip((jaxobs, torchobs), regs):
        def fn(x, y=1):
            return x + y

        fn.marker = "delegated"
        direct = mod.track("t.direct", fn, registry=reg)
        decorated = mod.track("t.decorated", registry=reg)(fn)
        assert type(direct) is type(decorated) is mod.TrackedFunction
        assert [direct(1), direct(2, y=3), decorated(4), direct(5)] == [
            2, 5, 5, 6]
        assert direct.marker == decorated.marker == "delegated"
        with pytest.raises(AttributeError):
            direct.missing  # noqa: B018 - delegation reaches fn
        assert direct.entry == "t.direct"
        assert decorated.entry == "t.decorated"
        out.append(direct)
    ref_d, got_d = out
    want = ref_d.stats()
    assert want["calls"] == 3 and want["first_call_s"] == 2.0
    assert want["steady_ema_s"] == pytest.approx(0.9 * 0.5 + 0.1 * 1.0)
    # the divergence: each timing field of the reference's is absent
    # here, so a read of it reaches the wrapped function and fails
    for name in ("calls", "first_call_s", "steady_ema_s", "stats"):
        assert hasattr(ref_d, name)
        with pytest.raises(AttributeError):
            getattr(got_d, name)
    assert not hasattr(got_d, "_lock")
    # the reference's compile series have no counterpart
    assert 'jax_compiles_total{entry="t.direct"}' in \
        regs[0].snapshot()["counters"]
    assert not [k for k in regs[1].snapshot()["counters"]
                if k.startswith("jax_")]


def test_a_tracked_method_binds_and_copies(monkeypatch):
    monkeypatch.setattr(_build, "UNTRACKED", [0, 0, 0])
    reg = registry.Registry()

    class Search:
        def __init__(self, k):
            self.k = k

        @torchobs.track("t.method", registry=reg)
        def run(self, n):
            launch(tree, self.k)
            return n * self.k

    assert isinstance(Search.run, torchobs.TrackedFunction)
    assert [Search(2).run(3), Search(1).run(5)] == [6, 5]
    assert series(reg, "t.method") == {"labels": 0, "chase": 0, "tree": 3}
    clone = copy.copy(Search.run)
    assert clone.entry == "t.method" and clone(Search(1), 4) == 4


def entry_names(pkg: str) -> dict:
    """``{entry name: [file:line, ...]}`` of every ``track("name", ...)``
    call (any ``*.track``) with a literal name in a package."""
    out = {}
    for dirpath, _, files in os.walk(os.path.join(ROOT, pkg)):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree_ = ast.parse(fh.read())
            for node in ast.walk(tree_):
                if not (isinstance(node, ast.Call) and node.args):
                    continue
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) else \
                    getattr(fn, "id", None)
                arg = node.args[0]
                if name == "track" and isinstance(arg, ast.Constant) \
                        and isinstance(arg.value, str):
                    out.setdefault(arg.value, []).append(
                        f"{os.path.relpath(path, ROOT)}:{node.lineno}")
    return out


#: the reference's donated programs: attributes of its searchers with no
#: counterpart here (the port donates no buffers). Their entry names are
#: the chunk loops' calls here (``DeviceMCTS._chunk``, ``_chunk_budget``,
#: ``GumbelMCTS.run_phase``, ``_run_phase_budget``).
DONATED = {"run_sims_donated": "device_mcts.run_sims",
           "run_sims_budget_donated": "device_mcts.run_sims_budget",
           "run_phase_donated": "device_mcts.run_phase",
           "run_phase_budget_donated": "device_mcts.run_phase_budget"}


def test_the_tracked_entries_are_the_references():
    want = entry_names("rocalphago_tpu")
    got = entry_names("rocalphago_tpu_torch")
    assert len(want) == 20
    assert sorted(got) == sorted(want), (sorted(set(want) - set(got)),
                                         sorted(set(got) - set(want)))
    # the donated attributes: tracked in the reference, absent here, their
    # names carried by the chunk loops' calls
    with open(os.path.join(ROOT, "rocalphago_tpu/search/device_mcts.py")) \
            as f:
        src = ast.parse(f.read())
    donated = {}
    for node in ast.walk(src):
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Attribute) \
                and node.targets[0].attr.endswith("_donated") \
                and isinstance(node.value, ast.Call) and node.value.args:
            donated[node.targets[0].attr] = node.value.args[0].value
    assert donated == DONATED
    for attr in DONATED:
        assert not hasattr(device_mcts.DeviceMCTS, attr)
        assert not hasattr(device_mcts.GumbelMCTS, attr)
    for name, owner in ((DONATED["run_sims_donated"],
                         device_mcts.DeviceMCTS._chunk),
                        (DONATED["run_sims_budget_donated"],
                         device_mcts.DeviceMCTS._chunk_budget),
                        (DONATED["run_phase_donated"],
                         device_mcts.GumbelMCTS.run_phase),
                        (DONATED["run_phase_budget_donated"],
                         device_mcts.GumbelMCTS._run_phase_budget)):
        assert owner.entry == name


# --------------------------------------------------- launches per thread


def test_launches_land_in_the_innermost_entry_of_their_thread(monkeypatch):
    monkeypatch.setattr(_build, "UNTRACKED", [0, 0, 0])
    for mod in (labels, chase, tree):
        monkeypatch.setattr(mod, "launches", 0)
    reg = registry.Registry()

    @torchobs.track("t.inner", registry=reg)
    def inner():
        launch(chase, 3)

    @torchobs.track("t.outer", registry=reg)
    def outer():
        launch(labels, 2)
        inner()
        launch(chase)

    launch(tree, 4)          # no entry open: untracked
    outer()
    with pytest.raises(KeyError):
        torchobs.track("t.raises", lambda: (launch(labels),
                                            {}["k"]), registry=reg)()
    torchobs.flush_untracked(reg)
    assert series(reg, "t.outer") == {"labels": 2, "chase": 1, "tree": 0}
    assert series(reg, "t.inner") == {"labels": 0, "chase": 3, "tree": 0}
    assert series(reg, "t.raises") == {"labels": 1, "chase": 0, "tree": 0}
    assert series(reg, "untracked") == {"labels": 0, "chase": 0, "tree": 4}
    assert torchobs.registry_launches(reg) == torchobs.process_launches() \
        == {"labels": 3, "chase": 4, "tree": 4}
    torchobs.flush_untracked(reg)            # idempotent
    assert series(reg, "untracked")["tree"] == 4
    assert not _build.THREAD.frames


def test_threads_count_only_their_own_launches(monkeypatch):
    monkeypatch.setattr(_build, "UNTRACKED", [0, 0, 0])
    reg = registry.Registry()
    n_threads = 2 * (os.cpu_count() or 2) + 2
    calls = 60
    start = threading.Barrier(n_threads)
    mods = (labels, chase, tree)

    def worker(i):
        fn = torchobs.track(f"t.thread{i}", registry=reg)(
            lambda: launch(mods[i % 3], 1 + i % 4))
        start.wait(timeout=30)
        for _ in range(calls):
            fn()
            launch(mods[(i + 1) % 3])      # between calls: untracked

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for i in range(n_threads):
        want = dict.fromkeys(KERNELS, 0)
        want[KERNELS[i % 3]] = calls * (1 + i % 4)
        assert series(reg, f"t.thread{i}") == want, i
    untracked = [0, 0, 0]
    for i in range(n_threads):
        untracked[(i + 1) % 3] += calls
    assert _build.UNTRACKED == untracked


# ------------------------------------------------ the port's entry points


def test_the_encoder_and_the_device_search_count_their_launches(
        stub_kernels):
    reg = registry.REGISTRY
    reg.reset()
    size = 7
    cfg = torchgo.GoConfig(size=size)
    states = torchgo.from_pygo(cfg, random_games(size, 3, 10, 30, seed=5),
                               device="cpu")
    pre = Preprocess(("board", "ones", "ladder_capture", "ladder_escape"),
                     cfg=cfg, device="cpu")
    pre.states_to_tensor(states)
    first = series(reg, "encode.batch")["chase"]
    pre.states_to_tensor(states)
    pre.state_signature(states)
    got = series(reg, "encode.batch")
    # both encodes went through the batch entry, launching alike
    assert got["chase"] == chase.launches == 2 * first > 0
    assert got["labels"] == got["tree"] == 0
    assert series(reg, "encode.signature") == dict.fromkeys(KERNELS, 0)
    one = torchgo.GoState(*(x[:1] for x in states))
    pre.advance(one)
    assert series(reg, "encode.delta")["chase"] > 0
    # the single-position entry was never called: it made no series
    assert series(reg, "encode.one") == dict.fromkeys(KERNELS)

    feats = ("board", "ones")
    pol = CNNPolicy(feats, board=size, layers=1, filters_per_layer=4,
                    device="cpu", dtype=torch.float32)
    val = CNNValue(feats + ("color",), board=size, layers=1,
                   filters_per_layer=4, device="cpu", dtype=torch.float32)
    search = device_mcts.make_device_mcts(
        cfg, feats, feats + ("color",), pol.module, val.module, n_sim=6,
        max_nodes=12)
    before = dict(torchobs.process_launches())
    search.run_chunked(states, 4)
    search.run_chunked(states, 4, budget=torch.tensor([1, 6, 3]),
                       n=6)
    runs = series(reg, "device_mcts.run_sims")
    budget = series(reg, "device_mcts.run_sims_budget")
    # two tree launches a simulation, the search's encodes no chase
    assert runs["tree"] == 2 * 6 and budget["tree"] == 2 * 6
    assert series(reg, "device_mcts.init")["tree"] == 0
    tracked = {k: sum(series(reg, e)[k] for e in (
        "device_mcts.init", "device_mcts.run_sims",
        "device_mcts.run_sims_budget")) for k in KERNELS}
    assert tracked == {k: torchobs.process_launches()[k] - before[k]
                       for k in KERNELS}
    torchobs.flush_untracked(reg)
    assert torchobs.registry_launches(reg) == torchobs.process_launches()


def test_the_zero_cli_writes_its_launches_and_trace(stub_kernels,
                                                    monkeypatch, tmp_path):
    registry.reset()
    feats = ("board", "ones", "liberties")
    pol = CNNPolicy(feats, board=5, layers=1, filters_per_layer=4,
                    device="cpu", dtype=torch.float32)
    val = CNNValue(feats + ("color",), board=5, layers=1,
                   filters_per_layer=4, device="cpu", dtype=torch.float32)
    paths = [str(tmp_path / "policy.json"), str(tmp_path / "value.json")]
    pol.save_model(paths[0])
    val.save_model(paths[1])
    out = tmp_path / "run"
    prof = tmp_path / "prof"
    zero.run_training([*paths, str(out), "--game-batch", "2", "--sims", "3",
                       "--move-limit", "6", "--iterations", "1",
                       "--profile-dir", str(prof), "--device", "cpu"])
    assert (prof / zero.PROFILE_TRACE).exists()
    with open(out / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["action"] for r in recs if r["event"] == "profiler"] == [
        "start", "stop"]
    with open(prof / zero.PROFILE_TRACE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"zero.iteration", "zero.selfplay", "zero.replay"} <= names
    snap = [r for r in recs if r["event"] == "registry"][-1]["snapshot"]
    entries = {}
    for key, v in snap["counters"].items():
        if key.startswith("kernel_launches_total{"):
            e = key.split('entry="')[1].split('"')[0]
            k = key.split('kernel="')[1].split('"')[0]
            entries.setdefault(e, {})[k] = v
    assert {"zero.replay_segment", "zero.apply_updates", "device_mcts.init",
            "device_mcts.run_sims", "untracked"} <= set(entries)
    assert all(set(v) == set(KERNELS) for v in entries.values())
    assert entries["device_mcts.run_sims"]["tree"] > 0
    assert sum(entries["zero.replay_segment"].values()) == 0
    assert {k: sum(v[k] for v in entries.values()) for k in KERNELS} == \
        torchobs.process_launches()


# ------------------------------------------------------------ profiler


def test_the_profiler_helpers_are_idempotent_and_emit_events(tmp_path):
    seen = []
    trace.configure(types.SimpleNamespace(
        log=lambda event, **kw: seen.append((event, kw.get("action")))))
    try:
        assert not torchobs.maybe_start_profiler(None)
        assert torchobs.stop_profiler() is None
        assert torchobs.maybe_start_profiler(str(tmp_path / "p"), "cpu",
                                             "x.json")
        assert not torchobs.maybe_start_profiler(str(tmp_path / "q"))
        torch.ones(4).sum()
        path = torchobs.stop_profiler()
        assert path == str(tmp_path / "p" / "x.json")
        assert os.path.exists(path)
        assert torchobs.stop_profiler() is None
        with torchobs.profiler_session(str(tmp_path / "s")) as started:
            assert started
        assert os.path.exists(tmp_path / "s" / "trace.json")
    finally:
        trace.configure(None)
    assert [e for e in seen if e[0] == "profiler"] == [
        ("profiler", "start"), ("profiler", "stop"),
        ("profiler", "start"), ("profiler", "stop")]


def kineto_ranges(prof, name: str) -> list:
    """``(start_ns, end_ns)`` of the host ranges named ``name``."""
    return [(e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name() == name]


def test_a_span_is_a_profiler_range_on_the_captures_clock(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    records = []
    trace.configure(types.SimpleNamespace(
        log=lambda event, **kw: records.append(kw)))
    try:
        with trace.span("x.outside", tag=1):
            torch.ones(2).sum()
        assert opened == []
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            lo = time.time_ns()
            with trace.span("x.y", tag=1):
                torch.ones(2).sum()
            mid = time.time_ns()
            with pytest.raises(ValueError):
                with trace.span("x.raises"):
                    raise ValueError("boom")
            hi = time.time_ns()
        with trace.span("x.after"):
            pass
    finally:
        trace.configure(None)
    assert opened == ["x.y", "x.raises"]
    (start, end), = kineto_ranges(prof, "x.y")
    assert lo <= start <= end <= mid
    (start, end), = kineto_ranges(prof, "x.raises")
    assert mid <= start <= end <= hi
    # the record is the same inside a capture as outside one
    assert [sorted(r) for r in records[:2]] == [
        ["depth", "dur_s", "name", "ok", "parent", "path", "start",
         "tag"]] * 2
    assert records[2]["ok"] is False and "boom" in records[2]["error"]


def test_the_trace_module_runs_a_span_without_torch():
    code = ("import sys\n"
            "from rocalphago_tpu_torch.obs import trace\n"
            "with trace.span('x.y'):\n"
            "    pass\n"
            "assert 'torch' not in sys.modules\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
