"""The trainers' instrumentation in the port against the reference's,
on the CPU.

* The inventory: every literal span name with its tag keys, fault
  barrier, registry metric name with its label keys and histogram
  edges, read with ``ast`` from each reference module and its port, is
  the same set (the port's SL loop is the value trainer's too, its
  names built from the class's ``PHASE``); ``obs`` carries
  ``registry.timed`` and ``trace.sink``.
* Live span records: both packages' SL trainers, one epoch on the same
  corpus, emit the same span paths, parents and tags in the same order,
  and leave the same registry keys (the reference's JAX compile
  counters aside), with equal counts of ``train_data_wait_seconds``.
* The chunk pipeline: both classes under one script of pushes, retires
  and a scripted clock give the same counts, gap time, occupancy and
  registry snapshot.
* The replay buffer, the supervisor, an actor and the learner: one
  script through each package's classes gives the same counters and
  gauges (values that are wall times only present in both).
* The report: a port zero run renders through the reference's
  ``scripts/obs_report.py`` with every ``zero.*`` span and the device
  search's simulation counter.
"""

import ast
import importlib.util
import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from rocalphago_tpu.data import replay as ref_replay
from rocalphago_tpu.io.checkpoint import pack_rng
from rocalphago_tpu.models import CNNPolicy as RefPolicy
from rocalphago_tpu.obs import registry as ref_registry
from rocalphago_tpu.obs import trace as ref_trace
from rocalphago_tpu.runtime import faults as ref_faults
from rocalphago_tpu.runtime import pipeline as ref_pipeline
from rocalphago_tpu.runtime import supervisor as ref_supervisor
from rocalphago_tpu.training import actor as ref_actor
from rocalphago_tpu.training import learner as ref_learner
from rocalphago_tpu.training import sl as ref_sl
from rocalphago_tpu_torch.data import replay
from rocalphago_tpu_torch.models import CNNPolicy, CNNValue
from rocalphago_tpu_torch.obs import registry
from rocalphago_tpu_torch.obs import trace
from rocalphago_tpu_torch.runtime import faults, pipeline, supervisor
from rocalphago_tpu_torch.training import actor, learner, sl, zero
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "rocalphago_tpu")
PORT = os.path.join(ROOT, "rocalphago_tpu_torch")

# ------------------------------------------------------------ inventory

#: a reference module → the port module holding its instrumentation
#: (the value trainer's is the SL loop's under the prefix "value")
ROWS = [
    ("runtime/pipeline.py", "runtime/pipeline.py"),
    ("training/sl.py", "training/sl.py"),
    ("training/value.py", "training/sl.py"),
    ("training/rl.py", "training/rl.py"),
    ("training/zero.py", "training/zero.py"),
    ("training/learner.py", "training/learner.py"),
    ("training/actor.py", "training/actor.py"),
    ("training/curriculum.py", "training/curriculum.py"),
    ("data/replay.py", "data/replay.py"),
    ("runtime/supervisor.py", "runtime/supervisor.py"),
    ("interface/selfplay_cli.py", "interface/selfplay_cli.py"),
    ("obs/jaxobs.py", "obs/torchobs.py"),
]
METRIC_KINDS = ("counter", "gauge", "histogram")

#: the divergences of a row: the reference's names the port drops and
#: the port's own. The port compiles nothing at run time, so the
#: reference's compile series go, and each tracked call counts its
#: kernel launches instead.
DIVERGENT = {
    "obs/jaxobs.py": (
        {("counter", "jax_compiles_total", ("entry",), None),
         ("histogram", "jax_compile_seconds", ("entry",), None)},
        {("counter", "kernel_launches_total", ("entry", "kernel"), None)}),
}


def _name_pattern(node):
    """A string literal as it is; an f-string with ``{}`` per field."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        return "".join(v.value if isinstance(v, ast.Constant) else "{}"
                       for v in node.values)
    return None


def inventory(path: str) -> set:
    """``("span", name, tag keys)``, ``("barrier", name)`` and
    ``(kind, metric, label keys, edges)`` for every call in ``path``
    whose first argument is a literal name."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        fn = node.func
        fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(
            fn, "id", None)
        name = _name_pattern(node.args[0])
        if name is None:
            continue
        keys = tuple(sorted(k.arg for k in node.keywords
                            if k.arg not in (None, "edges")))
        if fname == "span":
            out.add(("span", name, keys))
        elif fname == "barrier":
            out.add(("barrier", name))
        elif fname in METRIC_KINDS:
            edges = next((k.value for k in node.keywords
                          if k.arg == "edges"), None)
            if edges is not None:
                edges = (edges.attr if isinstance(edges, ast.Attribute)
                         else ast.unparse(edges))
            out.add((fname, name, keys, edges))
    return out


def expand(items: set, phase: str) -> set:
    """The port's ``{}`` name patterns with the trainer's prefix."""
    return {(item[0], item[1].replace("{}", phase), *item[2:])
            for item in items}


@pytest.mark.parametrize("ref,port", ROWS,
                         ids=[r[0].split("/")[-1][:-3] for r in ROWS])
def test_inventory_is_the_references(ref, port):
    from rocalphago_tpu_torch.training.value import ValueTrainer

    phase = (ValueTrainer if ref.endswith("value.py")
             else sl.SLTrainer).PHASE
    want = inventory(os.path.join(REF, ref))
    got = expand(inventory(os.path.join(PORT, port)), phase)
    assert want, ref
    dropped, added = DIVERGENT.get(ref, (set(), set()))
    # each listed divergence is real: in one package and not the other
    assert dropped <= want and not dropped & got, dropped
    assert added <= got and not added & want, added
    assert got - added == want - dropped, (
        sorted((want - dropped) - got, key=str),
        sorted((got - added) - want, key=str))


def test_inventory_of_obs():
    for name in ("DEFAULT_EDGES", "RATE_EDGES", "COUNT_EDGES"):
        assert getattr(registry, name) == getattr(ref_registry, name)
    h = registry.Histogram()
    assert list(registry.timed(iter([1, 2, 3]), h)) == [1, 2, 3]
    assert h.count == 3
    log = object()
    trace.configure(log)
    try:
        assert trace.sink() is log
    finally:
        trace.configure(None)
    assert trace.sink() is None


# ------------------------------------------------------- SL span records

SIZE = 7
FEATURES = ("board", "ones")
PLANES = 4


def write_corpus(prefix: str, n: int = 96, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 2, (n, SIZE, SIZE, PLANES)).astype(np.uint8)
    actions = (states[:, :, :, 0].sum((1, 2)) % (SIZE * SIZE)).astype(
        np.int32)
    np.savez(f"{prefix}-00000.npz", states=states, actions=actions)
    with open(f"{prefix}-manifest.json", "w") as f:
        json.dump({"board_size": SIZE, "planes": PLANES,
                   "shard_counts": [n], "features": list(FEATURES)}, f)


def records(path: str, event: str) -> list:
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["event"] == event]


def span_shape(r: dict) -> dict:
    return {k: v for k, v in r.items()
            if k not in ("time", "dur_s", "start")}


def test_sl_trainer_span_records_and_registry(tmp_path):
    prefix = str(tmp_path / "corpus")
    write_corpus(prefix)
    kw = dict(train_data=prefix, minibatch=16, epochs=1, epoch_length=3,
              learning_rate=0.05, train_val_test=(0.8, 0.1, 0.1),
              seed=1, max_validation_batches=1)
    ref_registry.reset()
    registry.reset()
    ref_sl.SLTrainer(ref_sl.SLConfig(out_dir=str(tmp_path / "ref"), **kw),
                     net=RefPolicy(FEATURES, board=SIZE, layers=1,
                                   filters_per_layer=2)).run()
    sl.SLTrainer(sl.SLConfig(out_dir=str(tmp_path / "port"),
                             device="cpu", **kw),
                 net=CNNPolicy(FEATURES, board=SIZE, layers=1,
                               filters_per_layer=2, device="cpu")).run()
    ref_trace.configure(None)
    trace.configure(None)
    want = [span_shape(r) for r in records(
        str(tmp_path / "ref" / "metrics.jsonl"), "span")]
    got = [span_shape(r) for r in records(
        str(tmp_path / "port" / "metrics.jsonl"), "span")]
    assert [r["path"] for r in want] == [
        "sl.epoch/sl.train", "sl.epoch/sl.eval", "sl.epoch/sl.export",
        "sl.epoch/sl.save", "sl.epoch"]
    assert got == want
    snaps = [records(str(tmp_path / side / "metrics.jsonl"),
                     "registry")[-1]["snapshot"] for side in ("ref", "port")]
    # the port's own families: launch counts, and the prefetcher's
    port_only = ("jax_", "kernel_launches_total", "prefetch_")
    for kind in ("counters", "gauges", "histograms"):
        keys = [{k for k in s[kind] if not k.startswith(port_only)}
                for s in snaps]
        assert keys[0] == keys[1], kind
    assert not [k for kind in ("counters", "gauges", "histograms")
                for k in snaps[0][kind] if k.startswith("prefetch_")]
    # the port's launch series in their place: each tracked step and the
    # untracked rest, every kernel at 0 on the CPU
    launches = {k: v for k, v in snaps[1]["counters"].items()
                if k.startswith("kernel_launches_total")}
    assert launches == {
        f'kernel_launches_total{{entry="{e}",kernel="{k}"}}': 0
        for e in ("sl.train_step", "sl.eval_step", "untracked")
        for k in ("labels", "chase", "tree")}
    key = 'train_data_wait_seconds{trainer="sl"}'
    counts = [s["histograms"][key]["count"] for s in snaps]
    assert counts[0] == counts[1] == 4     # 3 steps, and the 4th batch
    # the prefetcher handed out those 4 batches and staged at least them
    assert snaps[1]["counters"]["prefetch_batches_total"] == 4
    staged = [snaps[1]["histograms"][f'prefetch_stage_seconds{{stage="{s}"}}']
              ["count"] for s in ("read", "pin", "put")]
    assert staged[0] == staged[1] == staged[2] >= 4


# -------------------------------------------------------- chunk pipeline


class Clock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t


def test_chunk_pipeline_accounting_is_the_references(monkeypatch):
    clock = Clock()
    fake = types.SimpleNamespace(monotonic=clock.monotonic)
    monkeypatch.setattr(ref_pipeline, "time", fake)
    monkeypatch.setattr(pipeline, "time", fake)
    regs = (ref_registry.Registry(), registry.Registry())
    pipes = (ref_pipeline.ChunkPipeline(1, runner="zero.replay",
                                        registry=regs[0]),
             pipeline.ChunkPipeline("cpu", runner="zero.replay",
                                    registry=regs[1]))
    script = [("push", 0.5), ("push", 0.25), ("retire", 1.0),
              ("push", 0.75), ("retire", 0.5), ("push", 0.25),
              ("finish", 0.5), ("push", 0.5), ("push", 0.25),
              ("drain", 1.0), ("finish", 0.0)]
    seen = [[], []]
    for op, dt in script:
        for side, p in enumerate(pipes):
            if op == "push":
                out = p.push(None, payload=clock.t)
            elif op == "retire":
                out = [p._retire()]
            else:
                out = getattr(p, op)()
            seen[side].append((out, p.pending(), p.chunks, p.gaps,
                               p.gap_s, p.wall_s, p.occupancy))
        clock.t += dt
    assert seen[0] == seen[1]
    ref, port = pipes
    assert port.chunks == 6 and port.gaps == 2 and 0 < port.occupancy < 1
    assert repr(port) == repr(ref)
    assert regs[1].snapshot() == regs[0].snapshot()
    assert set(regs[1].snapshot()["gauges"]) == {
        'device_occupancy{runner="zero.replay"}'}
    for p in pipes:
        p.reset_stats()
    assert (port.chunks, port.gaps, port.gap_s, port.wall_s) == (0, 0, 0, 0)
    port.push()
    with pytest.raises(RuntimeError, match="in flight"):
        port.reset_stats()
    unnamed = pipeline.ChunkPipeline("cpu", registry=regs[1])
    unnamed.push()
    unnamed.drain()
    assert regs[1].snapshot()["counters"] == {
        'dispatch_chunks_total{runner="zero.replay"}': 7}


# ---------------------------------- replay, supervisor, actor, learner


def metric_view(snap: dict, timed=()) -> dict:
    """Counters and gauges by value, histograms by count; ``timed``
    key prefixes (wall times) only as present."""
    out = {}
    for kind in ("counters", "gauges"):
        for k, v in snap[kind].items():
            out[k] = "set" if k.startswith(timed) and v is not None else v
    for k, v in snap["histograms"].items():
        out[k] = v["count"]
    return out


def games_of(cls, seed: int, b: int = 2):
    r = np.random.default_rng(seed)
    return cls(actions=r.integers(0, 26, (3, b)).astype(np.int32),
               live=r.integers(0, 2, (3, b)).astype(bool),
               visits=r.integers(0, 5, (3, b, 26)).astype(np.int32),
               winners=r.integers(-1, 2, (b,)).astype(np.int32),
               finished=r.integers(0, 2, (b,)).astype(bool))


def replay_script(mod, spill: str) -> None:
    buf = mod.ReplayBuffer(capacity=2, spill_dir=spill, seed=3)
    for i in range(3):                   # the third evicts the first
        assert buf.put(games_of(mod.ZeroGames, i, b=i + 1), version=i)
    assert buf.next_batch(timeout=0).version == 1
    assert buf.sample(timeout=0).version == 2
    assert buf.next_batch(timeout=0).version == 2
    assert buf.next_batch(timeout=0) is None
    buf.put(games_of(mod.ZeroGames, 7, b=2), version=7)
    time.sleep(0.005)     # the reference's spill tag is per millisecond
    again = mod.ReplayBuffer(capacity=2, spill_dir=spill)
    assert again.restore() == 1 and again.fill == 1


def test_replay_buffer_metrics_are_the_references(tmp_path):
    views = []
    for reg, mod in ((ref_registry, ref_replay), (registry, replay)):
        reg.reset()
        replay_script(mod, str(tmp_path / mod.__name__))
        views.append(metric_view(reg.snapshot(),
                                 timed=("replay_ingest_per_min",)))
    assert views[1] == views[0]
    assert views[1]["replay_ingest_games_total"] == 8
    assert views[1]["replay_evicted_games_total"] == 1
    assert views[1]["replay_spilled_total"] == 5
    assert views[1]["replay_sample_staleness_seconds"] == 3


def wait_for(pred, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {msg}")


class Worker:
    """The supervisor's worker protocol: dies at once with ``error`` set
    when ``fail``, else beats once and ends cleanly."""

    def __init__(self, fail: bool, beat):
        self.fail, self.beat, self.error = fail, beat, None
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        if self.fail:
            self.error = RuntimeError("worker died")
        else:
            self.beat()

    def start(self):
        self._t.start()
        return self

    def stop(self, timeout=None):
        self._t.join(timeout)

    def alive(self):
        return self._t.is_alive()


def supervisor_script(mod, faults_mod) -> None:
    policy = mod.RestartPolicy(max_deaths=3, window_s=60.0, base_delay=0.0)
    sup = mod.Supervisor(policy=policy, poll_s=0.005)
    sup.add(lambda attempt, beat: Worker(attempt == 0, beat), name="w",
            restartable=True)
    sup.add(lambda attempt, beat: Worker(True, beat), name="once",
            restartable=False)
    sup.start()
    try:
        wait_for(lambda: all(h.parked or h.last_mttr_s is not None
                             for h in sup.handles()), msg="supervisor")
    finally:
        sup.stop()
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] == 1:
            raise faults_mod.InjectedFault("flake")
        if calls[0] == 2:
            raise RuntimeError("bug")

    t = mod.SupervisedThread(flaky, "loop", policy=policy).start()
    t.join(10)

    def dying():
        raise RuntimeError("always")

    t = mod.SupervisedThread(dying, "loop2", policy=mod.RestartPolicy(
        max_deaths=1, window_s=60.0, base_delay=0.0)).start()
    t.join(10)
    assert t.parked


def test_supervisor_metrics_are_the_references():
    views = []
    for reg, mod, fm in ((ref_registry, ref_supervisor, ref_faults),
                         (registry, supervisor, faults)):
        reg.reset()
        supervisor_script(mod, fm)
        views.append(metric_view(reg.snapshot()))
    assert views[1] == views[0]
    assert views[1] == {
        'supervisor_restarts_total{reason="error",worker="w"}': 1,
        'supervisor_parked_total{worker="once"}': 1,
        'supervisor_restarts_total{reason="transient",worker="loop"}': 1,
        'supervisor_restarts_total{reason="error",worker="loop"}': 1,
        'supervisor_parked_total{worker="loop2"}': 1,
        "supervisor_mttr_seconds": 1}


def actor_learner_script(side: str, tmp) -> list:
    """Two lockstep games through an actor into a buffer, a learner step
    on each and one on the empty buffer, a publisher bump, and an actor
    killed by ``inject_fault``. Returns the learned versions."""
    if side == "ref":
        mods = (ref_actor, ref_learner, ref_replay)
        rng = pack_rng(__import__("jax").random.key(0))

        def to_metric(x):
            return np.float32(x)
    else:
        mods = (actor, learner, replay)
        rng = torch.Generator().manual_seed(0).get_state()

        def to_metric(x):
            return torch.tensor(x, dtype=torch.float32)
    act, lrn, rep = mods
    buf = rep.ReplayBuffer(capacity=4, spill_dir=str(tmp))
    pub = act.ParamsPublisher()

    def play(policy, value, key):
        games = games_of(rep.ZeroGames, policy)
        if side == "port":
            games = rep.ZeroGames(*(None if x is None else torch.as_tensor(x)
                                    for x in games))
        return games

    a = act.SelfplayActor(play, pub, buf, rng, name="a0", lockstep=True,
                          games=2, poll_s=0.01)
    a.start()
    pub.publish(0, 0, version=0)
    wait_for(lambda: buf.fill == 1, msg="game 0")
    pub.publish(1, 1, version=1)
    wait_for(lambda: not a.alive(), msg="actor")
    assert a.error is None and a.games_played == 2

    def learn(state, games):
        return state + 1, {"loss": to_metric(0.5)}

    lr = lrn.ZeroLearner(learn, buf)
    versions = []
    for _ in range(2):
        state, m, entry = lr.step(0, timeout=1.0)
        versions.append(m["replay_version"])
    assert lr.step(0, timeout=0.01) is None
    assert lr.steps == 2
    pub.publish(2, 2)
    dead = act.SelfplayActor(play, pub, buf, rng, name="a1", games=1,
                             poll_s=0.01)
    dead.inject_fault()
    dead.start()
    wait_for(lambda: not dead.alive(), msg="killed actor")
    assert type(dead.error).__name__ == "InjectedKill"
    assert dead.games_played == 0
    return versions


def test_actor_and_learner_metrics_are_the_references(tmp_path):
    views, versions = [], []
    for side, reg in (("ref", ref_registry), ("port", registry)):
        reg.reset()
        versions.append(actor_learner_script(side, tmp_path / side))
        views.append(metric_view(reg.snapshot(), timed=(
            "learner_idle_frac", "replay_ingest_per_min")))
    assert versions[0] == versions[1] == [0, 1]
    assert views[1] == views[0]
    assert views[1]['actor_games_total{actor="a0"}'] == 2
    assert views[1]["actor_params_version"] == 2
    assert views[1]["learner_steps_total"] == 2
    assert views[1]["learner_wait_seconds"] == 2


# ------------------------------------------------------------ the report

#: the reference's span paths of a zero iteration (tests/test_obs.py)
ZERO_PATHS = ("zero.iteration", "zero.iteration/zero.selfplay",
              "zero.iteration/zero.replay", "zero.iteration/zero.update",
              "zero.iteration/zero.gate", "zero.iteration/zero.export",
              "zero.iteration/zero.save")


def load_obs_report():
    spec = importlib.util.spec_from_file_location(
        "obs_report", os.path.join(ROOT, "scripts", "obs_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_a_port_zero_run_renders_through_obs_report(tmp_path, capsys):
    feats = ("board", "ones")
    pj, vj = str(tmp_path / "p.json"), str(tmp_path / "v.json")
    CNNPolicy(feats, board=5, layers=1, filters_per_layer=2,
              device="cpu").save_model(pj)
    CNNValue(feats + ("color",), board=5, layers=1, filters_per_layer=2,
             device="cpu").save_model(vj)
    out = tmp_path / "out"
    registry.reset()
    zero.run_training([pj, vj, str(out), "--game-batch", "2",
                       "--iterations", "1", "--move-limit", "8", "--sims",
                       "2", "--sim-chunk", "2", "--save-every", "1",
                       "--gate-games", "2", "--device", "cpu"])
    capsys.readouterr()
    spans = {r["path"]: r for r in records(str(out / "metrics.jsonl"),
                                           "span")}
    for path in ZERO_PATHS:
        assert spans[path]["ok"], path
    assert spans["zero.iteration/zero.selfplay"]["plies"] == 8
    report = load_obs_report()
    assert report.main([str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    for path in ZERO_PATHS:       # the span tree: names indented by depth
        row = "  " * path.count("/") + path.rpartition("/")[2] + " "
        assert any(line.startswith(row) for line in lines), path
    # the pipelined runners' table: the replay's occupancy row
    assert any(line.startswith("zero.replay ") and "%" in line
               for line in lines)
    assert report.main([str(out), "--json"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert set(ZERO_PATHS) <= set(data["spans"])
    reg = data["registry"]
    assert reg["counters"]["device_mcts_sims_total"] > 0
    assert 'device_occupancy{runner="zero.replay"}' in reg["gauges"]
    assert reg["counters"]['dispatch_chunks_total{runner="zero.replay"}'] \
        == 1
