"""The port's actor/learner plumbing, on the CPU: the params publisher
(``training/actor.py``), the lockstep actor walking the generator chain,
parking and retries, the learner's idle accounting
(``training/learner.py``), the supervisor's restart, park, refusal,
drain and stale tags (``runtime/supervisor.py``), the supervised
thread, and the watchdog's stall event (``runtime/watchdog.py``); then
the zero CLI drained by SIGTERM and resumed to a never-drained run's
bits, and a free-running fleet of two actors.

The units mirror the reference's ``tests/test_replay.py`` and
``tests/test_fleet_chaos.py``; waits are on events and polled
conditions with generous limits, never on a fixed sleep racing a
thread.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from rocalphago_tpu.runtime import supervisor as ref_supervisor
from rocalphago_tpu_torch.data.replay import ReplayBuffer, ZeroGames
from rocalphago_tpu_torch.models import CNNPolicy, CNNValue
from rocalphago_tpu_torch.runtime import watchdog
from rocalphago_tpu_torch.runtime.supervisor import (
    RestartPolicy,
    SupervisedThread,
    Supervisor,
)
from rocalphago_tpu_torch.runtime.watchdog import Watchdog, waiting_on
from rocalphago_tpu_torch.training import zero
from rocalphago_tpu_torch.training.actor import (
    ParamsPublisher,
    SelfplayActor,
    games_to_host,
)
from rocalphago_tpu_torch.training.learner import ZeroLearner
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def make_games(seed=0, t=3, b=2, a=26):
    r = np.random.default_rng(seed)
    return ZeroGames(
        actions=torch.as_tensor(r.integers(0, a, (t, b)).astype(np.int32)),
        live=torch.as_tensor(r.integers(0, 2, (t, b)).astype(bool)),
        visits=torch.as_tensor(r.integers(0, 5, (t, b, a)).astype(np.int32)),
        winners=torch.as_tensor(r.integers(-1, 2, (b,)).astype(np.int32)),
        finished=torch.as_tensor(r.integers(0, 2, (b,)).astype(bool)))


def games_equal(a, b):
    return all((x is None and y is None)
               or np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def wait_for(pred, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


class Cap:
    """A ``MetricsLogger``-shaped event capture."""

    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append((event, fields))

    def named(self, event):
        return [f for e, f in self.events if e == event]


# ----------------------------------------------------- publisher, actor


def test_publisher_versions_and_waits():
    pub = ParamsPublisher()
    assert pub.get()[0] == -1
    assert pub.wait_version(0, timeout=0) is None
    assert pub.publish("p0", "v0", version=0) == 0
    assert pub.wait_version(0, timeout=0) == (0, "p0", "v0")
    waiting = threading.Event()
    got = []

    def consumer():
        waiting.set()
        got.append(pub.wait_version(3))

    t = threading.Thread(target=consumer)
    t.start()
    waiting.wait()
    pub.publish("p5", "v5", version=5)
    t.join()
    assert got == [(5, "p5", "v5")]
    assert pub.publish("p6", "v6") == 6          # bumps without a version


def test_lockstep_actor_waits_for_versions_and_walks_the_chain():
    played = []

    def fake_play(policy, value, game_seed):
        played.append((policy, game_seed))
        return make_games(policy)

    rng0 = torch.Generator().manual_seed(11).get_state()
    pub = ParamsPublisher()
    buf = ReplayBuffer(capacity=8)
    actor = SelfplayActor(fake_play, pub, buf, rng0, lockstep=True,
                          games=3, poll_s=0.01).start()
    # nothing is played before version 0 exists
    assert buf.next_batch(timeout=0.05) is None and not played
    for v in range(3):
        pub.publish(v, None, version=v)
        e = buf.next_batch()
        assert e.version == v
        assert games_equal(e.games, games_to_host(make_games(v)))
        assert isinstance(e.games.actions, np.ndarray)
    wait_for(lambda: not actor.alive(), msg="actor done")
    assert actor.error is None and actor.games_played == 3
    rng, seeds = rng0, []
    for _ in range(3):
        rng, s = zero.next_keys(rng)
        seeds.append(s)
    assert [s for _, s in played] == seeds
    assert [p for p, _ in played] == [0, 1, 2]


def test_actor_retries_transient_and_parks_on_other_errors():
    calls = []

    def flaky(policy, value, seed):
        calls.append(seed)
        if len(calls) == 1:
            raise OSError("a transient filesystem error")
        return make_games(0)

    pub = ParamsPublisher()
    pub.publish(0, 0, version=0)
    buf = ReplayBuffer(capacity=2)
    cap = Cap()
    actor = SelfplayActor(flaky, pub, buf,
                          torch.Generator().manual_seed(0).get_state(),
                          games=1, poll_s=0.01, metrics=cap).start()
    assert buf.next_batch().version == 0
    wait_for(lambda: not actor.alive(), msg="actor done")
    assert actor.error is None and len(calls) == 2 and calls[0] == calls[1]
    assert cap.named("retry")

    def bad(policy, value, seed):
        raise ValueError("a broken net")

    actor = SelfplayActor(bad, pub, buf,
                          torch.Generator().manual_seed(0).get_state(),
                          poll_s=0.01, metrics=cap).start()
    wait_for(lambda: not actor.alive(), msg="actor parked")
    assert isinstance(actor.error, ValueError) and actor.games_played == 0
    assert cap.named("actor_error")


def test_learner_idle_accounting_and_metrics():
    def fake_learn(state, games):
        time.sleep(0.02)
        return state + 1, {"loss": torch.tensor(float(
            np.asarray(games.winners).sum()))}

    buf = ReplayBuffer(capacity=4)
    learner = ZeroLearner(fake_learn, buf)
    assert learner.step(0, timeout=0.01) is None     # starved
    assert learner.idle_frac == 1.0
    buf.put(games_to_host(make_games(0)), version=9)
    state, m, entry = learner.step(0, timeout=0)
    assert state == 1 and entry.version == 9 and learner.steps == 1
    assert m["replay_version"] == 9 and "replay_staleness_s" in m
    assert m["loss"] == float(make_games(0).winners.sum())
    assert 0.0 < learner.idle_frac < 1.0
    buf.put(games_to_host(make_games(1)), version=10)
    sampler = ZeroLearner(fake_learn, buf, sample=True)
    assert sampler.step(0, timeout=0)[2].version == 10
    assert buf.fill == 1                             # a sample stays


# ------------------------------------------------------- supervisor


class FakeWorker:
    """The worker protocol: optionally dies the moment it starts."""

    def __init__(self, die_with=None, beat=None):
        self.error = None
        self._alive = False
        self._die_with = die_with
        self._beat = beat

    def start(self):
        if self._die_with is not None:
            self.error = self._die_with
        else:
            self._alive = True
            if self._beat is not None:
                self._beat()

    def stop(self, timeout=None):
        self._alive = False

    def alive(self):
        return self._alive


def quick_policy(max_deaths=3):
    return RestartPolicy(max_deaths=max_deaths, window_s=60.0,
                         base_delay=0.01, max_delay=0.05)


def test_restart_policy_is_the_references():
    mine, ref = quick_policy(), ref_supervisor.RestartPolicy(
        max_deaths=3, window_s=60.0, base_delay=0.01, max_delay=0.05)
    for attempt in range(1, 6):
        assert mine.delay(attempt, "actor:0") == ref.delay(attempt,
                                                           "actor:0")
    for deaths in ([1.0], [1.0, 2.0, 3.0], [0.0, 70.0, 71.0]):
        assert mine.crash_looping(deaths, 71.0) == \
            ref.crash_looping(deaths, 71.0)
    assert mine.classify(OSError("x")) == ref.classify(OSError("x")) \
        == "transient"
    assert mine.classify(ValueError("x")) == "error"
    assert RestartPolicy().max_deaths == ref_supervisor.default_max_deaths()


def test_supervisor_restarts_and_stamps_mttr():
    cap = Cap()
    sup = Supervisor(metrics=cap, policy=quick_policy(), poll_s=0.01)

    def factory(attempt, beat):
        return FakeWorker(die_with=RuntimeError("boom") if attempt == 0
                          else None, beat=beat)

    h = sup.add(factory, name="actor:0")
    try:
        sup.start()
        wait_for(lambda: h.restarts == 1 and h.alive(), msg="restart")
        wait_for(lambda: h.last_mttr_s is not None, msg="recovery")
    finally:
        sup.stop()
    (restart,) = cap.named("worker_restart")
    assert restart["worker"] == "actor:0" and restart["reason"] == "error"
    assert "RuntimeError: boom" in restart["error"]
    (rec,) = cap.named("worker_recovered")
    assert rec["mttr_s"] == pytest.approx(h.last_mttr_s, abs=1e-3)
    assert not h.parked


def test_supervisor_parks_a_crash_loop_and_refuses_lockstep():
    cap = Cap()
    sup = Supervisor(metrics=cap, policy=quick_policy(max_deaths=2),
                     poll_s=0.01)
    loop = sup.add(lambda a, beat: FakeWorker(die_with=RuntimeError("x")),
                   name="actor:1")
    lock = sup.add(lambda a, beat: FakeWorker(die_with=OSError("k")),
                   name="actor:0", restartable=False)
    try:
        sup.start()
        wait_for(lambda: loop.parked and lock.parked, msg="parks")
    finally:
        sup.stop()
    assert loop.restarts == 1 and lock.restarts == 0
    parks = {p["worker"]: p for p in cap.named("worker_parked")}
    assert parks["actor:1"]["reason"] == "crash_loop"
    assert parks["actor:1"]["deaths"] == 2
    assert parks["actor:0"]["reason"] == "restart_refused"
    assert [h.name for h in sup.parked()] == ["actor:1", "actor:0"]


def test_supervisor_drain_stops_restarts_and_sigterm_requests_it():
    cap = Cap()
    sup = Supervisor(metrics=cap, policy=quick_policy(), poll_s=0.01)
    worker = FakeWorker()
    h = sup.add(lambda attempt, beat: worker, name="actor:0")
    old = signal.getsignal(signal.SIGTERM)
    try:
        assert sup.install_sigterm()
        sup.start()
        assert not sup.draining
        os.kill(os.getpid(), signal.SIGTERM)
        wait_for(lambda: sup.draining, msg="drain")
        sup.request_drain(reason="again")            # idempotent
        assert sup.drain_reason == "sigterm"
        worker.error, worker._alive = RuntimeError("died mid-drain"), False
        wait_for(lambda: h.finished is False and not h.alive(), msg="dead")
        time.sleep(0.05)
        assert h.restarts == 0 and not h.parked
    finally:
        sup.stop()
    assert signal.getsignal(signal.SIGTERM) == old
    assert cap.named("drain") == [{"phase": "requested",
                                   "reason": "sigterm"}]


def test_supervisor_tags_a_stale_worker_for_the_watchdog():
    cap = Cap()
    sup = Supervisor(metrics=cap, policy=quick_policy(), poll_s=0.01,
                     heartbeat_s=0.05)
    h = sup.add(lambda attempt, beat: FakeWorker(), name="actor:9")
    wd = Watchdog(0.05, metrics=cap, exit=False, poll_s=0.01, name="fleet")
    try:
        sup.start()
        wait_for(lambda: "actor:9" in watchdog.waiting_phases(),
                 msg="stale tag")
        wd.start()
        wait_for(lambda: cap.named("stall"), msg="stall event")
        assert "actor:9" in (cap.named("stall")[0]["waiting_on"] or "")
        h.beat()
        wait_for(lambda: "actor:9" not in watchdog.waiting_phases(),
                 msg="tag cleared")
    finally:
        wd.stop()
        sup.stop()
    assert "actor:9" not in watchdog.waiting_phases()


def test_supervised_thread_reenters_then_parks():
    cap = Cap()
    runs, parked = [], threading.Event()

    def body():
        runs.append(1)
        if len(runs) < 2:
            raise RuntimeError("once")

    t = SupervisedThread(body, "dispatcher", policy=quick_policy(),
                         metrics=cap).start()
    t.join(20.0)
    assert len(runs) == 2 and t.restarts == 1 and not t.parked

    def always():
        raise RuntimeError("always")

    t = SupervisedThread(always, "dispatcher", policy=quick_policy(2),
                         metrics=cap, on_park=parked.set).start()
    t.join(20.0)
    assert t.parked and parked.is_set() and t.restarts == 1
    assert cap.named("worker_parked")[-1]["reason"] == "crash_loop"


# --------------------------------------------------------- watchdog


def test_watchdog_stall_names_the_waiting_phase_and_aborts():
    cap = Cap()
    buf = ReplayBuffer(capacity=2)
    waiting = threading.Event()

    def starving():
        with waiting_on("outer"):
            waiting.set()
            buf.next_batch()

    t = threading.Thread(target=starving)
    t.start()
    waiting.wait()
    wait_for(lambda: "replay_fill" in watchdog.waiting_phases(),
             msg="the buffer's tag")
    aborted = threading.Event()
    wd = Watchdog(0.05, metrics=cap, abort_fn=aborted.set, exit=False,
                  poll_s=0.01, name="starve").start()
    aborted.wait(20.0)
    wd.stop()
    buf.close()
    t.join()
    (stall,) = cap.named("stall")
    assert stall["waiting_on"] == "replay_fill" and wd.stalls == 1
    assert watchdog.waiting_phases() == ()
    with pytest.raises(ValueError):
        Watchdog(0)


# ------------------------------------------------------- the zero CLI


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    d = tmp_path_factory.mktemp("specs")
    feats = ("board", "ones")
    CNNPolicy(feats, board=5, layers=2, filters_per_layer=8, seed=1,
              device="cpu").save_model(str(d / "policy.json"))
    CNNValue(feats + ("color",), board=5, layers=2, filters_per_layer=8,
             seed=2, device="cpu").save_model(str(d / "value.json"))
    return str(d / "policy.json"), str(d / "value.json")


def cli(specs, out, *extra):
    return zero.run_training([
        *specs, out, "--game-batch", "2", "--sims", "4", "--move-limit",
        "8", "--iterations", "3", "--save-every", "1", "--gate-games", "2",
        "--seed", "9", "--device", "cpu", *extra])


def final_state(out, step=3):
    return torch.load(os.path.join(out, "checkpoints", str(step),
                                   "state.pt"), weights_only=True)


def same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return all(same(x, y) for x, y in zip(a, b))
    return a == b


def test_sigterm_drain_resumes_to_the_undrained_run(tmp_path, specs,
                                                    monkeypatch):
    baseline = str(tmp_path / "baseline")
    cli(specs, baseline, "--actor-learner")
    drained = str(tmp_path / "drained")
    from rocalphago_tpu_torch.io.metrics import MetricsLogger

    real = MetricsLogger.log

    def preempting(self, event, **fields):
        real(self, event, **fields)
        if event == "iteration" and fields["iteration"] == 0:
            os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(MetricsLogger, "log", preempting)
    cli(specs, drained, "--actor-learner")
    monkeypatch.setattr(MetricsLogger, "log", real)
    with open(os.path.join(drained, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    phases = [e["phase"] for e in events if e["event"] == "drain"]
    assert phases == ["requested", "loop_exit", "checkpoint"]
    assert sorted(os.listdir(os.path.join(drained, "checkpoints"))) == ["1"]
    cli(specs, drained, "--actor-learner")
    assert same(final_state(drained), final_state(baseline))
    for name in ("policy.00003.flax.msgpack", "value.00003.flax.msgpack"):
        with open(os.path.join(drained, name), "rb") as f, \
                open(os.path.join(baseline, name), "rb") as g:
            assert f.read() == g.read()


def test_free_running_fleet_runs_to_the_end(tmp_path, specs):
    out = str(tmp_path / "free")
    final = cli(specs, out, "--actor-learner", "--actors", "2",
                "--replay-sample", "--replay-capacity", "2")
    assert final["iteration"] == 2 and np.isfinite(final["policy_loss"])
    with open(os.path.join(out, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    (setup,) = [e for e in events if e["event"] == "actor_learner"]
    assert setup["lockstep"] is False and setup["capacity"] == 2
    (done,) = [e for e in events if e["event"] == "actor_learner_done"]
    assert done["learner_steps"] == 3 and done["games_played"] >= 2
