"""Chaos tests of the port's trainers: kill at a fault barrier, resume,
and the run ends on the straight run's bits.

* The zero CLI in a subprocess that installs ``crash@<barrier>``
  (``faults.install``: the port reads no environment) and calls
  ``run_training``; ``crash`` is ``os._exit``, so no ``finally`` block
  runs and nothing is flushed but what was written. After the crash no
  temp file is left outside the checkpoints and a half-written pool
  pair is not listed; the resumed run's final stats, exports and pool
  are the straight run's byte for byte. Tier-1 runs a crash after the
  first checkpoint and one between the files of a promoted pair; the
  whole list of the reference's ``tests/test_chaos.py`` runs under
  ``-m slow``.
* In process, ``kill`` (``InjectedKill``) at ``sl.step_save`` and at
  ``rl.post_iteration``: the resumed trainers end on the straight
  runs' params, checkpoints and exports.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rocalphago_tpu_torch.models import CNNPolicy, CNNValue
from rocalphago_tpu_torch.runtime import faults
from rocalphago_tpu_torch.runtime.faults import FAULT_EXIT_CODE
from rocalphago_tpu_torch.training import rl, sl
from rocalphago_tpu_torch.training.zero import ZeroGate
from torch_port_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 5
#: the reference's chaos configuration: 2 iterations, a checkpoint and a
#: gate every iteration, tiny 5x5 search self-play
ARGS = ["--game-batch", "2", "--iterations", "2", "--move-limit", "8",
        "--sims", "2", "--sim-chunk", "2", "--replay-chunk", "4",
        "--save-every", "1", "--gate-games", "2", "--num-devices", "1",
        "--seed", "3", "--device", "cpu"]
#: every barrier of the zero loop, as the reference's sweep lists them
ZERO_BARRIERS = [
    "crash@iter0.zero.post_save",
    "crash@iter0.zero.pre_iteration",
    "crash@iter0.zero.post_iteration",
    "crash@iter0.zero.post_gate",
    "crash@iter0.zero.post_export",
    "crash@iter0.zero.pre_save",
    "crash@zero.promote",            # the first promotion
    "crash@zero.promote:2",          # between the files of a pair
    "crash@iter1.zero.post_iteration",
]
TIER1 = ("crash@iter0.zero.post_save", "crash@zero.promote:2")

#: the subprocess: install the plan, then the CLI (one torch thread)
RUNNER = ("import sys, torch; torch.set_num_threads(1); "
          "from rocalphago_tpu_torch.runtime import faults; "
          "faults.install(sys.argv[1]); "
          "from rocalphago_tpu_torch.training.zero import run_training; "
          "run_training(sys.argv[2:])")


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    d = tmp_path_factory.mktemp("chaos_specs")
    pj, vj = str(d / "p.json"), str(d / "v.json")
    CNNPolicy(("board", "ones"), board=SIZE, layers=1, filters_per_layer=2,
              device="cpu").save_model(pj)
    CNNValue(("board", "ones", "color"), board=SIZE, layers=1,
             filters_per_layer=2, device="cpu").save_model(vj)
    return pj, vj


def run_zero(specs, out_dir, plan=""):
    return subprocess.run(
        [sys.executable, "-c", RUNNER, plan, *specs, str(out_dir), *ARGS],
        cwd=ROOT, capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def baseline(specs, tmp_path_factory):
    out = tmp_path_factory.mktemp("chaos") / "baseline"
    proc = run_zero(specs, out)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return out


def final_stats(out_dir) -> dict:
    """The last record per iteration, wall-time fields dropped."""
    rows = {}
    with open(os.path.join(str(out_dir), "metrics.jsonl")) as f:
        for r in map(json.loads, f):
            if r["event"] == "iteration":
                rows[r["iteration"]] = {k: v for k, v in r.items()
                                        if k not in ("time", "games_per_min")}
    return rows


def assert_no_torn_artifacts(out_dir) -> None:
    out_dir = str(out_dir)
    for root, _, names in os.walk(out_dir):
        if "checkpoints" in os.path.relpath(root, out_dir).split(os.sep):
            continue             # the checkpointer's own temp directories
        for name in names:
            path = os.path.join(root, name)
            assert ".tmp" not in name, f"torn write: {path}"
            if name.endswith(".json"):
                with open(path) as f:
                    json.load(f)
            if name.endswith(".policy.msgpack") and not os.path.exists(
                    path.replace(".policy.", ".value.")):
                listed = [p for _, p, _ in ZeroGate.snapshots(
                    type("G", (), {"pool_dir": root}))]
                assert path not in listed, f"half pair {path} listed"


def file_bytes(out_dir, sub="") -> dict:
    d = os.path.join(str(out_dir), sub)
    out = {}
    for name in sorted(os.listdir(d)):
        if name.endswith((".msgpack", ".json")) and name != "metadata.json":
            with open(os.path.join(d, name), "rb") as f:
                out[name] = f.read()
    return out


def assert_same_run(baseline_dir, resumed_dir) -> None:
    assert final_stats(resumed_dir) == final_stats(baseline_dir)
    for sub in ("", "pool"):
        assert file_bytes(resumed_dir, sub) == file_bytes(baseline_dir, sub)


def crash_and_resume(specs, out_dir, plan) -> None:
    proc = run_zero(specs, out_dir, plan)
    assert proc.returncode == FAULT_EXIT_CODE, (
        f"{plan}: rc {proc.returncode}\n{proc.stderr[-2000:]}")
    assert_no_torn_artifacts(out_dir)
    proc = run_zero(specs, out_dir)
    assert proc.returncode == 0, (
        f"{plan}: resume rc {proc.returncode}\n{proc.stderr[-2000:]}")


def _plan_id(plan):
    return plan.split("@")[1].replace(":", "_")


@pytest.mark.parametrize("plan", TIER1, ids=_plan_id)
def test_zero_crash_and_resume_is_the_straight_run(specs, baseline,
                                                   tmp_path, plan):
    out = tmp_path / "crashed"
    crash_and_resume(specs, out, plan)
    assert_same_run(baseline, out)
    with open(out / "metrics.jsonl") as f:
        events = [json.loads(line)["event"] for line in f]
    # a resume from the committed checkpoint, or (crashed before the
    # first one) a fresh start that rewrites the same bytes
    assert ("resume" in events) == (plan == TIER1[0])


@pytest.mark.slow
@pytest.mark.parametrize("plan", [p for p in ZERO_BARRIERS
                                  if p not in TIER1], ids=_plan_id)
def test_every_zero_barrier(specs, baseline, tmp_path, plan):
    out = tmp_path / "crashed"
    crash_and_resume(specs, out, plan)
    assert_same_run(baseline, out)


# ------------------------------------------------------------ in process

B = 7


def write_corpus(prefix: str, n: int = 96) -> None:
    rng = np.random.default_rng(0)
    states = rng.integers(0, 2, (n, B, B, 4)).astype(np.uint8)
    actions = (states[:, :, :, 0].sum((1, 2)) % (B * B)).astype(np.int32)
    np.savez(f"{prefix}-00000.npz", states=states, actions=actions)
    with open(f"{prefix}-manifest.json", "w") as f:
        json.dump({"board_size": B, "planes": 4, "shard_counts": [n],
                   "features": ["board", "ones"]}, f)


def killed_then_resumed(plan, run, out) -> None:
    faults.install(plan)
    try:
        with pytest.raises(faults.InjectedKill):
            run(out)
    finally:
        faults.install(None)
    run(out)


def state_of(out, step) -> dict:
    return torch.load(os.path.join(str(out), "checkpoints", str(step),
                                   "state.pt"), weights_only=True)


def same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.usefixtures("one_torch_thread")
def test_sl_killed_at_a_step_save_resumes_to_the_straight_run(tmp_path):
    prefix = str(tmp_path / "corpus")
    write_corpus(prefix)

    def run(out):
        cfg = sl.SLConfig(
            train_data=prefix, out_dir=str(out), minibatch=16, epochs=2,
            epoch_length=4, save_every=2, learning_rate=0.05,
            train_val_test=(0.8, 0.1, 0.1), seed=1,
            max_validation_batches=1, device="cpu")
        return sl.SLTrainer(cfg, net=CNNPolicy(
            ("board", "ones"), board=B, layers=2, filters_per_layer=4,
            device="cpu")).run()

    run(tmp_path / "straight")
    killed_then_resumed("kill@sl.step_save", run, tmp_path / "killed")
    assert same(state_of(tmp_path / "killed", 8),
                state_of(tmp_path / "straight", 8))
    assert file_bytes(tmp_path / "killed") == file_bytes(
        tmp_path / "straight")


@pytest.mark.usefixtures("one_torch_thread")
def test_rl_killed_after_an_iteration_resumes_to_the_straight_run(tmp_path):
    spec = str(tmp_path / "policy.json")
    CNNPolicy(("board", "ones"), board=SIZE, layers=2, filters_per_layer=4,
              device="cpu").save_model(spec)

    def run(out):
        return rl.run_training([spec, str(out), "--game-batch", "2",
                                "--iterations", "3", "--save-every", "1",
                                "--move-limit", "6", "--seed", "5",
                                "--learning-rate", "0.05", "--device",
                                "cpu"])

    run(tmp_path / "straight")
    # the second iteration is over, its checkpoint not yet written
    killed_then_resumed("kill@rl.post_iteration:2", run, tmp_path / "killed")
    assert same(state_of(tmp_path / "killed", 3),
                state_of(tmp_path / "straight", 3))
    for sub in ("", "opponents"):
        assert file_bytes(tmp_path / "killed", sub) == file_bytes(
            tmp_path / "straight", sub)
