"""A run's last line: the contract's keys only, with the compared
numbers last; and without a CUDA card the command exits non-zero and
prints no result."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: small sizes a CPU test can hold, per cell
SMALL = {
    "policy192.sl-train": {
        "params": {"minibatch": 16, "positions": 256,
                   "shard_positions": 64, "warmup_steps": 1},
        "config": {"policy": {"layers": 3, "filters_per_layer": 16}}},
}

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(cell, trace):
    torch.manual_seed(0)
    result, checks = harness.execute(
        cell, 2**31 + 12345, 1.0, trace, torch.device("cpu"),
        overrides=SMALL[cell], log=lambda *_: None)
    line = json.loads(json.dumps(result))
    assert set(line) - {"breakdown"} == KEYS
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    which = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in harness.cell_metrics(bench, cell, which)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {c.name for c in checks} == set(line["checks"])


def test_no_card_exits_without_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "policy192.sl-train", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, HOME=str(tmp_path)))
    assert out.returncode != 0
    assert "{" not in out.stdout
