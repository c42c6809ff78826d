"""The port's progressive-size curriculum
(``rocalphago_tpu_torch/training/curriculum.py``) on the CPU:
``parse_stages`` against the reference's on good and bad stage lists,
and a two-stage 5×5 → 7×7 run of the zero loop whose stage exports
load in the port (at the next stage's board) and in the reference,
with the transfer match played and Wilson-gated, and its spans in the
right streams.
"""

import json
import os

import numpy as np
import pytest
import torch

from rocalphago_tpu.models import NeuralNetBase as RefNet
from rocalphago_tpu.training import curriculum as ref_curriculum
from rocalphago_tpu_torch.models import CNNPolicy, CNNValue, NeuralNetBase
from rocalphago_tpu_torch.training import curriculum
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FEATS = ("board", "ones")


@pytest.mark.parametrize("spec", ["9:30,13:20,19:10", " 5 : 1 ", "7:2,7:3"])
def test_parse_stages_is_the_references(spec):
    assert curriculum.parse_stages(spec) == ref_curriculum.parse_stages(spec)


@pytest.mark.parametrize("spec", ["", "9", "9:0", "1:3", "9:3,x:2",
                                  "9:3;13:2"])
def test_parse_stages_refuses_what_the_reference_refuses(spec):
    with pytest.raises(ValueError) as mine:
        curriculum.parse_stages(spec)
    with pytest.raises(ValueError) as ref:
        ref_curriculum.parse_stages(spec)
    assert str(mine.value) == str(ref.value)


def test_two_stage_run_produces_loadable_exports(tmp_path):
    pol, val = str(tmp_path / "p.json"), str(tmp_path / "v.json")
    CNNPolicy(FEATS, board=5, layers=2, filters_per_layer=8, seed=1,
              device="cpu").save_model(pol)
    CNNValue(FEATS + ("color",), board=5, layers=2, filters_per_layer=8,
             seed=2, device="cpu").save_model(val)
    out = str(tmp_path / "cur")
    summary = curriculum.run_curriculum([
        pol, val, out, "--stages", "5:1,7:1", "--transfer-games", "2",
        "--transfer-move-limit", "10", "--device", "cpu",
        "--game-batch", "2", "--sims", "4", "--move-limit", "8",
        "--save-every", "1", "--gate-games", "2"])
    assert [s["board"] for s in summary["stages"]] == [5, 7]
    assert all(np.isfinite(s["policy_loss"]) for s in summary["stages"])
    tr = summary["transfer"]
    assert tr["board"] == 7 and tr["wins_a"] + tr["wins_b"] + \
        tr["draws"] == 2 and isinstance(tr["transfer"], bool)
    with open(os.path.join(out, "curriculum.json")) as f:
        assert json.load(f) == summary
    with open(os.path.join(out, "stage01_b7", "metadata.json")) as f:
        assert json.load(f)["config"]["seed"] == 1     # base seed + 1
    # the stage spans land in the curriculum's stream (each stage's run
    # points the sink at its own), the zero spans in the stage's
    spans = {}
    for run in ("", "stage00_b5", "stage01_b7"):
        with open(os.path.join(out, run, "metrics.jsonl")) as f:
            spans[run] = [r for r in map(json.loads, f)
                          if r["event"] == "span"]
    assert [(r["path"], r.get("board")) for r in spans[""]] == [
        ("curriculum.stage", 5), ("curriculum.stage", 7),
        ("curriculum.transfer", 7)]
    for run in ("stage00_b5", "stage01_b7"):
        assert "curriculum.stage/zero.iteration/zero.selfplay" in {
            r["path"] for r in spans[run]}
    first = NeuralNetBase.load_model(
        os.path.join(out, "stage00_b5", "policy.json"), device="cpu")
    second_in = NeuralNetBase.load_model(
        os.path.join(out, "stage01_b7", "init", "policy.json"),
        device="cpu")
    assert first.board == 5 and second_in.board == 7
    assert all(torch.equal(first.module.state_dict()[k],
                           second_in.module.state_dict()[k])
               for k in first.module.state_dict())
    for name in ("policy", "value"):
        path = summary[f"final_{name}"]
        net = NeuralNetBase.load_model(path, device="cpu")
        assert net.board == 7
        ref = RefNet.load_model(path)
        assert ref.board == 7
