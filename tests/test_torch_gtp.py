"""The port's GTP serving path against the reference's.

A scripted 9×9 session on the in-repo ``puct`` policy fixture goes
through the port (``device="cpu"``, float32) and through the
reference's ``run_gtp`` with its module cloned to float32: the
transcripts must be identical, every byte (the greedy player's argmax
over logits that agree to ~1e-6, see ``tests/test_torch_models.py``),
both for the raw engines (``resilient=False``, the CLI's
``--no-resilient``) and for the default engines, which serve every
genmove through the degradation ladder. Then one 19×19 genmove on a tiny
fresh net, the protocol's error replies, and the command line. The time
commands hand the player the same per-move budgets as the reference
engine's; the device-search player serves a session from the command
line on the CPU.
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.interface.gtp import GTPEngine as RefEngine
from rocalphago_tpu.interface.gtp import run_gtp as ref_run_gtp
from rocalphago_tpu.models import NeuralNetBase as RefNet
from rocalphago_tpu.search.players import GreedyPolicyPlayer as RefGreedy
from rocalphago_tpu_torch.interface import gtp
from rocalphago_tpu_torch.models import CNNPolicy, CNNValue, NeuralNetBase
from rocalphago_tpu_torch.search.players import (
    GreedyPolicyPlayer,
    ProbabilisticPolicyPlayer,
)
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(ROOT, "results/zero_r5/target_compare/puct/policy.json")

SCRIPT = "\n".join(
    ["protocol_version", "version", "known_command genmove",
     "boardsize 9", "clear_board", "komi 7",
     "play b C3", "play w D3", "play b D4", "play w E4", "play b C3",
     "play w E3", "play b E5"]
    + [f"genmove {c}" for c in "wb" * 8]
    + ["undo", "undo", "genmove w", "showboard", "final_score",
       "clear_board", "fixed_handicap 2", "genmove w", "genmove b",
       "frobnicate", "boardsize 13", "quit"]) + "\n"


def port_session(script, player, **engine_kwargs):
    out = io.StringIO()
    engine = gtp.run_gtp(player, io.StringIO(script), out, **engine_kwargs)
    return out.getvalue(), engine


def ref_transcript(script, resilient):
    ref = RefNet.load_model(SPEC)
    with jax.enable_checks(False):
        ref.module = ref.module.clone(dtype=jnp.float32)
        ref._apply = jax.jit(ref.module.apply)
        want = io.StringIO()
        ref_run_gtp(RefGreedy(ref), io.StringIO(script), want,
                    resilient=resilient)
    return want.getvalue()


def test_9x9_transcript_matches_reference():
    """The raw engines: no ladder on either side."""
    want = ref_transcript(SCRIPT, resilient=False)
    net = NeuralNetBase.load_model(SPEC, device="cpu", dtype=torch.float32)
    got, engine = port_session(SCRIPT, GreedyPolicyPlayer(net),
                               resilient=False)
    assert engine._serve is None
    assert got == want
    assert engine.illegal_from_player == 0
    replies = got.split("\n\n")
    assert "? illegal move" in replies and "? unacceptable size" in replies
    assert sum(r.startswith("= ") and len(r) <= 5 for r in replies) >= 16


def test_9x9_transcript_matches_reference_in_default_mode():
    """The default engines wrap the player in the degradation ladder;
    with a player that never fails, every genmove is served by the
    search rung and the transcript is the raw one, the reference's
    default transcript byte for byte."""
    script = SCRIPT.replace("quit\n", "rocalphago-health\nquit\n")
    want = ref_transcript(script, resilient=True)
    net = NeuralNetBase.load_model(SPEC, device="cpu", dtype=torch.float32)
    got, engine = port_session(script, GreedyPolicyPlayer(net))
    health = [r for r in got.split("\n\n") if r.startswith("= {")]
    want_health = [r for r in want.split("\n\n") if r.startswith("= {")]
    strip = [r for r in got.split("\n\n") if not r.startswith("= {")]
    assert strip == [r for r in want.split("\n\n")
                     if not r.startswith("= {")]
    got_h, want_h = json.loads(health[0][2:]), json.loads(want_health[0][2:])
    got_h.pop("latency_s"), want_h.pop("latency_s")
    assert got_h == want_h
    assert got_h["genmoves"] == 19 and got_h["last_rung"] == "search"
    assert engine._serve.served["search"] == 19


def test_19x19_genmove_on_a_fresh_net():
    net = CNNPolicy(board=19, layers=2, filters_per_layer=8, seed=1,
                    device="cpu")
    out, engine = port_session(
        "boardsize 19\nclear_board\ngenmove b\ngenmove w\nquit\n",
        GreedyPolicyPlayer(net))
    moves = [r[2:] for r in out.split("\n\n") if r.startswith("= ")]
    assert len(moves) == 2
    for v in moves:
        assert gtp.vertex_to_move(v, 19) is not None
    assert engine.illegal_from_player == 0
    assert engine.state.turns_played == 2


def test_protocol_replies():
    net = CNNPolicy(board=9, layers=2, filters_per_layer=4, device="cpu")
    engine = gtp.GTPEngine(GreedyPolicyPlayer(net))
    assert engine.handle("7 name") == ("=7 rocalphago-tpu-torch\n\n", False)
    assert engine.handle("list_commands")[0].count("\n") > 10
    assert engine.handle("known_command time_left")[0] == "= true\n\n"
    assert engine.handle("known_command kgs-genmove_cleanup")[0] == \
        "= false\n\n"
    assert engine.handle("undo")[0].startswith("? cannot undo")
    assert engine.handle("genmove x")[0].startswith("?")
    assert engine.handle("quit") == ("=\n\n", True)
    assert gtp.move_to_vertex((8, 0), 19) == "J1"
    assert gtp.vertex_to_move("pass", 9) is None


def test_probabilistic_player_is_seeded():
    net = NeuralNetBase.load_model(SPEC, device="cpu")
    script = "boardsize 9\n" + "genmove b\ngenmove w\n" * 3 + "quit\n"
    a, _ = port_session(script, ProbabilisticPolicyPlayer(
        net, temperature=0.5, seed=11))
    b, _ = port_session(script, ProbabilisticPolicyPlayer(
        net, temperature=0.5, seed=11))
    assert a == b and a.count("= ") >= 6


def test_command_line_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "boardsize 9\ngenmove b\nquit\n"))
    gtp.main(["--policy", SPEC, "--device", "cpu"])
    replies = capsys.readouterr().out.split("\n\n")
    assert replies[0] == "=" and replies[1].startswith("= ")
    assert gtp.vertex_to_move(replies[1][2:], 9) is not None


class BudgetRecorder:
    """A stub player that passes and records every move budget."""

    board = 9

    def __init__(self):
        self.budgets = []
        self.resets = 0

    def set_move_time(self, seconds):
        self.budgets.append(seconds)

    def get_move(self, state):
        return None

    def reset(self):
        self.resets += 1


TIME_SCRIPT = [
    "boardsize 9", "genmove b", "time_settings 300 30 5", "genmove b",
    "genmove w", "time_left b 100 0", "genmove b", "time_left w 20 3",
    "genmove w", "genmove w", "genmove w", "genmove w", "time_left b 0 0",
    "genmove b", "time_settings 0 10 2", "genmove b", "clear_board",
    "genmove w", "time_settings 1 0 0", "genmove b", "time_settings -1 0 0",
    "undo", "genmove b"]


def test_time_commands_give_the_reference_budgets():
    """The raw engines."""
    check_time_budgets(resilient=False)


def test_time_commands_give_the_reference_budgets_in_default_mode():
    """The default engines: a player that passes on a finished game
    bottoms out the ladder on both sides alike."""
    check_time_budgets(resilient=True)


def check_time_budgets(resilient):
    port, ref = BudgetRecorder(), BudgetRecorder()
    engine = gtp.GTPEngine(port, resilient=resilient)
    with jax.enable_checks(False):
        ref_engine = RefEngine(ref, resilient=resilient)
        for cmd in TIME_SCRIPT:
            got, want = engine.handle(cmd), ref_engine.handle(cmd)
            assert got[0].split()[0] == want[0].split()[0], (cmd, got, want)
    assert len(port.budgets) == len(ref.budgets) == 13
    assert port.budgets[0] is None and ref.budgets[0] is None
    # the engines' own spend is wall time, so the budgets agree to the
    # microseconds a stub genmove takes
    np.testing.assert_allclose(port.budgets[1:], ref.budgets[1:],
                               rtol=1e-3, atol=1e-3)
    assert port.budgets[4] == pytest.approx(20 / 3)   # 20 s / 3 stones
    assert port.budgets[9] == 5.0           # byo-yomi 10 s / 2 stones
    assert port.resets == 2                 # boardsize, clear_board


def test_device_mcts_player_on_the_command_line(tmp_path, monkeypatch,
                                                capsys):
    policy = str(tmp_path / "policy.json")
    value = str(tmp_path / "value.json")
    CNNPolicy(board=9, layers=2, filters_per_layer=4, seed=1,
              device="cpu").save_model(policy)
    CNNValue(board=9, layers=2, filters_per_layer=4, seed=2,
             device="cpu").save_model(value)
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "boardsize 9\ngenmove b\ngenmove w\ntime_settings 0 1 1\n"
        "genmove b\nquit\n"))
    gtp.main(["--player", "device-mcts", "--policy", policy, "--value",
              value, "--playouts", "8", "--device", "cpu"])
    replies = capsys.readouterr().out.split("\n\n")
    moves = [replies[i] for i in (1, 2, 4)]
    for r in moves:
        assert r.startswith("= ") and gtp.vertex_to_move(r[2:], 9)
    assert replies[3] == "="
    with pytest.raises(SystemExit, match="needs a value model"):
        gtp.main(["--player", "device-mcts", "--policy", policy,
                  "--device", "cpu"])
