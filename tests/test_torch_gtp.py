"""The port's GTP serving path against the reference's.

A scripted 9×9 session on the in-repo ``puct`` policy fixture goes
through the port (``device="cpu"``, float32) and through the
reference's ``run_gtp(..., resilient=False)`` with its module cloned to
float32: the transcripts must be identical, every byte (the greedy
player's argmax over logits that agree to ~1e-6, see
``tests/test_torch_models.py``). Then one 19×19 genmove on a tiny
fresh net, the protocol's error replies, and the command line.
"""

import io
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from rocalphago_tpu.interface.gtp import run_gtp as ref_run_gtp
from rocalphago_tpu.models import NeuralNetBase as RefNet
from rocalphago_tpu.search.players import GreedyPolicyPlayer as RefGreedy
from rocalphago_tpu_torch.interface import gtp
from rocalphago_tpu_torch.models import CNNPolicy, NeuralNetBase
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


def port_session(script, player):
    out = io.StringIO()
    engine = gtp.run_gtp(player, io.StringIO(script), out)
    return out.getvalue(), engine


def test_9x9_transcript_matches_reference():
    ref = RefNet.load_model(SPEC)
    with jax.enable_checks(False):
        ref.module = ref.module.clone(dtype=jnp.float32)
        ref._apply = jax.jit(ref.module.apply)
        want = io.StringIO()
        ref_run_gtp(RefGreedy(ref), io.StringIO(SCRIPT), want,
                    resilient=False)
    net = NeuralNetBase.load_model(SPEC, device="cpu", dtype=torch.float32)
    got, engine = port_session(SCRIPT, GreedyPolicyPlayer(net))
    assert got == want.getvalue()
    assert engine.illegal_from_player == 0
    replies = got.split("\n\n")
    assert "? illegal move" in replies and "? unacceptable size" in replies
    assert sum(r.startswith("= ") and len(r) <= 5 for r in replies) >= 16


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
    assert engine.handle("known_command time_left")[0] == "= false\n\n"
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
