"""The port's tournament (``rocalphago_tpu_torch/interface/
tournament.py``) and the re-boarding it needs (``NeuralNetBase.
at_board``), against the reference's, on the CPU.

A tournament of greedy players on the committed 9×9 policies, float32
in both packages, writes the reference's log lines and tally, byte for
byte. The reference's own tournament tests (``tests/test_tournament.py``)
run again on the port's players, and a short ``gumbel-mcts`` against
``device-mcts`` match runs through the CLI.
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from rocalphago_tpu.interface import tournament as ref_tournament
from rocalphago_tpu.models.nn_util import NeuralNetBase as RefNet
from rocalphago_tpu.search.players import GreedyPolicyPlayer as RefGreedy
from rocalphago_tpu_torch.engine import pygo
from rocalphago_tpu_torch.interface import tournament
from rocalphago_tpu_torch.interface.tournament import (
    GameCrash,
    play_match,
    run_tournament,
)
from rocalphago_tpu_torch.models import CNNPolicy, CNNValue, NeuralNetBase
from rocalphago_tpu_torch.search.players import (
    GreedyPolicyPlayer,
    ProbabilisticPolicyPlayer,
    build_player,
)
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = os.path.join(ROOT, "results", "zero_r5", "target_compare")
SIZE = 5


def committed(kind, what):
    return os.path.join(NETS, kind, f"{what}.json")


def test_greedy_tournament_is_the_references():
    """Greedy players on the committed 9×9 gumbel and puct policies,
    float32: the same log lines and tally as the reference's."""
    kw = dict(games=4, size=9, komi=7.0, move_limit=60, names=("g", "p"))
    refs = []
    with jax.enable_checks(False):
        for kind in ("gumbel", "puct"):
            net = RefNet.load_model(committed(kind, "policy"))
            net.module = net.module.clone(dtype=jnp.float32)
            net._apply = jax.jit(net.module.apply)
            refs.append(RefGreedy(net))
        want_log = io.StringIO()
        want = ref_tournament.run_tournament(*refs, log=want_log, **kw)
    ports = [GreedyPolicyPlayer(NeuralNetBase.load_model(
        committed(kind, "policy"), device="cpu", dtype=torch.float32))
        for kind in ("gumbel", "puct")]
    got_log = io.StringIO()
    got = run_tournament(*ports, log=got_log, **kw)
    assert got == want
    assert got_log.getvalue() == want_log.getvalue()
    assert len(got_log.getvalue().splitlines()) == 4


def make_players():
    policy = CNNPolicy(("board", "ones"), board=SIZE, layers=2,
                       filters_per_layer=4, device="cpu")
    return (GreedyPolicyPlayer(policy, move_limit=30),
            ProbabilisticPolicyPlayer(policy, temperature=1.0, seed=0,
                                      move_limit=30))


def test_play_match_completes():
    a, b = make_players()
    assert play_match(a, b, size=SIZE, komi=5.5, move_limit=40) in (-1, 0, 1)


def test_run_tournament_alternates_colors_and_tallies():
    a, b = make_players()
    log = io.StringIO()
    tally = run_tournament(a, b, games=4, size=SIZE, komi=5.5,
                           move_limit=40, log=log)
    assert tally["games"] == 4
    assert sum(tally["wins"].values()) == 4
    entries = [json.loads(line) for line in
               log.getvalue().strip().splitlines()]
    assert [e["black"] for e in entries] == ["A", "B", "A", "B"]
    decided = tally["wins"]["A"] + tally["wins"]["B"]
    if decided:
        assert tally["win_rate_a"] + tally["win_rate_b"] == \
            pytest.approx(1.0)


@pytest.mark.parametrize("names", [("X", "X"), ("draw", "B")])
def test_run_tournament_rejects_bad_names(names):
    a, b = make_players()
    with pytest.raises(ValueError, match="names"):
        run_tournament(a, b, games=1, size=SIZE, names=names)


def test_play_match_handicap_opening():
    """The star-point stones are down before play and White moves
    first."""
    policy = CNNPolicy(("board", "ones"), board=7, layers=2,
                       filters_per_layer=4, device="cpu")
    seen = []

    class Watching(ProbabilisticPolicyPlayer):
        def get_move(self, state):
            if not seen:
                seen.append((int((state.board == pygo.BLACK).sum()),
                             state.current_player))
            return super().get_move(state)

    a = Watching(policy, temperature=1.0, seed=0, move_limit=20)
    b = Watching(policy, temperature=1.0, seed=1, move_limit=20)
    assert play_match(a, b, size=7, komi=7.0, move_limit=30,
                      handicap=2) in (-1, 0, 1)
    assert seen == [(2, pygo.WHITE)]
    tally = run_tournament(a, b, games=2, size=7, komi=7.0,
                           move_limit=30, handicap=2)
    assert tally["games"] == 2


def test_fcn_nets_reboard_and_size_locked_ones_are_refused(tmp_path):
    """A spec saved at one size plays at another through ``--board``:
    FCN nets re-board through ``at_board``, sharing their module;
    size-locked heads are refused up front, and so is an ``mcts`` spec
    without its value net."""
    policy = CNNPolicy(("board", "ones"), board=5, layers=2,
                       filters_per_layer=4, device="cpu")
    value = CNNValue(("board", "ones", "color"), board=5, layers=2,
                     filters_per_layer=4, device="cpu")
    for net in (policy, value):
        moved = net.at_board(7)
        assert moved.board == 7 and moved.module is net.module
        assert moved.preprocess.cfg.size == 7
        assert net.at_board(5) is net
    planes = torch.zeros((1, 7, 7, policy.preprocess.output_dim))
    assert policy.at_board(7).forward(planes).shape == (1, 49)
    spec = str(tmp_path / "p5.json")
    policy.save_model(spec)
    r = tournament.main([
        f"probabilistic:{spec}", f"probabilistic:{spec}", "--games", "2",
        "--board", "7", "--temperature", "1.0", "--move-limit", "20",
        "--device", "cpu"])
    assert r["games"] == 2
    legacy = CNNPolicy(("board", "ones"), board=5, layers=2,
                       filters_per_layer=4, head="bias", device="cpu")
    locked = str(tmp_path / "locked.json")
    legacy.save_model(locked)
    with pytest.raises(SystemExit, match="size-locked"):
        tournament.main([f"probabilistic:{locked}", f"probabilistic:{spec}",
                         "--games", "1", "--board", "7", "--device", "cpu"])
    dense = CNNValue(("board", "ones", "color"), board=5, layers=2,
                     filters_per_layer=4, head="dense", device="cpu")
    with pytest.raises(ValueError, match="size-locked"):
        dense.at_board(7)
    with pytest.raises(SystemExit, match="needs a value model"):
        tournament.main([f"mcts:{spec}", f"greedy:{spec}", "--games", "1",
                         "--board", "5", "--device", "cpu"])
    with pytest.raises(ValueError, match="needs a value model"):
        build_player("mcts", spec, device="cpu")


class CrashingPlayer:
    """Raises after ``good_moves`` successful first-sensible moves."""

    def __init__(self, good_moves=0):
        self.good_moves = good_moves
        self.calls = 0

    def get_move(self, state):
        self.calls += 1
        if self.calls > self.good_moves:
            raise RuntimeError("kaboom")
        moves = state.get_legal_moves(include_eyes=False)
        return moves[0] if moves else None


class StuckPlayer:
    """Always answers the same point: occupied, so illegal, the second
    time."""

    def get_move(self, state):
        return (0, 0)


def test_play_match_raises_game_crash_naming_side():
    _, good = make_players()
    with pytest.raises(GameCrash) as ei:
        play_match(CrashingPlayer(), good, size=SIZE, move_limit=40)
    assert ei.value.color == pygo.BLACK
    assert isinstance(ei.value.cause, RuntimeError)
    with pytest.raises(GameCrash) as ei:
        play_match(good, CrashingPlayer(), size=SIZE, move_limit=40)
    assert ei.value.color == pygo.WHITE


def test_play_match_rejected_move_is_a_crash():
    _, good = make_players()
    with pytest.raises(GameCrash) as ei:
        play_match(StuckPlayer(), good, size=SIZE, move_limit=40)
    assert ei.value.color == pygo.BLACK
    assert isinstance(ei.value.cause, pygo.IllegalMove)


def test_run_tournament_isolates_crashing_games():
    """A crashing game is a forfeit for the crashing side, and the
    tournament plays on, colours still alternating."""
    _, good = make_players()
    log = io.StringIO()
    tally = run_tournament(CrashingPlayer(good_moves=1), good,
                           games=4, size=SIZE, komi=5.5,
                           move_limit=40, log=log)
    assert tally["games"] == 4
    assert tally["wins"]["B"] == 4
    assert tally["forfeits"] == {"A": 4, "B": 0}
    assert tally["win_rate_b"] == 1.0
    entries = [json.loads(line) for line in
               log.getvalue().strip().splitlines()]
    assert len(entries) == 4
    for e in entries:
        assert e["winner"] == "B"
        assert "RuntimeError" in e["forfeit"]["error"]
    assert [e["forfeit"]["side"] for e in entries] == \
        ["black", "white", "black", "white"]


def test_gumbel_against_puct_through_the_cli(tmp_path):
    """``gumbel-mcts`` against ``device-mcts`` on the committed 9×9
    gumbel nets, 2 short games through ``main`` on the CPU: every game
    decided or drawn, none forfeited, one log line each."""
    spec = f"{committed('gumbel', 'policy')}:{committed('gumbel', 'value')}"
    log = str(tmp_path / "games.jsonl")
    tally = tournament.main([
        f"gumbel-mcts:{spec}", f"device-mcts:{spec}", "--games", "2",
        "--board", "9", "--playouts", "4", "--move-limit", "8", "--log",
        log, "--device", "cpu"])
    assert sum(tally["wins"].values()) == 2
    assert tally["forfeits"] == {"A": 0, "B": 0}
    with open(log) as f:
        entries = [json.loads(line) for line in f]
    assert [e["black"] for e in entries] == ["A", "B"]
    assert all("forfeit" not in e for e in entries)
