"""The port's Elo tools (``rocalphago_tpu_torch/interface/elo.py``)
against the reference's: the same numbers exactly, on the committed
tournament logs of ``results/elo_demo/`` and on synthetic logs (draws,
a disconnected component, an undefeated player), and the same CLI
output byte for byte."""

import glob
import json
import os

import pytest

from rocalphago_tpu.interface import elo as ref_elo
from rocalphago_tpu_torch.interface import elo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = sorted(glob.glob(os.path.join(ROOT, "results", "elo_demo",
                                     "*.jsonl")))


def g(black, white, winner):
    return {"game": 0, "black": black, "white": white, "winner": winner}


SYNTHETIC = {
    "ordered": ([g("A", "B", "A")] * 7 + [g("B", "A", "B")] * 3
                + [g("B", "C", "B")] * 7 + [g("C", "B", "C")] * 3),
    "draws": [g("A", "B", "draw")] * 10 + [g("B", "C", "C")] * 2,
    "disconnected": [g("A", "B", "A")] * 4 + [g("X", "Y", "X")] * 4,
    "undefeated": [g("A", "B", "A")] * 5,
    "empty": [],
}


def demo_games():
    games = elo.read_games(DEMO)
    assert games == ref_elo.read_games(DEMO)
    assert len(DEMO) == 3 and len(games) > 0
    return games


@pytest.mark.parametrize("anchor", [None, "greedy", "mcts"])
def test_demo_logs_rate_as_the_reference(anchor):
    games = demo_games()
    assert elo.elo_table(games, anchor, 1000.0) == ref_elo.elo_table(
        games, anchor, 1000.0)
    assert (elo.bootstrap_ci(games, anchor, n_boot=50)
            == ref_elo.bootstrap_ci(games, anchor, n_boot=50))


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_logs_rate_as_the_reference(name):
    games = SYNTHETIC[name]
    wins, players = elo.pair_counts(games)
    rwins, rplayers = ref_elo.pair_counts(games)
    assert players == rplayers
    assert {a: dict(b) for a, b in wins.items()} == \
        {a: dict(b) for a, b in rwins.items()}
    assert elo.bradley_terry(players, wins) == ref_elo.bradley_terry(
        rplayers, rwins)
    assert elo.elo_table(games) == ref_elo.elo_table(games)
    assert elo.bootstrap_ci(games, n_boot=20, seed=3) == \
        ref_elo.bootstrap_ci(games, n_boot=20, seed=3)
    table = elo.elo_table(games)["players"]
    if name == "disconnected":
        assert table["X"]["elo"] is None and table["A"]["elo"] == 0.0
    if name == "undefeated":
        assert -2000 < table["B"]["elo"] < 0     # regularized, finite


def test_wilson_lower_bound_is_the_references():
    for n in range(-1, 70):
        for wins in (0, 0.5, n / 3, n / 2, n - 0.5, n):
            for z in (1.0, 1.96, 2.58):
                assert elo.wilson_lower_bound(wins, n, z) == \
                    ref_elo.wilson_lower_bound(wins, n, z)


def test_anchor_typo_is_refused():
    with pytest.raises(ValueError, match="appears in no game"):
        elo.elo_table(SYNTHETIC["ordered"], anchor="Z")


@pytest.mark.parametrize("extra", [[], ["--anchor", "greedy",
                                        "--anchor-elo", "1000"],
                                   ["--bootstrap", "30"]])
def test_cli_prints_the_references_output(extra, tmp_path, capsys):
    assert elo.main(DEMO + extra) == 0
    got = capsys.readouterr().out
    assert ref_elo.main(DEMO + extra) == 0
    assert got == capsys.readouterr().out
    table = json.loads(got)
    assert all(row["elo"] is not None for row in table["players"].values())
    log = tmp_path / "t.jsonl"
    log.write_text(json.dumps(g("a", "b", "a")) + "\n{not json\n")
    with pytest.raises(SystemExit, match="appears in no game"):
        elo.main([str(log), "--anchor", "nobody"])
