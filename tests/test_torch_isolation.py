"""The PyTorch port stands alone.

``rocalphago_tpu_torch`` and ``chip_smoke.py`` import neither JAX nor
Flax nor anything of the reference package ``rocalphago_tpu`` (matched
as a whole dotted name, since the port's own name starts with it), and
read no ``ROCALPHAGO_*`` environment knob. Its entry points run on the
CUDA card unless the caller asks for the CPU, and raise -- never fall
back -- when no card is there.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from rocalphago_tpu_torch import resolve_device
from rocalphago_tpu_torch.features import Preprocess
from rocalphago_tpu_torch.engine import pygo, torchgo
from rocalphago_tpu_torch.interface import elo, gtp, selfplay_cli, tournament
from rocalphago_tpu_torch.models import (
    CNNPolicy,
    CNNRollout,
    CNNValue,
    NeuralNetBase,
    specs,
)
from rocalphago_tpu_torch.ops import chase, labels, tree
from rocalphago_tpu_torch.search import mcts, selfplay
from rocalphago_tpu_torch.search.players import build_player
from rocalphago_tpu_torch.search.device_mcts import make_mcts_selfplay
from rocalphago_tpu_torch.data import convert, replay
from rocalphago_tpu_torch.runtime import supervisor, watchdog
from rocalphago_tpu_torch.training import (
    actor,
    curriculum,
    evaluate,
    learner,
    rl,
    selfplay_data,
    sl,
    value,
    zero,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "rocalphago_tpu_torch")
SPEC = os.path.join(ROOT, "results/zero_r5/target_compare/puct/policy.json")
VALUE_SPEC = os.path.join(ROOT,
                          "results/zero_r5/target_compare/puct/value.json")
FORBIDDEN = ("jax", "jaxlib", "flax", "rocalphago_tpu")


def forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def port_modules():
    mods = []
    for path in port_sources():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    return mods


def test_importing_the_port_loads_no_jax_or_reference():
    code = ("import importlib, json, sys\n"
            f"for m in {port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert "rocalphago_tpu_torch.interface.gtp" in loaded
    assert "chip_smoke" in loaded
    assert [m for m in loaded if forbidden(m)] == []


def test_sources_name_no_jax_reference_or_knob():
    for path in port_sources():
        with open(path, encoding="utf-8") as f:
            src = f.read()
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(forbidden(n) for n in names), (path, names)
        assert "ROCALPHAGO_" not in src, path


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Preprocess()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CNNPolicy(board=5, layers=2, filters_per_layer=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NeuralNetBase.load_model(SPEC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gtp.main(["--policy", SPEC])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CNNValue(board=5, layers=2, filters_per_layer=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gtp.main(["--player", "device-mcts", "--policy", SPEC, "--value",
                  VALUE_SPEC])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Preprocess(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        selfplay_cli.main(["--policy", SPEC, "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        selfplay_cli.main(["--policy", SPEC, "--out", str(tmp_path),
                           "--search-sims", "4", "--value", VALUE_SPEC])
    cfg = torchgo.GoConfig(size=5)
    for make in (selfplay.make_selfplay, selfplay.make_selfplay_chunked):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(cfg, ("board",), None, None, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        selfplay.play_games(cfg, ("board",), None, None, None, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mcts_selfplay(cfg, ("board",), ("board", "color"), None, None,
                           batch=2, max_moves=2, n_sim=2)
    assert not os.listdir(tmp_path)


def test_training_entry_points_need_a_card_or_an_explicit_cpu(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    games = os.path.join(ROOT, "tests", "test_data")
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.GameConverter(board_size=9)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.run_game_converter(["--directory", games, "--outfile",
                                    out, "--size", "9"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sl.run_training([SPEC, out, out])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sl.SLTrainer(sl.SLConfig(model_json=SPEC, train_data=out,
                                 out_dir=out))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        value.run_training([VALUE_SPEC, out, out])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main([SPEC, out])
    assert not os.listdir(tmp_path)
    # the same entry points run when the CPU is named
    res = convert.run_game_converter(
        ["--directory", games, "--outfile", out + "/c", "--size", "9",
         "--device", "cpu"])
    assert res["num_games"] == 5


def test_reinforcement_entry_points_need_a_card_or_an_explicit_cpu(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rl.run_training([SPEC, out])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rl.RLTrainer(rl.RLConfig(model_json=SPEC, out_dir=out))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        selfplay_data.run_generator([SPEC, SPEC, out, "--n-positions", "1"])
    cfg = torchgo.GoConfig(size=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rl.make_rl_iteration(cfg, ("board",), None, None, 2, 2, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        selfplay_data.play_value_games(cfg, ("board",), None, None, None, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        selfplay_data.make_value_games_chunked(cfg, ("board",), None, None, 2)
    assert not os.listdir(tmp_path)
    # the same entry points run when the CPU is named
    res = rl.run_training([SPEC, out, "--game-batch", "2", "--iterations",
                           "1", "--move-limit", "2", "--device", "cpu"])
    assert res["iteration"] == 0
    manifest = selfplay_data.run_generator(
        [SPEC, os.path.join(out, "model.json"), out + "/v",
         "--n-positions", "1", "--batch", "2", "--max-moves", "6",
         "--device", "cpu"])
    assert manifest["num_positions"] >= 1


def test_gumbel_and_evaluation_entry_points_need_a_card_or_an_explicit_cpu(
        monkeypatch, tmp_path, capsys):
    """The Gumbel player, its GTP and self-play modes and the tournament
    CLI raise with no card unless the CPU is named; Elo reads logs and
    touches no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_player("gumbel-mcts", SPEC, VALUE_SPEC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gtp.main(["--player", "gumbel-mcts", "--policy", SPEC, "--value",
                  VALUE_SPEC])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        selfplay_cli.main(["--policy", SPEC, "--out", str(tmp_path),
                           "--search-sims", "4", "--value", VALUE_SPEC,
                           "--gumbel"])
    log = str(tmp_path / "games.jsonl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tournament.main([f"greedy:{SPEC}", f"gumbel-mcts:{SPEC}:{VALUE_SPEC}",
                         "--board", "9", "--log", log])
    assert not os.listdir(tmp_path)
    tally = tournament.main([f"greedy:{SPEC}", f"greedy:{SPEC}", "--board",
                             "9", "--games", "2", "--move-limit", "4",
                             "--log", log, "--device", "cpu"])
    assert sum(tally["wins"].values()) == 2
    capsys.readouterr()
    assert elo.main([log]) == 0
    table = json.loads(capsys.readouterr().out)
    assert set(table["players"]) == {"A", "B"}


def test_mcts_player_and_spec_cli_need_a_card_or_an_explicit_cpu(
        monkeypatch, tmp_path, capsys):
    """The host APV-MCTS player, its GTP and tournament modes, the
    rollout net, the device rollout and the spec CLI raise with no card
    unless the CPU is named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "rollout.json")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        specs.main(["rollout", "--out", out, "--board", "9"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CNNRollout(board=9)
    assert not os.listdir(tmp_path)
    specs.main(["rollout", "--out", out, "--board", "9", "--device",
                "cpu"])
    capsys.readouterr()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_player("mcts", SPEC, VALUE_SPEC, out, device_rollout=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gtp.main(["--player", "mcts", "--policy", SPEC, "--value",
                  VALUE_SPEC, "--rollout", out, "--device-rollout"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tournament.main([f"mcts:{SPEC}:{VALUE_SPEC}:{out}", f"greedy:{SPEC}",
                         "--board", "9", "--device-rollout"])
    player = build_player("mcts", SPEC, VALUE_SPEC, out, playouts=8,
                          device_rollout=True, device="cpu")
    assert isinstance(player, mcts.MCTSPlayer)
    assert player.get_move(pygo.GameState(size=9)) is not None


def test_zero_loop_entry_points_need_a_card_or_an_explicit_cpu(
        monkeypatch, tmp_path):
    """The zero CLI, its iteration and gate, and the curriculum raise
    with no card unless the CPU is named; the replay buffer, the actor
    and learner plumbing, the supervisor and the watchdog touch no
    device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zero.run_training([SPEC, VALUE_SPEC, out])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        curriculum.run_curriculum([SPEC, VALUE_SPEC, out, "--stages",
                                   "9:1"])
    cfg = torchgo.GoConfig(size=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zero.ZeroIteration(cfg, ("board",), ("board", "color"), 2, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zero.ZeroGate(cfg, ("board",), out, 2, 0.55, 1.0, 10)
    assert not os.path.exists(out)
    # host plumbing needs no device at all
    buf = replay.ReplayBuffer(capacity=1)
    pub = actor.ParamsPublisher()
    learner.ZeroLearner(None, buf)
    supervisor.Supervisor()
    watchdog.Watchdog(1.0)
    assert pub.get()[0] == -1 and buf.fill == 0
    # the same CLI runs when the CPU is named
    res = zero.run_training([SPEC, VALUE_SPEC, out, "--game-batch", "2",
                             "--sims", "2", "--iterations", "1",
                             "--move-limit", "2", "--gate-games", "2",
                             "--device", "cpu"])
    assert res["iteration"] == 0


def test_serving_entry_points_need_a_card_or_an_explicit_cpu(
        monkeypatch, capsys):
    """GTP ``--serve`` and ``--serve-sizes`` raise with no card unless
    the CPU is named; the ladder, the fault barriers, the registry and
    the admission controller touch no device."""
    from rocalphago_tpu_torch.interface import resilient
    from rocalphago_tpu_torch.obs import registry
    from rocalphago_tpu_torch.runtime import faults
    from rocalphago_tpu_torch.serve import AdmissionController, evalcache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flag in (["--serve"], ["--serve-sizes", "9,13"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gtp.main(flag + ["--policy", SPEC, "--value", VALUE_SPEC])
    faults.install("error@nowhere")
    faults.barrier("serve.search")
    faults.install(None)
    registry.Registry().counter("x").inc()
    AdmissionController().admit_session()
    evalcache.EvalCache(capacity=2).insert((1, 2, 9, 7.5, 0), None)

    class Passer:
        def get_move(self, state):
            raise RuntimeError("no search")

    ladder = resilient.ResilientPlayer(Passer())
    assert ladder.get_move(pygo.GameState(size=9)) is not None
    assert ladder.last_rung == "fallback"
    monkeypatch.setattr("sys.stdin", __import__("io").StringIO(
        "genmove b\nrocalphago-health\nquit\n"))
    gtp.main(["--serve", "--policy", SPEC, "--value", VALUE_SPEC,
              "--playouts", "2", "--device", "cpu"])
    replies = capsys.readouterr().out.split("\n\n")
    assert replies[0].startswith("= ") and '"live": 1' in replies[1]


def test_kernel_wrappers_do_not_fall_back():
    """Off the CPU a wrapper launches its kernel or raises; a device it
    has no kernel for is refused, not quietly run on the CPU."""
    boards = torch.zeros((2, 81), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        labels.labels(boards, 9)
    with pytest.raises(ValueError, match="unsupported device"):
        chase.chase(boards, torch.zeros((2, 81), dtype=torch.int32,
                                        device="meta"),
                    torch.zeros((2,), dtype=torch.int32, device="meta"), 9)
    slab = {k: torch.zeros((2, 4, 82), dtype=d, device="meta")
            for k, d in (("prior", torch.float32), ("visits", torch.int32),
                         ("value_sum", torch.float32),
                         ("child", torch.int32))}
    rows = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    games = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tree.descend(*slab.values(), rows.bool(), games, games, 5.0)
    with pytest.raises(ValueError, match="unsupported device"):
        tree.backup(slab["visits"], slab["value_sum"], rows, rows, games,
                    games, games.float())


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
