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
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.interface import gtp, selfplay_cli
from rocalphago_tpu_torch.models import CNNPolicy, CNNValue, NeuralNetBase
from rocalphago_tpu_torch.ops import chase, labels, tree
from rocalphago_tpu_torch.search import selfplay
from rocalphago_tpu_torch.search.device_mcts import make_mcts_selfplay
from rocalphago_tpu_torch.data import convert
from rocalphago_tpu_torch.training import evaluate, sl, value

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
