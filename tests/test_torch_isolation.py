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
from rocalphago_tpu_torch.interface import gtp
from rocalphago_tpu_torch.models import CNNPolicy, NeuralNetBase
from rocalphago_tpu_torch.ops import chase, labels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "rocalphago_tpu_torch")
SPEC = os.path.join(ROOT, "results/zero_r5/target_compare/puct/policy.json")
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


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
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
        Preprocess(device="cuda")


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


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
