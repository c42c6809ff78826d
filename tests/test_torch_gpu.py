"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``gpu`` and skips without a CUDA card; the
card is looked for when a test runs (a fixture), never at import, so
every pytest-xdist worker collects the same tests. The card machine
has no JAX, and ``tests/conftest.py`` imports it, so run this file
there without the conftest::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_gpu.py -m gpu

This file imports only torch, numpy and the port. Tolerance: exact for
the kernels and the encode (integer and boolean outputs).
"""

import io

import numpy as np
import pytest
import torch

from rocalphago_tpu_torch.engine import pygo, torchgo
from rocalphago_tpu_torch.features import Preprocess
from rocalphago_tpu_torch.interface.gtp import run_gtp, vertex_to_move
from rocalphago_tpu_torch.models import CNNPolicy
from rocalphago_tpu_torch.ops import chase, labels
from rocalphago_tpu_torch.search.players import GreedyPolicyPlayer

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_positions(size, count, lo, hi, seed):
    """Seeded random play on the port's rules oracle."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        st = pygo.GameState(size=size)
        target = int(rng.integers(lo, hi + 1))
        tries = 0
        while st.turns_played < target and tries < 4 * target + 4:
            tries += 1
            empty = np.flatnonzero(st.board.reshape(-1) == 0)
            mv = divmod(int(empty[rng.integers(len(empty))]), size)
            if st.is_eye(mv, st.current_player):
                continue
            try:
                st.do_move(mv)
            except pygo.IllegalMove:
                continue
        out.append(st)
    return out


def snake(size):
    b = np.zeros((size, size), np.int8)
    for x in range(size):
        if x % 2 == 0:
            b[x, :] = 1
        else:
            b[x, size - 1 if (x // 2) % 2 == 0 else 0] = 1
    return b.reshape(-1)


@pytest.mark.parametrize("size", [9, 19, 25])
def test_labels_kernel_matches_plain(cuda_device, size):
    boards = np.stack([np.asarray(s.board, np.int8).reshape(-1) for s in
                       random_positions(size, 64, 0, size * size // 2, 1)]
                      + [snake(size), -snake(size)])
    t = torch.as_tensor(boards, device=cuda_device)
    before = labels.launches
    got = labels.labels(t, size)
    assert labels.launches == before + 1
    assert torch.equal(got, labels.labels_plain(t, size))


def encode_lanes(device, size, states):
    """The chase lanes one encode of ``states`` sends to the wrapper."""
    seen = []
    inner = chase.chase

    def record(b, lab, p, sz, depth=40, collect_core=False):
        seen.append((b, lab, p))
        return inner(b, lab, p, sz, depth, collect_core)

    cfg = torchgo.GoConfig(size=size)
    chase.chase = record
    try:
        Preprocess(cfg=cfg, device=device).states_to_tensor(
            torchgo.from_pygo(cfg, states, device=device))
    finally:
        chase.chase = inner
    return [torch.cat(x) for x in zip(*seen)]


@pytest.mark.parametrize("size", [9, 19])
def test_chase_kernel_matches_plain(cuda_device, size):
    boards, labs, prey = encode_lanes(
        cuda_device, size, random_positions(size, 48, 10, size * 8, 2))
    prey = torch.cat([prey, torch.full_like(prey[:8], -1)])
    boards = torch.cat([boards, boards[:8]])
    labs = torch.cat([labs, labs[:8]])
    before = chase.launches
    cap, core = chase.chase(boards, labs, prey, size, 40,
                            collect_core=True)
    assert chase.launches == before + 1
    pcap, pcore = chase.chase_plain(boards, labs, prey, size, 40,
                                    collect_core=True)
    assert torch.equal(cap, pcap) and torch.equal(core, pcore)
    assert not cap[-8:].any() and not core[-8:].any()
    assert cap.any()


def test_card_encode_equals_cpu_encode(cuda_device):
    cfg = torchgo.GoConfig(size=19)
    states = random_positions(19, 32, 20, 220, 3)
    gpu = Preprocess(cfg=cfg, device=cuda_device).states_to_tensor(
        torchgo.seed_labels(cfg, torchgo.from_pygo(
            cfg, states, device=cuda_device, with_labels=False)))
    cpu = Preprocess(cfg=cfg, device="cpu").states_to_tensor(
        torchgo.from_pygo(cfg, states, device="cpu"))
    assert torch.equal(gpu.cpu(), cpu)


def test_genmove_launches_both_kernels(cuda_device):
    net = CNNPolicy(board=19, layers=3, filters_per_layer=16, seed=0,
                    device=cuda_device)
    out = io.StringIO()
    before = (labels.launches, chase.launches)
    engine = run_gtp(GreedyPolicyPlayer(net), io.StringIO(
        "boardsize 19\ngenmove b\ngenmove w\nquit\n"), out)
    assert labels.launches > before[0] and chase.launches > before[1]
    moves = [r[2:] for r in out.getvalue().split("\n\n")
             if r.startswith("= ")]
    assert len(moves) == 2 and engine.illegal_from_player == 0
    assert all(vertex_to_move(v, 19) is not None for v in moves)
