"""Shared inputs for the PyTorch port's parity tests
(``tests/test_torch_*.py``): seeded random games on the host rules
oracle and the same positions as batched states of both packages."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.engine import jaxgo, pygo
from rocalphago_tpu_torch.engine import torchgo


def random_games(size: int, count: int, lo: int, hi: int, seed: int,
                 komi: float = 7.5, superko: bool = False):
    """``count`` seeded random games of ``lo..hi`` plies: a uniform
    random empty point per ply, own eyes skipped, illegal tries
    dropped (the reference oracle's rules decide)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        st = pygo.GameState(size=size, komi=komi, enforce_superko=superko)
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


def jax_states(cfg, states) -> jaxgo.GoState:
    """Host states → the reference's batched ``GoState``."""
    return jax.tree.map(lambda *xs: jnp.stack(xs),
                        *[jaxgo.from_pygo(cfg, s) for s in states])


def torch_states(size: int, states, superko: bool = False,
                 **kw) -> torchgo.GoState:
    """Host states → the port's batched ``GoState`` on the CPU."""
    return torchgo.from_pygo(
        torchgo.GoConfig(size=size, enforce_superko=superko), states,
        device="cpu", **kw)


def serpentine(size: int) -> np.ndarray:
    """A one-wide boustrophedon snake: one group whose label travels
    the longest path a board allows."""
    b = np.zeros((size, size), np.int8)
    for x in range(size):
        if x % 2 == 0:
            b[x, :] = 1
        else:
            b[x, size - 1 if (x // 2) % 2 == 0 else 0] = 1
    return b.reshape(-1)


@pytest.fixture
def one_torch_thread():
    """Run torch single-threaded: the port's plain versions issue many
    small ops, where an intra-op thread pool only adds wake-up cost
    (and several test workers share the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
