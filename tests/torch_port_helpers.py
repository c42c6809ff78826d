"""Shared inputs for the PyTorch port's parity tests
(``tests/test_torch_*.py``): seeded random games on the host rules
oracle, the same positions as batched states of both packages, and the
incremental encoders of both packages stepped side by side."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.engine import jaxgo, pygo
from rocalphago_tpu.features import incremental as ref_incr
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.features import incremental as incr
from rocalphago_tpu_torch.features import planes


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


#: komi of the incremental trajectories (the reference's tests' komi)
INCR_KOMI = 5.5


@functools.lru_cache(maxsize=None)
def ref_encode_step(size: int, features=None):
    """The reference's ``encode_step``, jitted once per size and
    feature set for the whole test process."""
    cfg = jaxgo.GoConfig(size=size, komi=INCR_KOMI)
    return jax.jit(lambda s, c: ref_incr.encode_step(cfg, s, c,
                                                     features=features))


def assert_same_cache(port, ref, what: str, game=None) -> None:
    """Every field of the port's cache (game ``game`` of a batch, or a
    batch of one) equals the reference's single-game cache (the
    footprint keys by value)."""
    got = incr.cache_to_numpy(port)
    for name in incr.EncodeCache._fields:
        want = np.asarray(getattr(ref, name))
        have = got[name][0 if game is None else game]
        np.testing.assert_array_equal(have, want, err_msg=f"{what}: {name}")


class IncrementalCarry:
    """The port's and the reference's encode caches side by side,
    stepped on the same host states: at every step the port's planes
    equal the reference's and the port's scratch encode, and every
    cache field equals the reference's."""

    def __init__(self, size: int, features=None):
        self.size = size
        self.features = features
        self.jcfg = jaxgo.GoConfig(size=size, komi=INCR_KOMI)
        self.cfg = torchgo.GoConfig(size=size, komi=INCR_KOMI)
        self.ref = ref_incr.init_cache(self.jcfg)
        self.port = incr.init_cache(self.cfg)

    def step(self, st, what: str) -> None:
        ref_planes, self.ref = ref_encode_step(self.size, self.features)(
            jaxgo.from_pygo(self.jcfg, st), self.ref)
        ts = torchgo.from_pygo(self.cfg, [st], device="cpu")
        got, self.port = incr.encode_step(self.cfg, ts, self.port,
                                          features=self.features)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref_planes),
                                      err_msg=f"{what}: planes vs reference")
        assert torch.equal(got, planes.encode(self.cfg, ts, self.features)), \
            f"{what}: planes vs the port's scratch encode"
        assert_same_cache(self.port, self.ref, what)

    def stats(self) -> np.ndarray:
        return self.port.stats[0].numpy()


def play_carry(carry: IncrementalCarry, seed: int, plies: int, start=None,
               pass_every: int = 0):
    """Seeded random legal play from ``start`` (default an empty
    board), the carry stepped and checked at every ply; returns the
    final host state."""
    st = (start.copy() if start is not None
          else pygo.GameState(size=carry.size, komi=INCR_KOMI))
    rng = np.random.default_rng(seed)
    for i in range(plies):
        if st.is_end_of_game:
            break
        moves = st.get_legal_moves()
        if (pass_every and i % pass_every == pass_every - 1) or not moves:
            mv = None
        else:
            mv = moves[rng.integers(len(moves))]
        st.do_move(mv)
        carry.step(st, f"ply {i} (move {mv})")
    return st


def ladder_start(size: int, komi: float = INCR_KOMI):
    """A working ladder: white (2, 2) at two liberties, black to chase
    it diagonally to the far corner, and a lone white corner stone."""
    st = pygo.GameState(size=size, komi=komi)
    st.do_move((1, 2), pygo.BLACK)
    st.do_move((2, 2), pygo.WHITE)
    st.do_move((2, 1), pygo.BLACK)
    st.do_move((size - 1, size - 1), pygo.WHITE)
    st.do_move((3, 1), pygo.BLACK)
    st.current_player = pygo.BLACK
    return st


#: the incremental paths' nets: ladder planes, so caches reuse lanes
LADDER_NET_FEATURES = ("board", "ladder_capture", "ladder_escape", "ones")


def ladder_nets(size: int):
    """2 × 4 reference policy and value nets over
    :data:`LADDER_NET_FEATURES` and the port's, carried across in
    float32: ``(ref policy, ref value, port policy, port value)``."""
    from rocalphago_tpu.models import CNNPolicy as RefPolicy
    from rocalphago_tpu.models import CNNValue as RefValue
    from rocalphago_tpu_torch.models import CNNPolicy, CNNValue
    from rocalphago_tpu_torch.models.weights import params_from_flax

    feats = LADDER_NET_FEATURES
    kw = dict(board=size, layers=2, filters_per_layer=4)
    rp = RefPolicy(feats, seed=1, **kw)
    rv = RefValue(feats + ("color",), seed=2, **kw)
    pp = CNNPolicy(feats, init_weights=False, device="cpu",
                   dtype=torch.float32, **kw)
    pv = CNNValue(feats + ("color",), init_weights=False, device="cpu",
                  dtype=torch.float32, **kw)
    for ref, port in ((rp, pp), (rv, pv)):
        ref.module = ref.module.clone(dtype=jnp.float32)
        ref._apply = jax.jit(ref.module.apply)
        port.module.load_state_dict(params_from_flax(
            jax.tree.map(np.asarray, ref.params)))
    return rp, rv, pp, pv


def registry_counter(name: str, **labels) -> int:
    """A counter of the port's process registry (0 when unset)."""
    from rocalphago_tpu_torch.obs import registry

    key = name + ("{" + ",".join(f'{k}="{labels[k]}"'
                                 for k in sorted(labels)) + "}"
                  if labels else "")
    return registry.snapshot()["counters"].get(key, 0)
