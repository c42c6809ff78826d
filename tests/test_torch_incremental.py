"""The port's incremental encoder (``rocalphago_tpu_torch/features/
incremental.py``) against the reference's, on the CPU: trajectories.

At every ply of seeded games (passes, multi-stone captures, ko, a jump
to another game) the port's ``encode_step`` gives the planes of the
reference's ``encode_step`` and of the port's own scratch encode, and
every field of its cache carry equals the reference's (the footprint
keys by value: uint32 there, int64 here). All of it is integer or
0/1 planes: no tolerance. The batched carry of 4 games equals the
reference's ``batched_delta_encoder`` (its ``refresh_slots=0`` trace)
and its per-game ``encode_step`` (the default compacted trace) at once,
which pins the port's one branch-free form against both. A warm
reference cache carried in through the converter gives the reference's
next ply. The reference is jitted once per board size and feature set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.engine import jaxgo, pygo
from rocalphago_tpu.features import incremental as ref_incr
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.features import incremental as incr
from rocalphago_tpu_torch.features.pyfeatures import DEFAULT_FEATURES
from torch_port_helpers import (  # noqa: F401
    INCR_KOMI as KOMI,
    IncrementalCarry as Carry,
    assert_same_cache,
    one_torch_thread,
    play_carry as play,
    ref_encode_step as ref_step,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

def test_dense_5x5_with_passes():
    """Dense 5×5 play to the double-pass end: captures, ko fights and
    forced passes all occur."""
    carry = Carry(5)
    play(carry, seed=1, plies=70, pass_every=11)
    stats = carry.stats()
    assert stats[incr.STAT_ENCODES] >= 30
    assert stats[incr.STAT_CHASES] > 0 and stats[incr.STAT_FLIPS] > 0


def test_cross_game_jump_stays_exact():
    """A warm cache of one game, then another game's position with no
    reset: the board diff handles the jump."""
    carry = Carry(5)
    play(carry, seed=11, plies=16)
    other = pygo.GameState(size=5, komi=KOMI)
    rng = np.random.default_rng(12)
    for _ in range(9):
        moves = other.get_legal_moves()
        other.do_move(moves[rng.integers(len(moves))])
    carry.step(other, "the jump")
    play(carry, seed=13, plies=6, start=other)


def test_encode_delta_step_form():
    """``encode_delta(prev, cache, move)`` steps on the tensors and
    encodes the successor: the same planes and carry as stepping first
    and calling ``encode_step``, and as the reference's step-then-encode
    (its ``encode_delta`` is that composition)."""
    cfg = torchgo.GoConfig(size=5, komi=KOMI)
    jcfg = jaxgo.GoConfig(size=5, komi=KOMI)
    ref_play = jax.jit(lambda s, m: jaxgo.step(jcfg, s, m))
    state = torchgo.new_states(cfg, 1, device="cpu")
    jstate = jaxgo.new_state(jcfg)
    cache_a = cache_b = incr.init_cache(cfg)
    ref_cache = ref_incr.init_cache(jcfg)
    rng = np.random.default_rng(3)
    for i in range(12):
        gd = torchgo.group_data(cfg, state.board, labels=state.labels)
        options = np.flatnonzero(
            torchgo.legal_mask(cfg, state, gd)[0, :cfg.num_points].numpy())
        mv = (int(options[rng.integers(len(options))]) if len(options)
              else cfg.num_points)
        move = torch.tensor([mv], dtype=torch.int32)
        planes_a, cache_a = incr.encode_delta(cfg, state, cache_a, move)
        state = torchgo.step(cfg, state, move)
        planes_b, cache_b = incr.encode_step(cfg, state, cache_b)
        jstate = ref_play(jstate, jnp.int32(mv))
        ref_planes, ref_cache = ref_step(5)(jstate, ref_cache)
        assert torch.equal(planes_a, planes_b), i
        np.testing.assert_array_equal(planes_a[0].numpy(),
                                      np.asarray(ref_planes), err_msg=str(i))
        assert_same_cache(cache_a, ref_cache, f"step {i}")
        assert all(torch.equal(a, b) for a, b in zip(cache_a, cache_b))


def test_batched_carry_is_both_reference_traces():
    """4 games stepped by random actions: the port's batched carry
    equals the reference's vmapped ``batched_delta_encoder``
    (``refresh_slots=0``) and each game's own ``encode_step`` (the
    compacted default), planes and every cache field, at every step."""
    size, batch = 5, 4
    cfg, jcfg = torchgo.GoConfig(size=size, komi=KOMI), jaxgo.GoConfig(size=size, komi=KOMI)
    denc = jax.jit(ref_incr.batched_delta_encoder(jcfg, DEFAULT_FEATURES))
    one = ref_step(size)
    vstep = jax.jit(jax.vmap(lambda s, a: jaxgo.step(jcfg, s, a)))
    jstates = jaxgo.new_states(jcfg, batch)
    ref_caches = ref_incr.init_caches(jcfg, batch)
    singles = [ref_incr.init_cache(jcfg) for _ in range(batch)]
    states = torchgo.new_states(cfg, batch, device="cpu")
    caches = incr.init_caches(cfg, batch)
    rng = np.random.default_rng(17)
    for t in range(6):
        want, ref_caches = denc(jstates, ref_caches)
        got, caches = incr.encode_step(cfg, states, caches)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"step {t}")
        host_states = jax.tree.map(np.asarray, jstates)
        host_caches = jax.tree.map(np.asarray, ref_caches)
        for g in range(batch):
            p1, singles[g] = one(jax.tree.map(lambda x, g=g: x[g],
                                              host_states), singles[g])
            np.testing.assert_array_equal(np.asarray(p1), got[g].numpy())
            assert_same_cache(caches, singles[g], f"step {t} single", g)
            assert_same_cache(caches, jax.tree.map(
                lambda x, g=g: x[g], host_caches), f"step {t} vmapped", g)
        actions = rng.integers(0, cfg.num_points + 1, size=batch)
        jstates = vstep(jstates, jnp.asarray(actions, jnp.int32))
        states = torchgo.step(cfg, states,
                              torch.as_tensor(actions, dtype=torch.int32))
    assert int(caches.stats[:, incr.STAT_REFRESHED].sum()) > 0


def test_converter_carries_a_warm_reference_cache():
    """The reference plays 14 plies alone; its warm cache, converted to
    the port's, gives the reference's next ply (planes and carry), and
    the converter round-trips by value."""
    size = 5
    jcfg, cfg = jaxgo.GoConfig(size=size, komi=KOMI), torchgo.GoConfig(size=size, komi=KOMI)
    ref_cache = ref_incr.init_cache(jcfg)
    st = pygo.GameState(size=size, komi=KOMI)
    rng = np.random.default_rng(21)
    for _ in range(14):
        moves = st.get_legal_moves()
        st.do_move(moves[rng.integers(len(moves))])
        _, ref_cache = ref_step(size)(jaxgo.from_pygo(jcfg, st), ref_cache)
    assert np.asarray(ref_cache.entry_valid).any()
    port_cache = incr.cache_from_numpy(
        jax.tree.map(np.asarray, ref_cache)._asdict())
    assert port_cache.entry_footmask.dtype == torch.int64
    assert_same_cache(port_cache, ref_cache, "converted")
    back = incr.cache_to_numpy(port_cache, single=True)
    assert back["entry_footmask"].dtype == np.uint32
    carry = Carry(size)
    carry.ref, carry.port = ref_cache, port_cache
    play(carry, seed=22, plies=4, start=st)
    assert carry.stats()[incr.STAT_REUSED] >= 0
    # a dict of arrays by field name converts the same way
    again = incr.cache_from_numpy(incr.cache_to_numpy(carry.port))
    assert all(torch.equal(a, b) for a, b in zip(again, carry.port))
