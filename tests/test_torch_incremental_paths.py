"""The incremental encoder's users in the port, on the CPU:
``Preprocess.advance``, the device-search players, policy self-play and
GTP's resets.

* ``Preprocess.advance`` (both forms) equals ``state_to_tensor`` at every
  ply, its stats equal the reference's ``encode_step`` stats, and its
  counters and ``reset_cache`` reasons are the reference's rules.
* ``DeviceMCTSPlayer`` (PUCT) with the incremental root encode makes
  the moves, and keeps the root visits, of the scratch root encode and
  of the reference's player (incremental, its default) on the same
  weights, with the reference's cache statistics; the cache rides
  across a komi change; the Gumbel searcher's cached root is the
  reference's. The Gumbel player makes the same moves either way (its
  draws come from torch, which cannot reproduce JAX's streams), and one
  ``run_chunked(caches=)`` is the search without the cache.
* Policy self-play with the incremental encode plays the same games as
  without it, monolithic and chunked.
* GTP's ``clear_board`` and ``boardsize`` pass the reference's reset
  reasons, ``undo`` resets nothing, and a device player counts
  ``encode_cache_resets_total{reason=}`` only when it holds a cache.

The nets carry ladder planes (``board``, ``ladder_capture``,
``ladder_escape``, ``ones``), so the cache has lanes to reuse.
"""

import jax
import numpy as np
import pytest
import torch

from rocalphago_tpu.engine import jaxgo, pygo
from rocalphago_tpu.features import incremental as ref_incr
from rocalphago_tpu.interface.gtp import GTPEngine as RefEngine
from rocalphago_tpu.search import device_mcts as ref_mcts
from rocalphago_tpu_torch.engine import pygo as tpygo
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.features import Preprocess
from rocalphago_tpu_torch.features import incremental as incr
from rocalphago_tpu_torch.interface import gtp
from rocalphago_tpu_torch.search import device_mcts, selfplay
from torch_port_helpers import (  # noqa: F401
    INCR_KOMI,
    ladder_nets,
    ladder_start,
    one_torch_thread,
    ref_encode_step,
    registry_counter as counter,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 7


def test_preprocess_advance_counters_and_resets():
    """8 plies of a 5×5 game: ``advance`` equals ``state_to_tensor``
    and its stats the reference's ``encode_step``'s; the ``move=``
    form steps and encodes; delta, full and position counters move as
    the reference's do; ``reset_cache`` counts its reason once per
    warm cache."""
    cfg = torchgo.GoConfig(size=5, komi=INCR_KOMI)
    pre = Preprocess(cfg=cfg, device="cpu")
    d0, f0 = counter("encode_delta_total"), counter("encode_full_total")
    p0 = counter("encode_positions_total", board="5")
    jcfg = jaxgo.GoConfig(size=5, komi=INCR_KOMI)
    ref_cache = ref_incr.init_cache(jcfg)
    st = pygo.GameState(size=5, komi=INCR_KOMI)
    rng = np.random.default_rng(23)
    plies = 8
    for i in range(plies):
        moves = st.get_legal_moves()
        st.do_move(moves[rng.integers(len(moves))])
        ts = torchgo.from_pygo(cfg, [st], device="cpu")
        assert torch.equal(pre.advance(ts), pre.state_to_tensor(ts)), i
        _, ref_cache = ref_encode_step(5)(jaxgo.from_pygo(jcfg, st),
                                          ref_cache)
    np.testing.assert_array_equal(pre._cache.stats[0].numpy(),
                                  np.asarray(ref_cache.stats))
    np.testing.assert_array_equal(pre._cache_stats,
                                  np.asarray(ref_cache.stats))
    got = pre.advance(ts, move=12)
    successor = torchgo.step(cfg, ts, torch.tensor([12], dtype=torch.int32))
    assert torch.equal(got, pre.state_to_tensor(successor))
    assert counter("encode_delta_total") == d0 + plies + 1
    assert counter("encode_full_total") == f0 + plies + 1
    assert counter("encode_positions_total", board="5") \
        == p0 + 2 * (plies + 1)
    stats = pre._cache_stats
    assert stats[incr.STAT_REFRESHED] > 0
    for i, field in enumerate(incr.STAT_FIELDS[1:], 1):
        if stats[i]:
            assert counter(f"encode_incr_{field}_total") >= stats[i]
    before = counter("encode_cache_resets_total", reason="undo")
    pre.reset_cache(reason="undo")
    assert counter("encode_cache_resets_total", reason="undo") == before + 1
    assert pre._cache is None
    pre.reset_cache(reason="undo")          # a cold cache counts nothing
    assert counter("encode_cache_resets_total", reason="undo") == before + 1
    sig = pre.state_signature(ts)
    assert sig.shape == (1, 2) and torch.equal(
        sig, torchgo.eval_signature(cfg, ts))


SCRIPT = [(2, 3), (3, 2), (0, 5), None, (5, 5), (4, 1)]


def ladder_game():
    """The 7×7 ladder position on the reference's and the port's host
    states."""
    st = ladder_start(SIZE, komi=7.5)
    st_p = tpygo.GameState(size=SIZE, komi=7.5)
    for x, y in zip(*np.nonzero(st.board)):
        st_p.do_move((int(x), int(y)), int(st.board[x, y]))
    st_p.current_player = st.current_player
    return st, st_p


def test_puct_player_incremental_is_scratch_and_reference():
    """A scripted 7×7 ladder game: the port's player with the
    incremental root encode, without it, and the reference's player
    (incremental, its default) choose the same moves; the port's two
    carried trees hold the same root visits; the stats are counted."""
    with jax.enable_checks(False):
        rp, rv, pp, pv = ladder_nets(SIZE)
        ref = ref_mcts.DeviceMCTSPlayer(rv, rp, n_sim=12, sim_chunk=4)
        on = device_mcts.DeviceMCTSPlayer(pv, pp, n_sim=12, sim_chunk=4,
                                          incremental=True)
        off = device_mcts.DeviceMCTSPlayer(pv, pp, n_sim=12, sim_chunk=4,
                                           incremental=False)
        st, st_p = ladder_game()
        d0 = counter("encode_delta_total")
        for i, scripted_move in enumerate(SCRIPT):
            mv_r, mv_on, mv_off = (ref.get_move(st), on.get_move(st_p),
                                   off.get_move(st_p))
            assert mv_on == mv_off == mv_r, (i, mv_on, mv_off, mv_r)
            v_on = device_mcts.DeviceMCTS.root_stats(on._carry[3])[0]
            v_off = device_mcts.DeviceMCTS.root_stats(off._carry[3])[0]
            assert torch.equal(v_on, v_off), i
            # play the script, not the search's move: the root often
            # moves to a position the tree never expanded (a fresh,
            # incrementally encoded root)
            st.do_move(scripted_move)
            st_p.do_move(scripted_move)
        np.testing.assert_array_equal(on._enc_cache.stats.numpy(),
                                      np.asarray(ref._enc_cache.stats))
        assert on._enc_stats[incr.STAT_ENCODES] == on._enc_cache.stats[
            0, incr.STAT_ENCODES]
        assert counter("encode_delta_total") - d0 \
            == int(on._enc_stats[incr.STAT_ENCODES])
        assert off._enc_cache is None
        assert on.reuses == off.reuses == ref.reuses < len(SCRIPT)
        # the Gumbel searcher's cached root against the reference's
        # (the reference player's compiled init_cached): the same root
        # priors and the same carry
        ref_search = ref._searcher_for(7.5)[1]
        jcfg = jaxgo.GoConfig(size=SIZE, komi=7.5)
        caches_r = ref_incr.init_caches(jcfg, 1)
        tree_r, caches_r = ref_search.init_cached(
            rp.params, rv.params, jax.tree.map(
                lambda x: x[None], jaxgo.from_pygo(jcfg, st)), caches_r)
        gsearch = device_mcts.make_gumbel_mcts(
            torchgo.GoConfig(size=SIZE, komi=7.5), pp.feature_list,
            pv.feature_list, pp.module, pv.module, n_sim=8, m_root=4)
        root = torchgo.from_pygo(gsearch.cfg, [st_p], device="cpu")
        tree_p, *_, caches_p = gsearch.init_cached(
            root, incr.init_cache(gsearch.cfg),
            noise=torch.zeros((1, SIZE * SIZE + 1)))
        np.testing.assert_allclose(tree_p.prior[0, 0].numpy(),
                                   np.asarray(tree_r.prior)[0, 0],
                                   atol=1e-5)
        got = incr.cache_to_numpy(caches_p)
        for name in incr.EncodeCache._fields:
            np.testing.assert_array_equal(
                got[name], np.asarray(getattr(caches_r, name)), name)
        # the cache rides across a komi change (a new searcher)
        encodes = int(on._enc_cache.stats[0, incr.STAT_ENCODES])
        assert encodes == len(SCRIPT) - on.reuses
        st_p.komi = 6.5
        on.get_move(st_p)
        assert len(on._searchers) == 2
        assert int(on._enc_cache.stats[0, incr.STAT_ENCODES]) == encodes + 1


def test_gumbel_player_and_search_with_caches():
    """The Gumbel player makes the same moves with the incremental root
    encode and without it (same seed, same draws), and one search with
    ``caches=`` equals one without, visits, best and π′ bit for bit."""
    _, _, pp, pv = ladder_nets(SIZE)
    on = device_mcts.DeviceMCTSPlayer(pv, pp, n_sim=8, sim_chunk=4,
                                      gumbel=True, m_root=4, incremental=True)
    off = device_mcts.DeviceMCTSPlayer(pv, pp, n_sim=8, sim_chunk=4,
                                       gumbel=True, m_root=4,
                                       incremental=False)
    _, st_p = ladder_game()
    for i, mv in enumerate(SCRIPT[:4]):
        assert on.get_move(st_p) == off.get_move(st_p), i
        st_p.do_move(mv)
    assert int(on._enc_cache.stats[0, incr.STAT_ENCODES]) == 4
    assert off._enc_cache is None
    search = on._searcher_for(7.5, 8)[1]
    root = torchgo.seed_labels(search.cfg, torchgo.from_pygo(
        search.cfg, [st_p], device="cpu", with_labels=False))
    noise = search.draw_noise(1, torch.Generator().manual_seed(3))
    plain = search.run_chunked(root, 4, noise=noise)
    assert search.last_caches is None
    cached = search.run_chunked(root, 4, noise=noise,
                                caches=on._enc_cache)
    assert search.last_caches is not None
    for a, b in zip(plain, cached):
        assert torch.equal(a, b)




def test_policy_selfplay_incremental_plays_the_same_games():
    """Batch 4 at 7×7, 24 plies: the monolithic and the chunked runner
    with the encode cache play the games of the runner without it (same
    generator seed), and the chunked runner's cache starts cold each
    run."""
    _, _, pp, _ = ladder_nets(SIZE)
    cfg = torchgo.GoConfig(size=SIZE)
    args = (cfg, pp.feature_list, pp.module, pp.module)

    def run(make, **kw):
        return make(*args, 4, 24, device="cpu", **kw)(
            torch.Generator().manual_seed(5))

    base = run(selfplay.make_selfplay, incremental=False)
    on = run(selfplay.make_selfplay, incremental=True)
    chunked = selfplay.make_selfplay_chunked(*args, 4, 24, chunk=10,
                                             device="cpu", incremental=True)
    seg0 = counter("selfplay_plies_total")
    res = chunked(torch.Generator().manual_seed(5))
    for got in (on, res):
        assert torch.equal(got.actions, base.actions)
        assert torch.equal(got.final.board, base.final.board)
    assert counter("selfplay_plies_total") == seg0 + 24
    caches = chunked.ply.caches
    assert int(caches.stats[:, incr.STAT_ENCODES].sum()) == 4 * 24
    again = chunked(torch.Generator().manual_seed(5))
    assert torch.equal(again.actions, base.actions)
    assert chunked.ply.caches is not caches
    assert selfplay.INCREMENTAL_DEFAULT in (True, False)


class ResetRecorder:
    """A player that passes and records its resets' reasons."""

    board = None

    def __init__(self):
        self.reasons = []

    def get_move(self, state):
        return None

    def reset(self, reason: str = "new_game"):
        self.reasons.append(reason)


GTP_SCRIPT = ("boardsize 7", "genmove b", "play w d4", "undo",
              "clear_board", "genmove w", "boardsize 7", "quit")


@pytest.mark.parametrize("resilient", [False, True])
def test_gtp_resets_pass_the_references_reasons(resilient):
    """The same script through both engines, with and without the
    resilience ladder (the engine resets the player it wraps), gives
    the same reasons; ``undo`` resets nothing."""
    port, ref = ResetRecorder(), ResetRecorder()
    engine = gtp.GTPEngine(port, resilient=resilient)
    ref_engine = RefEngine(ref, resilient=resilient)
    for cmd in GTP_SCRIPT:
        engine.handle(cmd)
        ref_engine.handle(cmd)
    assert port.reasons == ref.reasons \
        == ["boardsize", "clear_board", "boardsize"]


def test_gtp_counts_the_device_players_cache_resets():
    """A device player behind GTP (no ladder): a reset counts its
    reason only while the player holds a cache; ``undo`` counts
    nothing."""
    _, _, pp, pv = ladder_nets(SIZE)
    player = device_mcts.DeviceMCTSPlayer(pv, pp, n_sim=4, sim_chunk=4)
    engine = gtp.GTPEngine(player, resilient=False)

    def resets():
        return (counter("encode_cache_resets_total", reason="clear_board"),
                counter("encode_cache_resets_total", reason="boardsize"))

    r0 = resets()
    engine.handle("clear_board")                # no cache yet
    assert resets() == r0
    assert engine.handle("genmove b")[0].startswith("= ")
    engine.handle("play w a1")
    engine.handle("undo")
    assert resets() == r0
    engine.handle("clear_board")
    assert resets() == (r0[0] + 1, r0[1])
    engine.handle("genmove b")
    engine.handle("boardsize 7")
    assert resets() == (r0[0] + 1, r0[1] + 1)
