"""The port's per-session komi and multi-size pool
(``rocalphago_tpu_torch/multisize``) against the reference's.

``eval_batch_komi`` at the default komi is ``eval_batch`` bit for bit in
both packages, and under a custom komi per row the terminal values
(rescored through the labels path's area scores) are the reference's --
with the sign flip where the komi turns the result. A pool session with
its own komi rides the komi evaluation, a default-komi session stays
off it; a multi-size pool shares one module across its sizes, routes
sessions by size, refuses size-locked heads, and GTP ``boardsize``
re-routes the engine's session with its komi carried.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.engine import jaxgo
from rocalphago_tpu.engine import pygo as ref_pygo
from rocalphago_tpu.search import device_mcts as ref_mcts
from rocalphago_tpu_torch.engine import pygo, torchgo
from rocalphago_tpu_torch.interface import gtp
from rocalphago_tpu_torch.models import CNNPolicy, CNNValue
from rocalphago_tpu_torch.multisize import DEFAULT_SIZES, MultiSizePool
from rocalphago_tpu_torch.search import device_mcts
from rocalphago_tpu_torch.serve import ServePool
from torch_port_helpers import (  # noqa: F401
    jax_states,
    one_torch_thread,
    random_games,
    torch_states,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 5
N = SIZE * SIZE
FEATS = ("board", "ones")
VFEATS = FEATS + ("color",)
CFG = jaxgo.GoConfig(size=SIZE)
TCFG = torchgo.GoConfig(size=SIZE)


def finished_games():
    """Live and finished games of every outcome: random play, passed
    out (both passes), and an empty board passed out (white by komi)."""
    out = [ref_pygo.GameState(size=SIZE)]
    empty = ref_pygo.GameState(size=SIZE)
    empty.do_move(None)
    empty.do_move(None)
    out.append(empty)
    for st in random_games(SIZE, 6, 4, 20, seed=17):
        out.append(st.copy())
        st.do_move(None)
        st.do_move(None)
        out.append(st)
    return out


def fake_policy(params, planes):
    return jnp.zeros((planes.shape[0], N))


def fake_value(params, planes):
    return planes[..., 0].sum(axis=(1, 2)) / N


def test_eval_batch_komi_is_the_references():
    sts = finished_games()
    b = len(sts)
    jst, tst = jax_states(CFG, sts), torch_states(SIZE, sts)
    ref = ref_mcts.make_device_mcts(CFG, FEATS, VFEATS, fake_policy,
                                    fake_value, n_sim=4)
    port = device_mcts.make_device_mcts(
        TCFG, FEATS, VFEATS, lambda p: torch.zeros((p.shape[0], N)),
        lambda p: p[..., 0].sum(dim=(1, 2)) / N, n_sim=4)
    rng = np.random.default_rng(5)
    komis = np.concatenate([[7.5, -25.0],
                            rng.uniform(-30, 30, b - 2)]).astype(np.float32)
    with jax.enable_checks(False):
        p0, v0 = port.eval_batch(tst)
        p1, v1 = port.eval_batch_komi(tst, torch.full((b,), TCFG.komi))
        assert torch.equal(p0, p1) and torch.equal(v0, v1)
        rp0, rv0 = ref.eval_batch(None, None, jst)
        np.testing.assert_array_equal(v0.numpy(), np.asarray(rv0))
        _, v2 = port.eval_batch_komi(tst, torch.as_tensor(komis))
        _, rv2 = ref.eval_batch_komi(None, None, jst, jnp.asarray(komis))
    np.testing.assert_array_equal(v2.numpy(), np.asarray(rv2))
    # the empty board passed out: white wins by komi at the default,
    # black once the komi is -25
    assert float(v0[1]) == -float(v2[1]) != 0.0
    done = np.array([s.is_end_of_game for s in sts])
    assert (v2.numpy()[done] != v0.numpy()[done]).any()


@pytest.fixture(scope="module")
def fcn_nets():
    kw = dict(board=SIZE, layers=2, filters_per_layer=8, device="cpu")
    return (CNNPolicy(FEATS, seed=1, **kw), CNNValue(VFEATS, seed=2, **kw))


def test_pool_komi_session_and_pinned_default_path(fcn_nets):
    pol, val = fcn_nets
    with ServePool(val, pol, n_sim=4, batch_sizes=(1, 2, 4)) as pool:
        sess = pool.open_session(resilient=False, komi=0.5)
        mv = sess.get_move(pygo.GameState(size=SIZE, komi=0.5))
        assert mv is None or isinstance(mv, tuple)
        st = pool.stats()
        assert st["evaluator"]["komi_batches"] == 5   # root + 4 sims
        assert st["board"] == SIZE
        assert st["komi_default"] == float(pol.cfg.komi)
        before = pool.evaluator.komi_batches
        s2 = pool.open_session(resilient=False)
        s2.get_move(pygo.GameState(size=SIZE))
        assert pool.evaluator.komi_batches == before
        s2.set_komi(pol.cfg.komi)          # equal to the default: off
        s2.get_move(pygo.GameState(size=SIZE))
        assert pool.evaluator.komi_batches == before
        s2.set_komi(0.5)
        assert s2.komi == 0.5
        # the fleet driver rides one komi per row
        drv = pool.driver([sess, s2])
        assert drv._komi_rows(2) == [0.5, 0.5]
        drv.genmove_all([pygo.GameState(size=SIZE)] * 2)
        assert pool.evaluator.komi_batches == before + 5


@pytest.fixture(scope="module")
def msize_pool(fcn_nets):
    pol, val = fcn_nets
    pool = MultiSizePool(val, pol, sizes=(5, 7), n_sim=4,
                         batch_sizes=(1, 2, 4))
    yield pool
    pool.close()


def test_routing_shares_one_checkpoint(fcn_nets, msize_pool):
    pol, val = fcn_nets
    assert DEFAULT_SIZES == (9, 13, 19)
    assert msize_pool.sizes == (5, 7) and msize_pool.default_size == 5
    p7 = msize_pool.pool_for(7)
    assert p7.policy.module is pol.module and p7.value.module is val.module
    assert p7.board == 7 and p7.cfg.size == 7
    s5 = msize_pool.open_session(resilient=False)
    s7 = msize_pool.open_session(size=7, resilient=False)
    try:
        assert s5.raw.board == 5 and s7.raw.board == 7
        assert s5.get_move(pygo.GameState(size=5)) is not None
        assert s7.get_move(pygo.GameState(size=7)) is not None
        with pytest.raises(ValueError, match="one board size"):
            msize_pool.driver([s5, s7])
        assert msize_pool.driver([s7]).genmove_all(
            [pygo.GameState(size=7)])[0] is not None
    finally:
        s5.close()
        s7.close()


def test_probe_schema_and_add_size(msize_pool):
    st = msize_pool.stats()
    assert st["multisize"] is True and st["default_board"] == 5
    assert set(st["boards"]) == {str(s) for s in msize_pool.sizes}
    for size, row in st["boards"].items():
        assert row["board"] == int(size)
        assert "komi_batches" in row["evaluator"]
    assert st["sessions_live"] == sum(
        b["sessions"]["live"] for b in st["boards"].values())
    with pytest.raises(KeyError, match="add_size"):
        msize_pool.pool_for(11)
    msize_pool.add_size(11)
    assert 11 in msize_pool.sizes
    assert msize_pool.add_size(11) is msize_pool.pool_for(11)


def test_refuses_size_locked_heads(fcn_nets):
    pol, _ = fcn_nets
    dense = CNNValue(VFEATS, board=SIZE, layers=2, filters_per_layer=8,
                     head="dense", device="cpu")
    with pytest.raises(ValueError, match="size-locked head"):
        MultiSizePool(dense, pol, sizes=(5, 7))
    bias = CNNPolicy(FEATS, board=SIZE, layers=2, filters_per_layer=8,
                     head="bias", device="cpu")
    with pytest.raises(ValueError, match="FCN heads"):
        MultiSizePool(fcn_nets[1], bias, sizes=(5,))


def test_gtp_boardsize_reroutes_and_carries_komi(msize_pool):
    sess = msize_pool.open_session(resilient=True)
    eng = gtp.GTPEngine(sess.player, serve_pool=msize_pool,
                        serve_session=sess)
    assert eng.size == 5
    assert eng.handle("1 komi 6.5")[0].startswith("=1")
    assert sess.raw.komi == 6.5              # re-threaded into the session
    r, _ = eng.handle("2 boardsize 7")
    assert r.startswith("=2"), r
    assert eng.size == 7 and eng._serve_session is not sess
    assert eng._serve_session.raw.board == 7
    assert eng._serve_session.komi == 6.5
    r, _ = eng.handle("3 genmove b")
    assert r.startswith("=3 ") and gtp.vertex_to_move(r[3:].strip(), 7)
    # a size the ladder does not serve is still refused
    assert eng.handle("4 boardsize 17")[0].startswith("?4")
    health = eng.handle("rocalphago-health")[0]
    assert '"multisize": true' in health
    eng._serve_session.close()
    assert msize_pool.stats()["sessions_live"] == 0
