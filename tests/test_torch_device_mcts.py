"""The port's device search (``rocalphago_tpu_torch/search/
device_mcts.py``) against the reference's, on the CPU.

The reference's fakes at 5×5 (uniform logits; a stone-count value) go
through both searchers: every simulation's descent, stepped leaves and
evaluations, and the whole tree after 32 simulations are bit-identical
(the fakes' softmax is 1/k exactly, so nothing needs a tolerance).
With small real nets carried across, the reference's own evaluations
fed into the port's ``apply_sim`` give the same tree, and the port's
evaluations agree within ``EVAL_ATOL`` (float32 summation order). The
plain tree walks are held against the reference's loops with forced
first edges; chunking, ``advance_root``, a tiny slab and a terminal
root behave as in the reference; the players make the same moves.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.engine import jaxgo, pygo
from rocalphago_tpu.models import CNNPolicy as RefPolicy
from rocalphago_tpu.models import CNNValue as RefValue
from rocalphago_tpu.search import device_mcts as ref_mcts
from rocalphago_tpu_torch.engine import pygo as tpygo
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.models import CNNPolicy, CNNValue
from rocalphago_tpu_torch.models.weights import params_from_flax
from rocalphago_tpu_torch.ops import tree as tree_ops
from rocalphago_tpu_torch.runtime.deadline import Deadline
from rocalphago_tpu_torch.search import device_mcts
from rocalphago_tpu_torch.search.clock import MoveClock
from rocalphago_tpu_torch.search.players import reset_player
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
EVAL_ATOL = 1e-5


def fake_policy(params, planes):
    return jnp.zeros((planes.shape[0], N))


def fake_value(params, planes):
    mine = planes[..., 0].sum(axis=(1, 2))
    theirs = planes[..., 1].sum(axis=(1, 2))
    return (mine - theirs) / N


def port_policy(planes):
    return torch.zeros((planes.shape[0], N))


def port_value(planes):
    mine = planes[..., 0].sum(dim=(1, 2))
    theirs = planes[..., 1].sum(dim=(1, 2))
    return (mine - theirs) / N


def exhausted(seed):
    """A 5×5 game played out with random sensible moves until the side
    to move has none and the last move was a pass: its search expands
    the pass into a finished game (a terminal leaf)."""
    rng = np.random.default_rng(seed)
    st = pygo.GameState(size=SIZE)
    while True:
        moves = st.get_legal_moves(include_eyes=False)
        if not moves:
            if st.history and st.history[-1] is None:
                return st
            st.do_move(None)
            continue
        st.do_move(moves[rng.integers(len(moves))])


def capture_position():
    """B to move with W (0, 0) in atari."""
    st = pygo.GameState(size=SIZE)
    st.do_move((1, 0), pygo.BLACK)
    st.do_move((0, 0), pygo.WHITE)
    st.current_player = pygo.BLACK
    return st


@functools.lru_cache(maxsize=None)
def positions():
    return ([pygo.GameState(size=SIZE), capture_position(), exhausted(3)]
            + random_games(SIZE, 2, 4, 12, seed=5))


def roots_both(sts=None):
    sts = positions() if sts is None else sts
    return jax_states(CFG, sts), torch_states(SIZE, sts)


@functools.lru_cache(maxsize=None)
def ref_searcher(n_sim=32, max_nodes=64, c_puct=5.0, forced_k=0.0):
    return ref_mcts.make_device_mcts(CFG, FEATS, VFEATS, fake_policy,
                                     fake_value, n_sim=n_sim,
                                     max_nodes=max_nodes, c_puct=c_puct,
                                     forced_k=forced_k)


def port_searcher(n_sim=32, max_nodes=64):
    return device_mcts.make_device_mcts(TCFG, FEATS, VFEATS, port_policy,
                                        port_value, n_sim=n_sim,
                                        max_nodes=max_nodes, c_puct=5.0)


def eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got).astype(np.float64),
                                  np.asarray(want).astype(np.float64),
                                  err_msg=what)


def assert_states(got, want, what):
    for name in jaxgo.GoState._fields:
        eq(getattr(got, name).numpy(), getattr(want, name),
           f"{what}: {name}")


def assert_trees(got, want):
    assert_states(got.states, want.states, "node states")
    for name in device_mcts.DeviceTree._fields[1:]:
        eq(getattr(got, name).numpy(), getattr(want, name), name)


def assert_ctx(got, want, sim):
    eq(got.node.numpy(), want.node, f"sim {sim}: node")
    eq(got.safe_action.numpy(), want.safe_action, f"sim {sim}: action")
    eq(got.expanding.numpy(), want.expanding, f"sim {sim}: expanding")
    assert_states(got.eval_states, want.eval_states, f"sim {sim}")


def test_search_is_the_reference_sim_by_sim():
    ref, port = ref_searcher(), port_searcher()
    jroots, troots = roots_both()
    b = troots.board.shape[0]
    free_j = jnp.full((b,), -1, jnp.int32)
    free_t = torch.full((b,), -1, dtype=torch.int32)
    with jax.enable_checks(False):
        tree_r = ref.init(None, None, jroots)
        tree_p = port.init(troots)
        assert_trees(tree_p, tree_r)
        saw_terminal = False
        for sim in range(32):
            ctx_r = ref.prepare_sim(tree_r, free_j)
            ctx_p = port.prepare_sim(tree_p, free_t)
            assert_ctx(ctx_p, ctx_r, sim)
            saw_terminal |= not bool(np.asarray(ctx_r.expanding).all())
            pr, vr = ref.eval_batch(None, None, ctx_r.eval_states)
            pp, vp = port.eval_batch(ctx_p.eval_states)
            eq(pp.numpy(), pr, f"sim {sim}: priors")
            eq(vp.numpy(), vr, f"sim {sim}: values")
            tree_r = ref.apply_sim(tree_r, ctx_r, pr, vr)
            port.apply_sim(tree_p, ctx_p, pp, vp)
        assert_trees(tree_p, tree_r)
        assert saw_terminal
        want = ref(None, None, jroots)
    got = port(troots)
    eq(got[0].numpy(), want[0], "visits")
    eq(got[1].numpy(), want[1], "q")
    np.testing.assert_array_equal(got[0].numpy().sum(axis=1), 32)


def small_nets(layers=1):
    """Reference nets of ``layers`` × 4 and the port's, carried across in
    float32."""
    kw = dict(board=SIZE, layers=layers, filters_per_layer=4)
    rp = RefPolicy(FEATS, seed=1, **kw)
    rv = RefValue(VFEATS, seed=2, **kw)
    pp = CNNPolicy(FEATS, init_weights=False, device="cpu",
                   dtype=torch.float32, **kw)
    pv = CNNValue(VFEATS, init_weights=False, device="cpu",
                  dtype=torch.float32, **kw)
    for ref, port in ((rp, pp), (rv, pv)):
        ref.module = ref.module.clone(dtype=jnp.float32)
        ref._apply = jax.jit(ref.module.apply)
        port.module.load_state_dict(params_from_flax(
            jax.tree.map(np.asarray, ref.params)))
    return rp, rv, pp, pv


def test_reference_evaluations_give_the_same_tree():
    with jax.enable_checks(False):
        rp, rv, pp, pv = small_nets()
        ref = ref_mcts.make_device_mcts(CFG, FEATS, VFEATS, rp.module.apply,
                                        rv.module.apply, n_sim=24,
                                        max_nodes=32)
        port = device_mcts.make_device_mcts(TCFG, FEATS, VFEATS, pp.module,
                                            pv.module, n_sim=24,
                                            max_nodes=32)
        jroots, troots = roots_both()
        b = troots.board.shape[0]
        free_j = jnp.full((b,), -1, jnp.int32)
        free_t = torch.full((b,), -1, dtype=torch.int32)
        pr, vr = ref.eval_batch(rp.params, rv.params, jroots)
        tree_r = ref.assemble_tree(jroots, pr)
        tree_p = port.assemble_tree(troots, torch.as_tensor(np.array(pr)))
        worst = 0.0
        for sim in range(40):              # the slab fills at 32
            ctx_r = ref.prepare_sim(tree_r, free_j)
            ctx_p = port.prepare_sim(tree_p, free_t)
            assert_ctx(ctx_p, ctx_r, sim)
            pr, vr = ref.eval_batch(rp.params, rv.params, ctx_r.eval_states)
            pp_, vp_ = port.eval_batch(ctx_p.eval_states)
            worst = max(worst, float(np.abs(pp_.numpy() - pr).max()),
                        float(np.abs(vp_.numpy() - vr).max()))
            tree_r = ref.apply_sim(tree_r, ctx_r, pr, vr)
            port.apply_sim(tree_p, ctx_p, torch.as_tensor(np.array(pr)),
                           torch.as_tensor(np.array(vr)))
    assert_trees(tree_p, tree_r)
    assert int(tree_p.n_nodes.max()) == 32
    assert worst <= EVAL_ATOL


def test_plain_walks_are_the_reference_loops():
    """descend_plain and backup_plain against the reference's
    _descend_one and _backup_one (through its prepare_sim and
    apply_sim), with a forced first edge on some games."""
    check_plain_walks()


def test_plain_walks_with_forced_playouts():
    """As above with forced playouts at the root (the reference's
    _select_action_root): a small c_puct follows the values, so the root
    floors decide some descents."""
    check_plain_walks(c_puct=0.3, forced_k=2.0)


def check_plain_walks(c_puct=5.0, forced_k=0.0):
    ref = ref_searcher(c_puct=c_puct, forced_k=forced_k)
    jroots, _ = roots_both()
    b = jroots.board.shape[0]
    rng = np.random.default_rng(9)
    floors_decided = 0
    with jax.enable_checks(False):
        tree = ref.init(None, None, jroots)
        for sim in range(24):
            forced = np.where(rng.random(b) < 0.5,
                              rng.integers(0, N + 1, b), -1).astype(np.int32)
            ctx = ref.prepare_sim(tree, jnp.asarray(forced))
            t = {k: torch.as_tensor(np.array(getattr(tree, k)))
                 for k in ("prior", "visits", "value_sum", "child",
                           "parent", "paction", "root")}
            done = torch.as_tensor(np.array(tree.states.done))
            node, action = tree_ops.descend_plain(
                t["prior"], t["visits"], t["value_sum"], t["child"], done,
                t["root"], torch.as_tensor(forced), c_puct, forced_k)
            eq(node.numpy(), ctx.node, f"sim {sim}: node")
            if forced_k:
                plain = tree_ops.descend_plain(
                    t["prior"], t["visits"], t["value_sum"], t["child"],
                    done, t["root"], torch.as_tensor(forced), c_puct)
                floors_decided += int((plain[0] != node).sum())
            exp = np.array(ctx.expanding)
            eq(action.numpy(), np.where(exp, ctx.safe_action, -1),
               f"sim {sim}: action")
            pr, vr = ref.eval_batch(None, None, ctx.eval_states)
            new = ref.apply_sim(tree, ctx, pr, vr)
            start_n = torch.where(torch.as_tensor(exp), node,
                                  t["parent"][torch.arange(b), node.long()])
            start_a = torch.where(torch.as_tensor(exp), action,
                                  t["paction"][torch.arange(b),
                                               node.long()])
            visits, vsum = tree_ops.backup_plain(
                t["visits"].clone(), t["value_sum"].clone(),
                torch.as_tensor(np.array(new.parent)),
                torch.as_tensor(np.array(new.paction)), start_n, start_a,
                torch.as_tensor(np.array(vr)))
            eq(visits.numpy(), new.visits, f"sim {sim}: visits")
            eq(vsum.numpy(), new.value_sum, f"sim {sim}: value_sum")
            tree = new
    assert (floors_decided > 0) == bool(forced_k)


def test_chunked_equals_monolithic_and_deadline_floor():
    port = port_searcher()
    _, troots = roots_both()
    v_mono, q_mono = port(troots)
    tree = port.init(troots)
    kept = device_mcts.copy_tree(tree)
    for k in (5, 5, 5, 5, 5, 5, 2):
        tree = port.run_sims(tree, k)
    v, q = port.root_stats(tree)
    eq(v.numpy(), v_mono.numpy(), "visits")
    eq(q.numpy(), q_mono.numpy(), "q")
    v, q = port.run_chunked(troots, chunk=8)
    eq(v.numpy(), v_mono.numpy(), "chunked visits")
    assert port.last_ran == 32
    # run_sims and a non-owned chunked run leave the caller's tree alone
    port.run_sims_chunked(kept, 8, n=8)
    assert int(kept.visits.sum()) == 0
    # an expired deadline still searches one chunk (the anytime floor)
    t2, ran = port.run_sims_chunked(kept, 4, n=16,
                                    deadline=Deadline.after(0.0))
    assert ran == 4
    np.testing.assert_array_equal(port.root_stats(t2)[0].sum(1).numpy()
                                  [:2], 4)


def test_advance_root_follows_child_edges():
    port = port_searcher()
    roots = torchgo.new_states(TCFG, 1, device="cpu")
    tree = port.run_sims(port.init(roots), 16)
    visits0, _ = port.root_stats(tree)
    a = int(visits0[0].argmax())
    child_idx = int(tree.child[0, 0, a])
    assert child_idx >= 0
    tree2, ok = port.advance_root(tree, torch.tensor([a]))
    assert bool(ok[0]) and int(tree2.root[0]) == child_idx
    v_child = tree.visits[0, child_idx].clone()
    eq(port.root_stats(tree2)[0][0].numpy(), v_child.numpy(), "child")
    tree3 = port.run_sims(tree2, 8)
    assert int(port.root_stats(tree3)[0].sum()) == int(v_child.sum()) + 8
    unvisited = int(torch.argmin((tree.child[0, 0] >= 0).int()))
    _, ok2 = port.advance_root(tree, torch.tensor([unvisited]))
    assert not bool(ok2[0])


@pytest.mark.parametrize("what", ["tiny_slab", "terminal_root"])
def test_tiny_slab_and_terminal_root_match_reference(what):
    if what == "tiny_slab":
        sts, n_sim, m = positions()[:2], 24, 4
    else:
        sts = []
        for seed in (1, 2):
            st = exhausted(seed)
            st.do_move(None)
            assert st.is_end_of_game
            sts.append(st)
        n_sim, m = 8, 8
    jroots, troots = roots_both(sts)
    with jax.enable_checks(False):
        want = ref_searcher(n_sim, m)(None, None, jroots)
    got = port_searcher(n_sim, m)(troots)
    eq(got[0].numpy(), want[0], "visits")
    eq(got[1].numpy(), want[1], "q")
    total = got[0].numpy().sum(axis=1)
    np.testing.assert_array_equal(total, n_sim if what == "tiny_slab"
                                  else 0)


def test_player_plays_the_reference_moves():
    """A scripted 5×5 game on 2×4 nets carried across: the port's
    player and the reference's (scratch root encode) choose the same
    moves, reuse their subtree on the same moves, rebuild after an
    unexpanded reply and after a reset. (At one layer the trunk is
    empty, every point of a position scores alike, and which of the
    tied moves a search prefers is float32 rounding noise; one
    convolution breaks the ties.)"""
    with jax.enable_checks(False):
        rp, rv, pp, pv = small_nets(layers=2)
        ref = ref_mcts.DeviceMCTSPlayer(rv, rp, n_sim=32, max_nodes=128,
                                        sim_chunk=8, incremental=False)
        port = device_mcts.DeviceMCTSPlayer(pv, pp, n_sim=32, max_nodes=128,
                                            sim_chunk=8)
        st_r, st_p = pygo.GameState(size=SIZE), tpygo.GameState(size=SIZE)
        moves = []

        def both():
            mv_r, mv_p = ref.get_move(st_r), port.get_move(st_p)
            assert mv_p == mv_r, (len(moves), mv_p, mv_r)
            assert port.reuses == ref.reuses
            assert port.last_n_sim == ref.last_n_sim == 32
            moves.append(mv_p)
            return mv_p

        for _ in range(6):
            mv = both()
            st_r.do_move(mv)
            st_p.do_move(mv)
        reused = port.reuses
        assert reused >= 3
        st_r.do_move(None)              # a reply the search never
        st_p.do_move(None)              # expanded: a fresh tree
        both()
        assert port.reuses == reused
        reset_player(port)
        ref.reset()
        st_r, st_p = pygo.GameState(size=SIZE), tpygo.GameState(size=SIZE)
        both()
        assert port.reuses == reused
    assert len(set(moves)) > 2


def test_move_clock_and_player_budget():
    clock = MoveClock()
    clock.set_move_time(1.0)
    assert clock.allowed_units() is None          # no rate yet
    clock.note("k", 100, 1.0)                     # a key's first run
    assert clock.rate is None
    clock.note("k", 100, 0.5)
    assert clock.rate == 200.0 and clock.allowed_units() == 200
    _, _, pp, pv = small_nets()
    player = device_mcts.DeviceMCTSPlayer(pv, pp, n_sim=32, sim_chunk=8)
    player._clock.rate = 20.0
    player.set_move_time(0.5)                     # 10 sims: one chunk
    assert player._effective_sims() == 8
    player.set_move_time(100.0)
    assert player._effective_sims() == 32
    player.sim_limit = 17
    assert player._effective_sims() == 16
    # the Gumbel player halves n_sim into tiers instead
    # (tests/test_torch_gumbel.py holds them to the reference's)
    gumbel = device_mcts.DeviceMCTSPlayer(pv, pp, n_sim=32, sim_chunk=8,
                                          gumbel=True)
    gumbel._clock.rate = 20.0
    gumbel.set_move_time(0.5)                     # 10 sims: the plan's
    assert gumbel._effective_sims() == 8          # floor, 30 sims
    gumbel.set_move_time(100.0)
    assert gumbel._effective_sims() == 32
