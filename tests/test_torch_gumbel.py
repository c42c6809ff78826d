"""The port's Gumbel root search (``GumbelMCTS``, ``make_gumbel_mcts``
and the Gumbel ``DeviceMCTSPlayer`` in ``rocalphago_tpu_torch/search/
device_mcts.py``) against the reference's, on the CPU.

Torch cannot reproduce JAX's random streams, so the reference's own
draws (``jax.random.gumbel`` on its keys) are handed to the port through
its ``noise=`` seam. With the reference's fakes at 5×5 (uniform logits,
a stone-count value) every evaluation is exact: the integer slabs,
``n_nodes``, the valid candidates after every rerank and ``best`` are
bit-identical, and ``g``, the float slabs and π′ agree within
``FLOAT_ATOL``. With small nets carried across, the reference's
evaluations are fed into the port's ``apply_sim`` (the port's own agree
within ``EVAL_ATOL``, float32 summation order) and the same holds.
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
from rocalphago_tpu_torch.runtime.deadline import Deadline
from rocalphago_tpu_torch.search import device_mcts
from torch_port_helpers import (  # noqa: F401
    jax_states,
    one_torch_thread,
    random_games,
    torch_states,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 5
N = SIZE * SIZE
A = N + 1
FEATS = ("board", "ones")
VFEATS = FEATS + ("color",)
CFG = jaxgo.GoConfig(size=SIZE)
TCFG = torchgo.GoConfig(size=SIZE)
N_SIM = 24
M_ROOT = 16
FLOAT_ATOL = 1e-5
EVAL_ATOL = 1e-5
NEG = float(np.finfo(np.float32).min)


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


def eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got).astype(np.float64),
                                  np.asarray(want).astype(np.float64),
                                  err_msg=what)


def close(got, want, what, atol=FLOAT_ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol, err_msg=what)


def exhausted(seed):
    """A 5×5 game played with random sensible moves until the side to
    move has none: only pass is sensible there."""
    rng = np.random.default_rng(seed)
    st = pygo.GameState(size=SIZE)
    while True:
        moves = st.get_legal_moves(include_eyes=False)
        if not moves:
            return st
        st.do_move(moves[rng.integers(len(moves))])


@functools.lru_cache(maxsize=None)
def positions():
    """Batch 4: an empty board, two random games, and a position with
    fewer sensible moves than ``M_ROOT`` (only pass)."""
    return ([pygo.GameState(size=SIZE)] + random_games(SIZE, 2, 6, 14,
                                                       seed=7)
            + [exhausted(2)])


def roots_both():
    sts = positions()
    return jax_states(CFG, sts), torch_states(SIZE, sts)


@functools.lru_cache(maxsize=None)
def reference_noise(seed=3, batch=4):
    """The reference's key and its Gumbel draw ``[batch, A]``."""
    key = jax.random.key(seed)
    return key, np.array(jax.random.gumbel(key, (batch, A), jnp.float32))


@functools.lru_cache(maxsize=None)
def ref_gumbel(n_sim=N_SIM, m_root=M_ROOT):
    return ref_mcts.make_gumbel_mcts(CFG, FEATS, VFEATS, fake_policy,
                                     fake_value, n_sim=n_sim, m_root=m_root)


def port_gumbel(n_sim=N_SIM, m_root=M_ROOT):
    return device_mcts.make_gumbel_mcts(TCFG, FEATS, VFEATS, port_policy,
                                        port_value, n_sim=n_sim,
                                        m_root=m_root)


def valid_slots(g, cand):
    """Bool ``[B, m]``: candidate slots on a prior-supported action."""
    g, cand = np.asarray(g), np.asarray(cand)
    return np.take_along_axis(g, cand, axis=1) > NEG / 2


def assert_candidates(got, want, g, what):
    got, want = got.numpy(), np.asarray(want)
    valid = valid_slots(g, want)
    eq(valid_slots(g, got), valid, f"{what}: valid slots")
    eq(got[valid], want[valid], f"{what}: valid candidates")
    eq(got[:, 0], want[:, 0], f"{what}: best")


def assert_trees(got, want, what):
    for name in jaxgo.GoState._fields:
        eq(getattr(got.states, name).numpy(), getattr(want.states, name),
           f"{what}: states.{name}")
    for name in ("visits", "child", "parent", "paction", "n_nodes", "root"):
        eq(getattr(got, name).numpy(), getattr(want, name),
           f"{what}: {name}")
    for name in ("prior", "value_sum"):
        close(getattr(got, name).numpy(), getattr(want, name),
              f"{what}: {name}")


# ------------------------------------------------------------ the plan


@pytest.mark.parametrize("num_actions", [26, 362])
def test_halving_plan_is_the_references(num_actions):
    for n_sim in range(1, 131):
        for m in range(2, 33):
            assert (device_mcts._halving_schedule(n_sim, m)
                    == ref_mcts._halving_schedule(n_sim, m)), (n_sim, m)
            assert (device_mcts.gumbel_plan_sims(n_sim, m, num_actions)
                    == ref_mcts.gumbel_plan_sims(n_sim, m, num_actions))
    assert device_mcts._halving_schedule(100, 16) == [
        (16, 1), (8, 3), (4, 6), (2, 18)]
    assert device_mcts.gumbel_plan_sims(100, 16, num_actions) == 100
    assert device_mcts.gumbel_plan_sims(32, 16, num_actions) == 40
    assert device_mcts.gumbel_plan_sims(8, 16, num_actions) == 30


def test_noise_is_standard_gumbel():
    """The port's own draw: finite (u never 0 or 1), and the first two
    moments of a standard Gumbel (mean γ, variance π²/6) over 100,000
    draws."""
    search = port_gumbel()
    noise = search.draw_noise(4000, torch.Generator().manual_seed(0))
    assert noise.shape == (4000, A) and noise.dtype == torch.float32
    assert bool(torch.isfinite(noise).all())
    x = noise.double().flatten()
    assert abs(float(x.mean()) - 0.5772) < 0.01
    assert abs(float(x.var()) - np.pi ** 2 / 6) < 0.03


# ---------------------------------------------------- sim by sim, fakes


def test_search_is_the_reference_sim_by_sim():
    """Every simulation of every phase: the tree after it, the valid
    candidates after every rerank, ``best`` and π′."""
    ref, port = ref_gumbel(), port_gumbel()
    jroots, troots = roots_both()
    key, noise = reference_noise()
    with jax.enable_checks(False):
        tree_r, g_r, cand_r, logits_r = ref.init(None, None, jroots, key)
        tree_p, g_p, cand_p, logits_p = port.init(
            troots, noise=torch.as_tensor(noise))
        close(g_p.numpy(), g_r, "g")
        close(logits_p.numpy(), logits_r, "logits")
        assert_candidates(cand_p, cand_r, g_r, "draw")
        valid = valid_slots(g_r, cand_r)
        assert int(valid.sum(1).min()) < M_ROOT       # a short row
        sims = 0
        for k, v in port.schedule:
            for j in range(k * v):
                tree_r = ref.run_phase(None, None, tree_r, g_r, cand_r,
                                       jnp.int32(j), count=1, k=k)
                port.run_phase(tree_p, g_p, cand_p, j, 1, k)
                sims += 1
                assert_trees(tree_p, tree_r, f"phase {k} sim {j}")
            cand_r = ref.rerank(tree_r, g_r, cand_r, k)
            cand_p = port.rerank(tree_p, g_p, cand_p, k)
            assert_candidates(cand_p, cand_r, g_r, f"rerank {k}")
        pi_r = ref.improved_policy(tree_r, logits_r)
        want = ref(None, None, jroots, key)
    close(port.improved_policy(tree_p, logits_p).numpy(), pi_r, "pi")
    assert sims == device_mcts.gumbel_plan_sims(N_SIM, M_ROOT, A)
    got = port(troots, noise=torch.as_tensor(noise))
    for name, x, y in zip(("visits", "q", "best"), got, want):
        eq(x.numpy(), y, name)
    close(got[3].numpy(), want[3], "pi")
    np.testing.assert_allclose(got[3].sum(1).numpy(), 1.0, atol=1e-6)
    assert int(got[0][-1, :N].sum()) == 0             # only pass there
    assert int(got[2][-1]) == N


def small_nets(layers=2):
    """Reference nets of ``layers`` × 4 and the port's, carried across
    in float32."""
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


def test_reference_evaluations_give_the_same_search():
    """Small nets carried across: the reference's evaluations fed into
    the port's slab writes give the reference's trees, candidates and
    π′ through the whole plan; the port's own evaluations agree within
    ``EVAL_ATOL``."""
    with jax.enable_checks(False):
        rp, rv, pp, pv = small_nets()
        ref = ref_mcts.make_gumbel_mcts(CFG, FEATS, VFEATS, rp.module.apply,
                                        rv.module.apply, n_sim=N_SIM,
                                        m_root=M_ROOT)
        ref_base = ref_mcts.make_device_mcts(
            CFG, FEATS, VFEATS, rp.module.apply, rv.module.apply,
            n_sim=N_SIM, max_nodes=ref.max_nodes)
        port = device_mcts.make_gumbel_mcts(TCFG, FEATS, VFEATS, pp.module,
                                            pv.module, n_sim=N_SIM,
                                            m_root=M_ROOT)
        assert port.max_nodes == ref.max_nodes
        jroots, troots = roots_both()
        key, noise = reference_noise(seed=5)
        tree_r, g_r, cand_r, logits_r = ref.init(rp.params, rv.params,
                                                 jroots, key)
        own = port.base.eval_batch(troots)[0]
        worst = float(np.abs(own.numpy() - np.asarray(tree_r.prior[:, 0]))
                      .max())
        tree_p = port.base.assemble_tree(
            troots, torch.as_tensor(np.array(tree_r.prior[:, 0])))
        g_p, cand_p, logits_p = port.root_draw(tree_p,
                                               torch.as_tensor(noise))
        close(g_p.numpy(), g_r, "g")
        assert_candidates(cand_p, cand_r, g_r, "draw")
        for k, v in port.schedule:
            for j in range(k * v):
                forced = port.forced_candidate(g_p, cand_p, j % k)
                ctx_r = ref_base.prepare_sim(tree_r, jnp.asarray(
                    forced.numpy()))
                ctx_p = port.base.prepare_sim(tree_p, forced)
                eq(ctx_p.node.numpy(), ctx_r.node, f"sim {j}: node")
                eq(ctx_p.safe_action.numpy(), ctx_r.safe_action,
                   f"sim {j}: action")
                pr, vr = ref_base.eval_batch(rp.params, rv.params,
                                             ctx_r.eval_states)
                pp_, vp_ = port.base.eval_batch(ctx_p.eval_states)
                worst = max(worst, float(np.abs(pp_.numpy() - pr).max()),
                            float(np.abs(vp_.numpy() - vr).max()))
                tree_r = ref_base.apply_sim(tree_r, ctx_r, pr, vr)
                port.base.apply_sim(tree_p, ctx_p,
                                    torch.as_tensor(np.array(pr)),
                                    torch.as_tensor(np.array(vr)))
            assert_trees(tree_p, tree_r, f"phase {k}")
            cand_r = ref.rerank(tree_r, g_r, cand_r, k)
            cand_p = port.rerank(tree_p, g_p, cand_p, k)
            assert_candidates(cand_p, cand_r, g_r, f"rerank {k}")
        pi_r = ref.improved_policy(tree_r, logits_r)
    close(port.improved_policy(tree_p, logits_p).numpy(), pi_r, "pi")
    assert worst <= EVAL_ATOL


# ------------------------------------------------------------ driving


def test_chunked_equals_monolithic():
    """Chunks of 3 divide no phase total of the plan (16, 8, 4, 4 at
    n_sim 20)."""
    port = port_gumbel(n_sim=20)
    _, troots = roots_both()
    noise = torch.as_tensor(reference_noise()[1])
    assert all(k * v % 3 for k, v in port.schedule)
    mono = port(troots, noise=noise)
    got = port.run_chunked(troots, 3, noise=noise)
    for name, x, y in zip(("visits", "q", "best", "pi"), got, mono):
        assert torch.equal(x, y), name
    assert port.last_ran == device_mcts.gumbel_plan_sims(20, M_ROOT, A)


@pytest.mark.parametrize("n", [1, 7, 20])
def test_truncation_is_the_references(n):
    """``n=`` cuts the plan where the reference's cuts it, and the cut
    phase is re-ranked (the anytime ``best``)."""
    jroots, troots = roots_both()
    key, noise = reference_noise()
    port = port_gumbel()
    with jax.enable_checks(False):
        ref = ref_gumbel()
        want = ref.run_chunked(None, None, jroots, key, 3, n=n)
        ref_ran = ref.last_ran
    got = port.run_chunked(troots, 3, noise=torch.as_tensor(noise), n=n)
    assert port.last_ran == ref_ran == n
    for name, x, y in zip(("visits", "q", "best"), got, want):
        eq(x.numpy(), y, name)
    close(got[3].numpy(), want[3], "pi")


def test_deadline_runs_one_chunk():
    """An expired deadline still runs the first chunk (the anytime
    floor) and answers as a plan cut after it."""
    port = port_gumbel()
    _, troots = roots_both()
    noise = torch.as_tensor(reference_noise()[1])
    got = port.run_chunked(troots, 3, noise=noise,
                           deadline=Deadline.after(0.0))
    assert port.last_ran == 3
    want = port.run_chunked(troots, 3, noise=noise, n=3)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    eq(got[0].sum(1).numpy()[:3], [3, 3, 3], "visits")


# ------------------------------------------------------------ the player


def reference_player_draws(moves, seed=0):
    """The reference player's per-move draws: its key split once per
    move, a ``[1, A]`` Gumbel draw on the subkey."""
    rng = jax.random.key(seed)
    out = []
    for _ in range(moves):
        rng, sub = jax.random.split(rng)
        out.append(torch.as_tensor(np.array(
            jax.random.gumbel(sub, (1, A), jnp.float32))))
    return out


def test_player_plays_the_reference_moves(monkeypatch):
    """A scripted 5×5 game on 2×4 nets carried across, each move's
    reference draw injected: the same moves, the whole plan run each
    time, never a reused tree."""
    draws = iter(reference_player_draws(8))
    monkeypatch.setattr(device_mcts.GumbelMCTS, "draw_noise",
                        lambda self, batch, generator: next(draws))
    with jax.enable_checks(False):
        rp, rv, pp, pv = small_nets()
        ref = ref_mcts.DeviceMCTSPlayer(rv, rp, n_sim=16, sim_chunk=8,
                                        gumbel=True, m_root=8,
                                        incremental=False)
        port = device_mcts.DeviceMCTSPlayer(pv, pp, n_sim=16, sim_chunk=8,
                                            gumbel=True, m_root=8)
        assert port._max_nodes == ref._max_nodes
        st_r, st_p = pygo.GameState(size=SIZE), tpygo.GameState(size=SIZE)
        moves = []
        for _ in range(8):
            mv_r, mv_p = ref.get_move(st_r), port.get_move(st_p)
            assert mv_p == mv_r, (len(moves), mv_p, mv_r)
            assert port.last_n_sim == ref.last_n_sim == 16
            assert not port.last_deadline_hit
            moves.append(mv_p)
            st_r.do_move(mv_r)
            st_p.do_move(mv_p)
    assert port.reuses == ref.reuses == 0
    assert len(set(moves)) > 2


def test_player_budget_tiers_and_slab():
    """``_effective_sims`` equal to the reference's over a grid of
    allowed simulations; the slab sized from the plan (60 nodes for
    n_sim 8 at 5×5, where ``2 * n_sim`` would be 16); one generator per
    player, seeded."""
    with jax.enable_checks(False):
        rp, rv, pp, pv = small_nets(layers=1)
        for n_sim, m_root in ((100, 16), (16, 4), (8, 16)):
            ref = ref_mcts.DeviceMCTSPlayer(rv, rp, n_sim=n_sim,
                                            gumbel=True, m_root=m_root,
                                            incremental=False)
            port = device_mcts.DeviceMCTSPlayer(pv, pp, n_sim=n_sim,
                                                gumbel=True, m_root=m_root)
            assert port._max_nodes == ref._max_nodes
            for allowed in list(range(1, 130)) + [None]:
                ref.sim_limit = port.sim_limit = allowed
                assert port._effective_sims() == ref._effective_sims(), (
                    n_sim, m_root, allowed)
    player = device_mcts.DeviceMCTSPlayer(pv, pp, n_sim=8, gumbel=True)
    assert player._max_nodes == 60 == 2 * device_mcts.gumbel_plan_sims(
        8, 16, A)
    assert player._generator.initial_seed() == 0
    # a starved clock's tier shares the default searcher's slab
    player = device_mcts.DeviceMCTSPlayer(pv, pp, gumbel=True)
    player.sim_limit = 1
    assert player._effective_sims() == 12
    _, search = player._searcher_for(TCFG.komi, 12)
    assert search.max_nodes == player._max_nodes == 200
