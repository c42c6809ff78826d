"""Self-play economics in the port against the reference, on the CPU:
the per-row simulation budgets of the device search (PUCT and Gumbel),
the playout-cap draws of search self-play, and the value net's
auxiliary heads.

The reference's fakes at 5×5 (uniform logits; a stone-count value)
drive both packages, so every evaluation is exact and trees grown
under mixed budgets are bit-identical slab for slab. The budget draws
are compared by handing the reference's uniforms to the port
(``MCTSSelfplay.budget_from``; a Bernoulli draw is ``u < p``) and its
actions to the port's sampler. Tolerances: trees, visits, ``full``
masks and states exact; π′ within ``TARGET_ATOL``; the auxiliary
forward within ``AUX_ATOL`` (float32, summation order only).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.engine import jaxgo
from rocalphago_tpu.models import CNNValue as RefValue
from rocalphago_tpu.search import device_mcts as ref_mcts
from rocalphago_tpu_torch.engine import pygo as tpygo
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.models import CNNValue
from rocalphago_tpu_torch.models.value import with_aux_heads
from rocalphago_tpu_torch.models.weights import params_from_flax
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
BATCH = 4
BUDGET = (4, 16, 9, 1)
M_ROOT = 8
TARGET_ATOL = 1e-6
AUX_ATOL = 1e-5


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


# a position-weighted stone count (integer weights over a power of two,
# so both packages' sums are exact in any order): unlike the plain
# count, the first ply's children differ in value, so π′'s rescaled q̂
# is well conditioned there
WEIGHTS = np.arange(1, N + 1, dtype=np.float32).reshape(SIZE, SIZE)


def fake_value_w(params, planes):
    w = jnp.asarray(WEIGHTS)
    return ((planes[..., 0] * w).sum(axis=(1, 2))
            - (planes[..., 1] * w).sum(axis=(1, 2))) / 512.0


def port_value_w(planes):
    w = torch.as_tensor(WEIGHTS)
    return ((planes[..., 0] * w).sum(dim=(1, 2))
            - (planes[..., 1] * w).sum(dim=(1, 2))) / 512.0


def eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got).astype(np.float64),
                                  np.asarray(want).astype(np.float64),
                                  err_msg=what)


def assert_trees(got, want):
    for name in jaxgo.GoState._fields:
        eq(getattr(got.states, name).numpy(), getattr(want.states, name),
           f"node states: {name}")
    for name in device_mcts.DeviceTree._fields[1:]:
        eq(getattr(got, name).numpy(), getattr(want, name), name)


@functools.lru_cache(maxsize=None)
def positions():
    return random_games(SIZE, BATCH, 0, 12, seed=11)


def roots_both():
    sts = positions()
    return jax_states(CFG, sts), torch_states(SIZE, sts)


# ------------------------------------------------- budget-masked trees


@pytest.mark.parametrize("chunk", [5, 16])
def test_puct_budget_trees_are_the_references(chunk):
    """Mixed per-row budgets: the whole slab (states, priors, visits,
    values, children, parents, node counts) equals the reference's
    ``run_sims_chunked(n=max, budget=)``; each row's root visits sum to
    its budget, and a full-budget row equals an unmasked run's."""
    jroots, troots = roots_both()
    budget = np.array(BUDGET, np.int32)
    n = int(budget.max())
    with jax.enable_checks(False):
        ref = ref_mcts.make_device_mcts(CFG, FEATS, VFEATS, fake_policy,
                                        fake_value, n_sim=16, max_nodes=32)
        tree_r = ref.init(None, None, jroots)
        tree_r, ran_r = ref.run_sims_chunked(
            None, None, tree_r, chunk, n=n, owned=True,
            budget=jnp.asarray(budget))
        tree_r = jax.tree.map(np.asarray, tree_r)
    port = device_mcts.make_device_mcts(TCFG, FEATS, VFEATS, port_policy,
                                        port_value, n_sim=16, max_nodes=32)
    tree_p, ran_p = port.run_sims_chunked(
        port.init(troots), chunk, n=n, owned=True,
        budget=torch.as_tensor(budget))
    assert ran_p == ran_r == n
    assert_trees(tree_p, tree_r)
    visits, _ = port.root_stats(tree_p)
    eq(visits.sum(1).numpy(), budget, "root visits per row")
    plain, _ = port.run_sims_chunked(port.init(troots), chunk, n=n,
                                     owned=True)
    full = int(np.argmax(budget))
    for name in device_mcts.DeviceTree._fields[1:]:
        assert torch.equal(getattr(tree_p, name)[full],
                           getattr(plain, name)[full]), name


def test_puct_full_budget_is_the_plain_run():
    _, troots = roots_both()
    port = device_mcts.make_device_mcts(TCFG, FEATS, VFEATS, port_policy,
                                        port_value, n_sim=16, max_nodes=32)
    a = port.run_chunked(troots, 5)
    b = port.run_chunked(troots, 5,
                         budget=torch.full((BATCH,), 16, dtype=torch.int32))
    assert port.last_ran == 16
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n", [None, 11])
def test_gumbel_budget_search_is_the_references(n):
    """The Gumbel plan under per-row budgets (global sims across the
    halving phases, ``n`` truncating it): visits, q and ``best`` equal
    the reference's, π′ within ``TARGET_ATOL``."""
    jroots, troots = roots_both()
    budget = np.array(BUDGET, np.int32)
    key = jax.random.key(5)
    noise = np.array(jax.random.gumbel(key, (BATCH, A), jnp.float32))
    with jax.enable_checks(False):
        ref = ref_mcts.make_gumbel_mcts(CFG, FEATS, VFEATS, fake_policy,
                                        fake_value, n_sim=16, m_root=M_ROOT)
        want = jax.tree.map(np.asarray, ref.run_chunked(
            None, None, jroots, key, 8, n=n, budget=jnp.asarray(budget)))
        ran_r = ref.last_ran
    port = device_mcts.make_gumbel_mcts(TCFG, FEATS, VFEATS, port_policy,
                                        port_value, n_sim=16, m_root=M_ROOT)
    got = port.run_chunked(troots, 8, noise=torch.as_tensor(noise), n=n,
                           budget=torch.as_tensor(budget))
    assert port.last_ran == ran_r
    for name, x, y in zip(("visits", "q", "best"), got, want):
        eq(x.numpy(), y, name)
    assert float(np.abs(got[3].numpy() - want[3]).max()) <= TARGET_ATOL
    eq(got[0].sum(1).numpy(), np.minimum(budget, port.last_ran),
       "root visits per row")


# ------------------------------------------------ playout-cap self-play


def port_selfplay(**kw):
    return device_mcts.make_mcts_selfplay(
        TCFG, FEATS, VFEATS, port_policy, port_value, batch=2, max_moves=6,
        n_sim=8, max_nodes=16, sim_chunk=4, record_visits=True,
        device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(cap_p=0.0, cap_cheap=1),
    dict(cap_p=0.5, cap_cheap=8),          # cheap == n_sim: caps off
    dict(cap_p=0.0, forced_k=0.0)])
def test_flags_off_is_the_plain_runner(kw):
    """Disabled caps draw nothing: the games, the targets and the
    generator's state are the plain runner's, and no ``full`` mask is
    appended."""
    outs = []
    for extra in ({}, kw):
        run = port_selfplay(**extra)
        g = torch.Generator().manual_seed(4)
        outs.append((run(g), g.get_state()))
        assert not run.econ
    (a, ga), (b, gb) = outs
    assert len(a) == len(b) == 4
    assert torch.equal(ga, gb)
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)


def reference_cap_run(cap_per_row, gumbel):
    """The reference's capped self-play from key 7: its outputs and each
    ply's budget uniforms and Gumbel draws, off its key chain (a split
    for the budget, a split for the Gumbel root draw, a split for each
    sampled move)."""
    key = jax.random.key(7)
    with jax.enable_checks(False):
        run = ref_mcts.make_mcts_selfplay(
            CFG, FEATS, VFEATS, fake_policy, fake_value_w, batch=BATCH,
            max_moves=8, n_sim=8, max_nodes=16, sim_chunk=4,
            record_visits=True, gumbel=gumbel, m_root=M_ROOT, cap_p=0.5,
            cap_cheap=2, cap_per_row=cap_per_row)
        out = jax.tree.map(np.asarray, run(None, None, key))
    us, draws, rng = [], [], key
    for _ in range(len(out[1])):
        rng, sub_b = jax.random.split(rng)
        us.append(np.array(jax.random.uniform(
            sub_b, (BATCH,) if cap_per_row else ())).reshape(-1))
        if gumbel:
            rng, sub = jax.random.split(rng)
            draws.append(np.array(jax.random.gumbel(sub, (BATCH, A),
                                                    jnp.float32)))
        else:
            rng, _ = jax.random.split(rng)
    return out, us, draws


@pytest.mark.parametrize("cap_per_row,gumbel", [
    (False, False), (True, False), (True, True)])
def test_cap_draws_give_the_references_full(monkeypatch, cap_per_row,
                                            gumbel):
    """The reference's budget uniforms through the port's rule give its
    ``full`` mask (shared across the batch, or per game); with its
    moves replayed (PUCT) or its root draws (Gumbel, playing the
    halving winner), the capped searches give its visits (π′ within
    ``TARGET_ATOL``), moves, live rows and final states."""
    (final, actions, live, targets, full), us, draws = reference_cap_run(
        cap_per_row, gumbel)
    assert full.any() and not full.all()
    if cap_per_row:
        assert (full.any(1) & ~full.all(1)).any(), "no mixed ply"
    else:
        assert (full.all(1) | ~full.any(1)).all()
    feed = {"u": iter(us), "noise": iter(draws), "a": iter(actions)}
    cls = device_mcts.MCTSSelfplay
    monkeypatch.setattr(cls, "draw_budget", lambda self, g: self.budget_from(
        torch.as_tensor(next(feed["u"]))))
    monkeypatch.setattr(cls, "draw_noise", lambda self, g: torch.as_tensor(
        next(feed["noise"])))
    monkeypatch.setattr(cls, "sample_weighted", lambda self, w, g:
                        torch.as_tensor(next(feed["a"]).copy()))
    run = device_mcts.make_mcts_selfplay(
        TCFG, FEATS, VFEATS, port_policy, port_value_w, batch=BATCH,
        max_moves=8, n_sim=8, max_nodes=16, sim_chunk=4, record_visits=True,
        gumbel=gumbel, m_root=M_ROOT, cap_p=0.5, cap_cheap=2,
        cap_per_row=cap_per_row, device="cpu")
    st, acts, lv, tg, fl = run(torch.Generator())
    eq(fl.numpy(), full, "full")
    eq(acts.numpy(), actions, "actions")
    eq(lv.numpy(), live, "live")
    if gumbel:
        assert float(np.abs(tg.numpy() - targets).max()) <= TARGET_ATOL
    else:
        eq(tg.numpy(), targets, "visits")
    for name in jaxgo.GoState._fields:
        eq(getattr(st, name).numpy(), getattr(final, name), name)
    assert run.last_full_frac == pytest.approx(float(full.mean()))


# ------------------------------------------------------- aux heads


@functools.lru_cache(maxsize=None)
def aux_nets():
    ref = RefValue(VFEATS, board=SIZE, layers=2, filters_per_layer=8,
                   aux_heads=("ownership", "score"), seed=9)
    ref.module = ref.module.clone(dtype=jnp.float32)
    port = CNNValue(VFEATS, board=SIZE, layers=2, filters_per_layer=8,
                    aux_heads=("ownership", "score"), init_weights=False,
                    device="cpu", dtype=torch.float32)
    port.module.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, ref.params)))
    return ref, port


def test_aux_forward_is_the_references():
    ref, port = aux_nets()
    planes = port._states_to_planes(positions())
    v_r, aux_r = ref.module.apply(ref.params, jnp.asarray(planes.numpy()),
                                  with_aux=True)
    v_p, aux_p = port.module(planes, with_aux=True)
    assert set(aux_p) == {"ownership", "score"}
    assert aux_p["ownership"].shape == (BATCH, N)
    assert aux_p["score"].shape == (BATCH,)
    np.testing.assert_allclose(v_p.detach().numpy(), np.asarray(v_r),
                               atol=AUX_ATOL)
    for k in ("ownership", "score"):
        np.testing.assert_allclose(aux_p[k].detach().numpy(),
                                   np.asarray(aux_r[k]), atol=AUX_ATOL,
                                   err_msg=k)
    # the value-only forward is the aux forward's value, bit for bit
    assert torch.equal(port.module(planes), v_p)
    v_f, aux_f = port.forward_aux(planes)
    assert torch.equal(v_f, v_p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aux_graft_keeps_the_value_bit_identical(dtype):
    val = CNNValue(VFEATS, board=SIZE, layers=2, filters_per_layer=8,
                   seed=4, device="cpu", dtype=dtype)
    grown = with_aux_heads(val, seed=3)
    assert grown.module.aux_heads == ("ownership", "score")
    assert grown.spec_kwargs["aux_heads"] == ("ownership", "score")
    st = tpygo.GameState(size=SIZE)
    st.do_move((1, 1), tpygo.BLACK)
    v0 = val.batch_eval_state([st])
    v1 = grown.batch_eval_state([st])
    np.testing.assert_array_equal(v0, v1)
    planes = grown._states_to_planes([st])
    v, aux = grown.forward_aux(planes)
    assert torch.equal(v, grown.forward(planes))
    assert aux["ownership"].shape == (1, N)
    assert bool((aux["ownership"].abs() <= 1.0).all())
    assert aux["score"].shape == (1,)
    # the graft copies: training the grown net leaves the source alone
    with torch.no_grad():
        next(grown.module.parameters()).add_(1.0)
    np.testing.assert_array_equal(val.batch_eval_state([st]), v0)
    with pytest.raises(ValueError, match="aux heads"):
        CNNValue.create_network(board=SIZE, aux_heads=("bogus",))
