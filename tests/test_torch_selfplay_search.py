"""The port's search self-play (``make_mcts_selfplay`` in
``rocalphago_tpu_torch/search/device_mcts.py``), forced playouts, the
pruned policy targets and the root noise, against the reference's, on
the CPU.

The reference's fakes at 5×5 (uniform logits; a stone-count value)
drive both packages, so every evaluation is exact and the trees are
bit-identical. The reference's self-play runs with its own draws; its
actions are replayed through the port's per-ply search and rules step.
Tolerances: visits, trees and states exact; pruned targets within
``TARGET_ATOL``; the root-noise mix within ``NOISE_ATOL`` of the
reference's formula on the same gamma draws.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.engine import jaxgo
from rocalphago_tpu.search import device_mcts as ref_mcts
from rocalphago_tpu_torch.engine import torchgo
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
FEATS = ("board", "ones")
VFEATS = FEATS + ("color",)
CFG = jaxgo.GoConfig(size=SIZE)
TCFG = torchgo.GoConfig(size=SIZE)
BATCH = 4
MAX_MOVES = 10
N_SIM = 16
FORCED_K = 2.0
ALPHA, EPS = 0.03, 0.25
TARGET_ATOL = 1e-6
NOISE_ATOL = 1e-6


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


def assert_states(got, want, what):
    for name in jaxgo.GoState._fields:
        eq(getattr(got, name).numpy(), getattr(want, name),
           f"{what}: {name}")


def port_selfplay(**kw):
    return device_mcts.make_mcts_selfplay(
        TCFG, FEATS, VFEATS, port_policy, port_value, batch=BATCH,
        max_moves=MAX_MOVES, n_sim=N_SIM, sim_chunk=8, record_visits=True,
        device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def reference_selfplay(forced_k=0.0):
    """The reference's search self-play: ``(final, actions, live,
    targets)`` as numpy."""
    with jax.enable_checks(False):
        run = ref_mcts.make_mcts_selfplay(
            CFG, FEATS, VFEATS, fake_policy, fake_value, batch=BATCH,
            max_moves=MAX_MOVES, n_sim=N_SIM, sim_chunk=8,
            record_visits=True, forced_k=forced_k)
        out = run(None, None, jax.random.key(0))
    return jax.tree.map(np.asarray, out)


def replay(forced_k=0.0):
    """Replay the reference's self-play actions through the port's
    per-ply search: per ply, the port's target against the reference's
    recorded one and the states after the step."""
    final, actions, live, targets = reference_selfplay(forced_k)
    run = port_selfplay(forced_k=forced_k)
    st = torchgo.new_states(TCFG, BATCH, device="cpu")
    g = torch.Generator().manual_seed(0)
    worst = 0.0
    for t in range(len(actions)):
        visits, target = run.search_ply(st)
        if forced_k:
            assert target.dtype == torch.float32
            worst = max(worst, float(np.abs(target.numpy()
                                            - targets[t]).max()))
        else:
            assert target.dtype == torch.int32
            eq(target.numpy(), targets[t], f"ply {t}: root visits")
        live_t = ~st.done
        eq(live_t.numpy(), live[t], f"ply {t}: live")
        # the port's own draw lands on a visited edge
        _, mine, _ = run.pick_and_step(st, visits, g)
        assert bool((visits.gather(1, mine.long()[:, None]) > 0)[live_t]
                    .all())
        st = torchgo.step(TCFG, st, torch.as_tensor(actions[t].copy()))
    assert_states(st, final, "final")
    return worst, len(actions)


@pytest.mark.parametrize("forced_k", [0.0, FORCED_K])
def test_search_selfplay_replays_the_reference(forced_k):
    worst, plies = replay(forced_k=forced_k)
    assert plies == MAX_MOVES
    assert worst <= TARGET_ATOL


def test_search_selfplay_with_root_noise():
    """The port's own noisy self-play: every live root searched in full,
    the move on a visited edge, the noise changing the searches. (Its
    visits are not held to the reference's: the mix rounds differently
    from XLA's compiled one in the last place, and PUCT ties follow.)"""
    runs = []
    for alpha in (ALPHA, 0.0):
        run = port_selfplay(dirichlet_alpha=alpha, noise_frac=EPS)
        final, actions, live, visits = run(torch.Generator().manual_seed(3),
                                           np.random.default_rng(3))
        assert visits.shape == (MAX_MOVES, BATCH, N + 1)
        eq(visits.sum(-1)[live].numpy(), N_SIM, "visits per live root")
        picked = visits.gather(2, actions.long()[..., None])[..., 0]
        assert bool((picked[live] > 0).all())
        runs.append(visits)
    assert not torch.equal(*runs)


def test_root_noise_mix_is_the_references_formula():
    run = port_selfplay(dirichlet_alpha=ALPHA, noise_frac=EPS)
    sts = random_games(SIZE, BATCH, 0, 12, seed=4)
    tree = run.search.init(torch_states(SIZE, sts))
    p0 = tree.prior[:, 0].clone()
    gamma = np.random.default_rng(2).gamma(ALPHA, size=(BATCH, N + 1))
    gamma[0] = 0.0                                # every draw underflowed
    gamma = gamma.astype(np.float32)
    run.add_root_noise(tree, torch.as_tensor(gamma))

    @jax.jit
    def reference_mix(p0, gam):       # rocalphago_tpu device_mcts.py:1653
        valid = p0 > 0
        gam = jnp.where(valid, gam, 0.0)
        dirichlet = gam / jnp.maximum(gam.sum(axis=-1, keepdims=True),
                                      1e-12)
        return jnp.where(valid, (1.0 - EPS) * p0 + EPS * dirichlet, 0.0)

    want = np.asarray(reference_mix(p0.numpy(), gamma))
    got = tree.prior[:, 0].numpy()
    assert float(np.abs(got - want).max()) <= NOISE_ATOL
    eq(got > 0, p0.numpy() > 0, "support")
    np.testing.assert_allclose(got[1:].sum(1), 1.0, atol=1e-5)
    eq(got[0], (1.0 - EPS) * p0[0].numpy(), "no noise mass")
    with pytest.raises(ValueError, match="noise_rng"):
        run(torch.Generator())


def test_forced_playouts_grow_the_references_trees():
    """forced_k > 0: every simulation's descent and the whole tree are
    the reference's; the pruned targets agree within TARGET_ATOL and the
    root visits exactly. A small ``c_puct`` follows the values, so the
    floors do change the trees."""
    sts = random_games(SIZE, BATCH, 0, 14, seed=6)
    jroots, troots = jax_states(CFG, sts), torch_states(SIZE, sts)
    free_j = jnp.full((BATCH,), -1, jnp.int32)
    free_t = torch.full((BATCH,), -1, dtype=torch.int32)
    visits_by_k = []
    for k in (FORCED_K, 0.0):
        ref = ref_mcts.make_device_mcts(CFG, FEATS, VFEATS, fake_policy,
                                        fake_value, n_sim=48, max_nodes=64,
                                        c_puct=0.2, forced_k=k)
        port = device_mcts.make_device_mcts(TCFG, FEATS, VFEATS,
                                            port_policy, port_value,
                                            n_sim=48, max_nodes=64,
                                            c_puct=0.2, forced_k=k)
        with jax.enable_checks(False):
            tree_r = ref.init(None, None, jroots)
            tree_p = port.init(troots)
            for sim in range(48):
                ctx_r = ref.prepare_sim(tree_r, free_j)
                ctx_p = port.prepare_sim(tree_p, free_t)
                eq(ctx_p.node.numpy(), ctx_r.node, f"sim {sim}: node")
                eq(ctx_p.safe_action.numpy(), ctx_r.safe_action,
                   f"sim {sim}: action")
                pr, vr = ref.eval_batch(None, None, ctx_r.eval_states)
                tree_r = ref.apply_sim(tree_r, ctx_r, pr, vr)
                port.apply_sim(tree_p, ctx_p, *port.eval_batch(
                    ctx_p.eval_states))
            target_r, pruned_r = ref.pruned_targets(tree_r)
        for name in device_mcts.DeviceTree._fields[1:]:
            eq(getattr(tree_p, name).numpy(), getattr(tree_r, name), name)
        target, pruned = port.pruned_targets(tree_p)
        assert float(np.abs(target.numpy() - target_r).max()) <= TARGET_ATOL
        eq(pruned.numpy(), pruned_r, "pruned visits")
        visits, _ = port.root_stats(tree_p)
        eq(visits.numpy(), ref.root_stats(tree_r)[0], "root visits")
        np.testing.assert_allclose(target.sum(1).numpy(), 1.0, atol=1e-6)
        assert (int(pruned.sum()) > 0) == bool(k)
        visits_by_k.append(visits)
    assert not torch.equal(*visits_by_k)
