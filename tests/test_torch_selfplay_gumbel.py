"""The port's Gumbel search self-play (``make_mcts_selfplay(gumbel=True)``
in ``rocalphago_tpu_torch/search/device_mcts.py`` and the self-play
CLI's ``--gumbel``) against the reference's, on the CPU.

The reference's fakes at 5×5 (uniform logits; a stone-count value)
drive both packages. The reference's self-play runs with its own key
chain; the port's per-ply search gets each ply's reference draw through
``search_ply(noise=)``. Played as the reference plays (the halving
winner), the actions, live flags and states are bit-identical and the
π′ targets agree within ``TARGET_ATOL``. Under ``gumbel_sample`` the
reference's sampled actions are replayed.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.engine import jaxgo
from rocalphago_tpu.search import device_mcts as ref_mcts
from rocalphago_tpu_torch.data import sgf
from rocalphago_tpu_torch.engine import pygo as tpygo
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.interface import selfplay_cli
from rocalphago_tpu_torch.search import device_mcts
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = os.path.join(ROOT, "results", "zero_r5", "target_compare", "gumbel")
SIZE = 5
N = SIZE * SIZE
A = N + 1
FEATS = ("board", "ones")
VFEATS = FEATS + ("color",)
CFG = jaxgo.GoConfig(size=SIZE)
TCFG = torchgo.GoConfig(size=SIZE)
BATCH = 4
MAX_MOVES = 10
N_SIM = 16
M_ROOT = 8
TARGET_ATOL = 1e-6


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
        gumbel=True, m_root=M_ROOT, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def reference_selfplay(gumbel_sample=False):
    """The reference's Gumbel self-play from ``key(0)``: ``(final,
    actions, live, targets)`` as numpy, and each ply's root draw (its
    key chain: a split for the search, and under ``gumbel_sample`` one
    more for the move)."""
    key = jax.random.key(0)
    with jax.enable_checks(False):
        run = ref_mcts.make_mcts_selfplay(
            CFG, FEATS, VFEATS, fake_policy, fake_value, batch=BATCH,
            max_moves=MAX_MOVES, n_sim=N_SIM, sim_chunk=8,
            record_visits=True, gumbel=True, m_root=M_ROOT,
            gumbel_sample=gumbel_sample)
        out = jax.tree.map(np.asarray, run(None, None, key))
    draws, rng = [], key
    for _ in range(len(out[1])):
        rng, sub = jax.random.split(rng)
        draws.append(np.array(jax.random.gumbel(sub, (BATCH, A),
                                                jnp.float32)))
        if gumbel_sample:
            rng, _ = jax.random.split(rng)
    return out, draws


@pytest.mark.parametrize("gumbel_sample", [False, True])
def test_gumbel_selfplay_replays_the_reference(gumbel_sample):
    """Each ply's reference draw through the port's search: π′ within
    ``TARGET_ATOL``, the halving winner equal to the reference's move
    (or, under ``gumbel_sample``, the port's own sample on a
    π′-supported move and the reference's move replayed), the live
    flags and the states after every ply bit-identical."""
    (final, actions, live, targets), draws = reference_selfplay(
        gumbel_sample)
    assert len(actions) == MAX_MOVES
    run = port_selfplay(gumbel_sample=gumbel_sample)
    st = torchgo.new_states(TCFG, BATCH, device="cpu")
    g = torch.Generator().manual_seed(0)
    worst = 0.0
    for t in range(len(actions)):
        _, pi, best = run.search_ply(st, noise=torch.as_tensor(draws[t]))
        assert pi.dtype == torch.float32
        worst = max(worst, float(np.abs(pi.numpy() - targets[t]).max()))
        np.testing.assert_allclose(pi.sum(1).numpy(), 1.0, atol=1e-5)
        eq((~st.done).numpy(), live[t], f"ply {t}: live")
        want = torch.as_tensor(actions[t].copy())
        if gumbel_sample:
            _, mine, _ = run.pick_and_step(st, pi, g)
            assert bool((pi.gather(1, mine.long()[:, None]) > 0).all())
            st, action, _ = run.step_best(st, want)
        else:
            st, action, _ = run.step_best(st, best)
        eq(action.numpy(), actions[t], f"ply {t}: actions")
    assert_states(st, final, "final")
    assert worst <= TARGET_ATOL


def test_gumbel_selfplay_runs_on_its_own_draws():
    """The port's own run: f32 π′ targets summing to 1 on every live
    row, every move on a π′-supported action, and the move rule as asked
    (sampling changes the games)."""
    games = []
    for gumbel_sample in (False, True):
        run = port_selfplay(gumbel_sample=gumbel_sample)
        final, actions, live, targets = run(torch.Generator().manual_seed(1))
        assert targets.shape == (MAX_MOVES, BATCH, A)
        assert targets.dtype == torch.float32
        sums = targets.sum(-1)[live]
        assert bool(((sums - 1).abs() < 1e-5).all())
        picked = targets.gather(2, actions.long()[..., None])[..., 0]
        assert bool((picked[live] > 0).all())
        games.append(actions)
    assert not torch.equal(*games)


def test_gumbel_refuses_puct_knobs(tmp_path):
    for kw in (dict(dirichlet_alpha=0.03), dict(forced_k=2.0)):
        with pytest.raises(ValueError, match="PUCT"):
            port_selfplay(**kw)
    policy = os.path.join(NETS, "policy.json")
    value = os.path.join(NETS, "value.json")
    with pytest.raises(SystemExit, match="--gumbel requires --search-sims"):
        selfplay_cli.main(["--policy", policy, "--out", str(tmp_path),
                           "--gumbel", "--device", "cpu"])
    with pytest.raises(SystemExit, match="PUCT-mode root noise"):
        selfplay_cli.main(["--policy", policy, "--out", str(tmp_path),
                           "--search-sims", "8", "--value", value,
                           "--gumbel", "--dirichlet-alpha", "0.03",
                           "--device", "cpu"])
    assert not os.listdir(tmp_path)


def test_selfplay_cli_gumbel_writes_legal_games(tmp_path):
    """``--search-sims 8 --gumbel --m-root 4`` on the committed 9×9 nets:
    every SGF parses and replays legally, the summary counts them."""
    out = str(tmp_path / "g")
    summary = selfplay_cli.main([
        "--policy", os.path.join(NETS, "policy.json"), "--value",
        os.path.join(NETS, "value.json"), "--search-sims", "8", "--gumbel",
        "--m-root", "4", "--games", "2", "--max-moves", "6", "--out", out,
        "--device", "cpu"])
    assert summary["sgf_files"] == 2 and summary["games"] == 2
    for g in range(2):
        with open(os.path.join(out, f"selfplay-{g:05d}.sgf")) as f:
            game = sgf.parse(f.read())
        st = tpygo.GameState(size=game.size, komi=game.komi)
        for color, move in game.moves:
            assert st.is_legal(move)
            st.do_move(move, color)
        assert len(game.moves) == 6
