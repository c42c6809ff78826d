"""The port's AlphaGo player (``MCTSPlayer`` over ``net_backends``), the
value player, the policy players' options and the CLIs that build them,
against the reference's, on the CPU.

Nets are float32 at 7×7 (3 layers × 8 filters, no ladder planes) with
the reference's weights carried by ``params_from_flax``; a net output
agrees within ``ATOL + RTOL·|x|``.

* ``net_backends``: priors and values equal the reference's within that
  tolerance, and the fused wave evaluator (one encode shared by both
  nets) gives what the separate calls give.
* A short game, each package's player on both colours: at λ = 0 the
  moves and root visits are identical; at λ = 0.5 with device rollouts
  too, the reference's rollout draws (its own key chain) handed to the
  port through ``device_rollout_fn(noise=)``; with host rollouts and the
  same numpy seed, likewise (a float near-tie flipping an
  ``rng.choice`` would show here).
* ``ValuePlayer`` (with and without the policy's top-k filter),
  ``pass_when_offered``, ``greedy_start`` and ``symmetric`` play the
  reference's moves.
* GTP ``--player mcts --device-rollout --device cpu`` answers legal
  vertices; the tournament runs an ``mcts:policy:value:rollout`` spec.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from rocalphago_tpu.engine import pygo as ref_pygo
from rocalphago_tpu.models import CNNPolicy as RefPolicy
from rocalphago_tpu.models import CNNRollout as RefRollout
from rocalphago_tpu.models import CNNValue as RefValue
from rocalphago_tpu.search import mcts as ref_mcts
from rocalphago_tpu.search import players as ref_players
from rocalphago_tpu_torch.engine import pygo
from rocalphago_tpu_torch.interface import gtp, tournament
from rocalphago_tpu_torch.models import CNNPolicy, CNNRollout, CNNValue
from rocalphago_tpu_torch.models import specs
from rocalphago_tpu_torch.models.weights import params_from_flax
from rocalphago_tpu_torch.search import mcts, players
from torch_port_helpers import one_torch_thread, random_games  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 7
N = SIZE * SIZE
ATOL = RTOL = 1e-5
FEATS = ("board", "ones", "turns_since", "liberties", "sensibleness")
VFEATS = FEATS + ("color",)
ROLLOUT_FEATS = ("board", "ones", "turns_since", "liberties")
NETS = "results/zero_r5/target_compare/gumbel"


def to_float32(ref):
    ref.module = ref.module.clone(dtype=jnp.float32)
    ref._apply = jax.jit(ref.module.apply)
    ref._apply_sym = None
    return ref


def carried(ref, cls, feats, **kw):
    net = cls(feats, board=SIZE, init_weights=False, device="cpu",
              dtype=torch.float32, **kw)
    net.module.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, ref.params)))
    return net


@pytest.fixture(scope="module")
def nets():
    """``(reference, port)`` triples of policy, value, rollout nets."""
    ref = (to_float32(RefPolicy(FEATS, board=SIZE, layers=3,
                                filters_per_layer=8, seed=1)),
           to_float32(RefValue(VFEATS, board=SIZE, layers=3,
                               filters_per_layer=8, seed=2)),
           to_float32(RefRollout(board=SIZE, seed=3)))
    port = (carried(ref[0], CNNPolicy, FEATS, layers=3,
                    filters_per_layer=8),
            carried(ref[1], CNNValue, VFEATS, layers=3,
                    filters_per_layer=8),
            carried(ref[2], CNNRollout, ROLLOUT_FEATS))
    return ref, port


def twin(state):
    out = pygo.GameState(size=state.size, komi=state.komi)
    for mv in state.history:
        out.do_move(mv)
    return out


def same_dists(got, want):
    for g, w in zip(got, want):
        assert [m for m, _ in g] == [m for m, _ in w]
        np.testing.assert_allclose([p for _, p in g], [p for _, p in w],
                                   rtol=RTOL, atol=ATOL)


def test_backends_match_and_fuse(nets):
    ref, port = nets
    games = random_games(SIZE, 6, 2, 25, seed=4)
    twins = [twin(g) for g in games]
    want = ref_mcts.net_backends(ref[0], ref[1], ref[2])
    got = mcts.net_backends(port[0], port[1], port[2])
    same_dists(got[1](twins), want[1](games))
    np.testing.assert_allclose(got[0](twins), want[0](games), rtol=RTOL,
                               atol=ATOL)
    flags = [True, False, True, True, False, True]
    fused = got[3](twins, flags)
    ref_fused = want[3](games, flags)
    assert [d is None for d in fused[0]] == [not f for f in flags]
    same_dists([d for d in fused[0] if d], [d for d in ref_fused[0] if d])
    # the fused path equals the separate one, bit for bit
    separate = got[1]([t for t, f in zip(twins, flags) if f])
    assert [d for d in fused[0] if d] == separate
    np.testing.assert_array_equal(fused[1], got[0](twins))
    # symmetric backends keep the separate paths
    assert mcts.net_backends(port[0], port[1], symmetric=True)[3] is None


def reference_chain(key, limit, batch):
    def body(rng, _):
        rng, sub = jax.random.split(rng)
        return rng, jax.random.gumbel(sub, (batch, N), jnp.float32)

    return np.asarray(jax.jit(lambda k: lax.scan(
        body, k, None, length=limit)[1])(key))


class ReferenceDraws:
    """``noise(call)`` from the reference ``device_rollout_fn``'s key
    chain: ``key, sub = split(key)`` a wave, then the rollout's chain."""

    def __init__(self, seed, limit, batch):
        self.key = jax.random.key(seed)
        self.limit, self.batch = limit, batch

    def __call__(self, call):
        self.key, sub = jax.random.split(self.key)
        return torch.as_tensor(reference_chain(sub, self.limit,
                                               self.batch))


def play_both(nets, moves, **kw):
    """Each package's player plays ``moves`` plies on both colours;
    ``[(move, root visits), ...]`` per package."""
    (rp, rv, rr), (pp, pv, pr) = nets
    seed = 5
    ref = ref_mcts.MCTSPlayer(rv, rp, rollout=rr, seed=seed, **kw)
    port = mcts.MCTSPlayer(pv, pp, rollout=pr, seed=seed, **kw)
    if kw.get("device_rollout"):
        port.mcts._rollout = mcts.device_rollout_fn(
            pr, min_batch=kw["leaf_batch"],
            seed=int(np.random.default_rng(seed).integers(2**31)),
            noise=ReferenceDraws(
                int(np.random.default_rng(seed).integers(2**31)), 500,
                kw["leaf_batch"]))
    out = []
    for player, st in ((ref, ref_pygo.GameState(size=SIZE)),
                       (port, pygo.GameState(size=SIZE))):
        seq = []
        for _ in range(moves):
            root = player.mcts._root
            move = player.get_move(st)
            seq.append((move, sorted((m, c._n_visits)
                                     for m, c in root._children.items()
                                     if c._n_visits)))
            st.do_move(move)
        out.append(seq)
    return out


@pytest.mark.parametrize("mode", ["value_only", "device_rollouts",
                                  "host_rollouts"])
def test_player_plays_the_references_game(nets, mode):
    kw = dict(n_playout=16, leaf_batch=8, playout_depth=8)
    if mode == "value_only":
        kw["lmbda"] = 0.0
    elif mode == "device_rollouts":
        kw["device_rollout"] = True
    else:
        kw.update(n_playout=8, rollout_limit=60)
    want, got = play_both(nets, 4 if mode == "host_rollouts" else 6, **kw)
    assert got == want


def test_value_player_matches(nets):
    ref, port = nets
    games = random_games(SIZE, 4, 3, 20, seed=6)
    for top_k in (None, 5):
        want = ref_players.ValuePlayer(ref[1], ref[0], top_k=top_k)
        got = players.ValuePlayer(port[1], port[0], top_k=top_k)
        assert [got.get_move(twin(g)) for g in games] == \
            [want.get_move(g) for g in games]
    assert players.ValuePlayer(port[1], move_limit=0).get_move(
        twin(games[0])) is None


def test_policy_player_options_match(nets):
    """``pass_when_offered`` passes after move 100 when the opponent
    passed; ``greedy_start`` turns sampling into the argmax from that
    move on; ``symmetric`` ensembles the policy -- as the reference."""
    ref, port = nets
    games = random_games(SIZE, 7, 2, 20, seed=7)
    games[-1].do_move(None)           # the opponent passes ...
    twins = [twin(g) for g in games]
    for st in (games[-1], twins[-1]):
        st.turns_played = 101         # ... after move 100
    for kw in ({"pass_when_offered": True},
               {"pass_when_offered": True, "symmetric": True}):
        want = ref_players.GreedyPolicyPlayer(ref[0], **kw).get_moves(games)
        got = players.GreedyPolicyPlayer(port[0], **kw).get_moves(twins)
        assert got == want and got[-1] is None
    for kw in ({"greedy_start": 0}, {"greedy_start": 0, "symmetric": True},
               {"greedy_start": 1000, "temperature": 0.5}):
        want = ref_players.ProbabilisticPolicyPlayer(
            ref[0], seed=3, **kw).get_moves(games)
        got = players.ProbabilisticPolicyPlayer(
            port[0], seed=3, **kw).get_moves(twins)
        assert got == want


@pytest.fixture(scope="module")
def rollout_spec(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("specs") / "rollout.json")
    specs.main(["rollout", "--out", path, "--board", "9", "--device",
                "cpu"])
    return path


def test_gtp_serves_the_mcts_player(rollout_spec, monkeypatch, capsys):
    script = ("boardsize 9\nclear_board\ngenmove b\nplay w E5\n"
              "genmove b\ntime_settings 0 1 1\ngenmove w\nquit\n")
    monkeypatch.setattr("sys.stdin", io.StringIO(script))
    gtp.main(["--player", "mcts", "--policy", f"{NETS}/policy.json",
              "--value", f"{NETS}/value.json", "--rollout", rollout_spec,
              "--device-rollout", "--playouts", "16", "--leaf-batch", "8",
              "--lmbda", "0.5", "--device", "cpu"])
    replies = [r for r in capsys.readouterr().out.split("\n\n") if r]
    vertices = [r[2:] for r in replies if r.startswith("= ") and
                len(r) > 2]
    assert len(vertices) == 3
    state = pygo.GameState(size=9)
    for v, color in zip(vertices[:2], (pygo.BLACK, pygo.BLACK)):
        move = gtp.vertex_to_move(v, 9)
        assert move is None or state.is_legal(move)
        state.do_move(move, color)
        if len(state.history) == 1:
            state.do_move((4, 4), pygo.WHITE)


def test_tournament_runs_an_mcts_spec(rollout_spec, tmp_path, capsys):
    log = str(tmp_path / "games.jsonl")
    tally = tournament.main([
        f"mcts:{NETS}/policy.json:{NETS}/value.json:{rollout_spec}",
        f"greedy:{NETS}/policy.json", "--board", "9", "--games", "2",
        "--playouts", "8", "--move-limit", "8", "--device-rollout",
        "--log", log, "--device", "cpu"])
    assert tally["games"] == 2 and tally["forfeits"] == {"A": 0, "B": 0}
    with open(log) as f:
        assert len([json.loads(line) for line in f]) == 2
    capsys.readouterr()
