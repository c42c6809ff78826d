"""The port's host APV-MCTS tree against the reference's, bit for bit.

Both packages' ``TreeNode``, ``MCTS`` and ``ParallelMCTS`` get the same
injected callables (plain functions of the board, no net), and every
tree they grow is compared node by node: children, visits, ``Q``,
``u``, ``P`` and outstanding virtual losses, all exactly (the tree's
arithmetic is the same float64 Python in both). The cases cover the
sequential search with its own rollout draws, waves with duplicate
leaves, virtual loss reverted, the depth cap, terminal leaves reached
through passes, the fused evaluator, ``update_with_move`` and
``reset``, and the player's tree sync and clock (the reference's
``tests/test_mcts.py:284`` and ``:309``).
"""

import zlib

import numpy as np
import pytest

from rocalphago_tpu.engine import pygo as ref_pygo
from rocalphago_tpu.models import CNNPolicy as RefPolicy
from rocalphago_tpu.models import CNNValue as RefValue
from rocalphago_tpu.search import mcts as ref_mcts
from rocalphago_tpu_torch.engine import pygo
from rocalphago_tpu_torch.models import CNNPolicy, CNNValue
from rocalphago_tpu_torch.search import mcts

SIZE = 5
PACKAGES = ((ref_mcts, ref_pygo), (mcts, pygo))


def board_rng(state, salt: int) -> np.random.Generator:
    """A generator seeded by the position (board, player, passes), the
    same in both packages."""
    key = (state.board.astype(np.int8).tobytes()
           + bytes([state.current_player % 256, salt])
           + bytes(str(state.history[-2:]), "ascii"))
    return np.random.default_rng(zlib.crc32(key))


def make_fns(with_pass: bool):
    """``(policy_fn, value_fn, rollout_fn)`` over one state: priors on
    the sensible moves (and on pass when ``with_pass``, so two passes
    inside the tree end the game), a value in [-1, 1], a rollout
    distribution."""
    def policy(state):
        moves = state.get_legal_moves(include_eyes=False)
        if with_pass:
            moves = moves + [None]
        if not moves:
            return []
        w = board_rng(state, 1).random(len(moves)) + 0.05
        if with_pass:
            w[-1] = 4.0 * w.max()
        w /= w.sum()
        return list(zip(moves, w.tolist()))

    def value(state):
        return float(board_rng(state, 2).uniform(-1, 1))

    def rollout(state):
        moves = state.get_legal_moves(include_eyes=False)
        if not moves:
            return []
        w = board_rng(state, 3).random(len(moves)) + 0.05
        return list(zip(moves, (w / w.sum()).tolist()))

    return policy, value, rollout


def batch(fn):
    return lambda states: [fn(s) for s in states]


def batch_outcomes(states):
    """A deterministic rollout outcome per leaf."""
    return [float(board_rng(s, 4).choice([-1.0, 0.0, 1.0]))
            for s in states]


def assert_same_tree(a, b, path=()):
    assert (a._n_visits, a._Q, a._u, a._P, a._vloss) == \
        (b._n_visits, b._Q, b._u, b._P, b._vloss), path
    assert list(a._children) == list(b._children), path
    for move in a._children:
        assert_same_tree(a._children[move], b._children[move],
                         path + (move,))


def count_nodes(node) -> int:
    return 1 + sum(count_nodes(c) for c in node._children.values())


def double_passes(node, passed: bool = False) -> int:
    """Nodes reached by two passes in a row: terminal leaves."""
    return sum((passed and move is None)
               + double_passes(child, move is None)
               for move, child in node._children.items())


def outstanding(node) -> int:
    return node._vloss + sum(outstanding(c)
                             for c in node._children.values())


def test_tree_node_operations_match():
    rng = np.random.default_rng(0)
    nodes = []
    for mod, _ in PACKAGES:
        root = mod.TreeNode(None, 1.0)
        root.expand([((0, 0), 0.7), ((1, 1), 0.2), ((2, 2), 0.1)])
        nodes.append(root)
    ops = rng.integers(0, 5, size=200)
    vals = rng.uniform(-1, 1, size=200)
    for op, v in zip(ops, vals):
        picks = [root.select(5.0) for root in nodes]
        assert picks[0][0] == picks[1][0]
        children = [p[1] for p in picks]
        for child in children:
            if op == 0:
                child.update_recursive(float(v))
            elif op == 1:
                child.add_virtual_loss()
            elif op == 2:
                child.revert_virtual_loss()   # no-op without a loss
            elif op == 3:
                child.expand([((3, 3), 0.5), ((4, 4), 0.5)])
            else:
                child.update(float(v))
        assert_same_tree(*nodes)
    assert nodes[0].is_root() and nodes[1].is_root()


@pytest.mark.parametrize("lmbda", [0.0, 0.5, 1.0])
def test_sequential_mcts_matches(lmbda):
    """The sequential form, its rollouts drawn from its own numpy
    generator: the same moves and trees, then subtree reuse and a
    reset."""
    policy, value, rollout = make_fns(with_pass=False)
    searches, states = [], []
    for mod, pg in PACKAGES:
        searches.append(mod.MCTS(value, policy, rollout, lmbda=lmbda,
                                 rollout_limit=30, playout_depth=6,
                                 n_playout=40,
                                 rng=np.random.default_rng(7)))
        states.append(pg.GameState(size=SIZE))
    for _ in range(3):
        moves = [s.get_move(st) for s, st in zip(searches, states)]
        assert moves[0] == moves[1]
        assert_same_tree(searches[0]._root, searches[1]._root)
        for s, st in zip(searches, states):
            s.update_with_move(moves[0])
            st.do_move(moves[0])
        assert_same_tree(searches[0]._root, searches[1]._root)
    for s in searches:
        s.update_with_move((9, 9))        # not a child: a fresh tree
        assert s._root.is_leaf() and s._root._n_visits == 0


CASES = {
    # leaf_batch, lmbda, playout_depth, passes in the priors, fused
    "wave8": (8, 0.5, 20, False, False),
    "value_only": (8, 0.0, 20, False, False),
    "rollout_only": (4, 1.0, 20, False, False),
    "depth_cap": (8, 0.5, 2, False, False),
    "terminal": (8, 0.5, 20, True, False),
    "odd_wave": (3, 0.5, 20, True, False),
    "fused": (8, 0.5, 20, False, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_parallel_mcts_matches(case):
    leaf_batch, lmbda, depth, with_pass, fused = CASES[case]
    policy, value, _ = make_fns(with_pass)

    def pv(states, want):
        return ([policy(s) if w else None for s, w in zip(states, want)],
                [value(s) for s in states])

    searches, states = [], []
    for mod, pg in PACKAGES:
        searches.append(mod.ParallelMCTS(
            batch(value), batch(policy), batch_outcomes, lmbda=lmbda,
            playout_depth=depth, n_playout=29, leaf_batch=leaf_batch,
            rng=np.random.default_rng(3),
            batch_policy_value_fn=pv if fused else None))
        states.append(pg.GameState(size=SIZE))
    grown = terminal = 0
    for _ in range(4):
        moves = [s.get_move(st) for s, st in zip(searches, states)]
        assert moves[0] == moves[1]
        assert_same_tree(searches[0]._root, searches[1]._root)
        assert outstanding(searches[1]._root) == 0   # losses reverted
        grown = max(grown, count_nodes(searches[1]._root))
        terminal += double_passes(searches[1]._root)
        for s, st in zip(searches, states):
            s.update_with_move(moves[0])
            st.do_move(moves[0])
        if states[0].is_end_of_game:
            break
    assert grown > leaf_batch
    assert (terminal > 0) == with_pass
    for s in searches:
        s.reset()
    assert_same_tree(searches[0]._root, searches[1]._root)


def test_first_wave_shares_duplicate_leaves():
    """On an empty tree every playout of the first wave lands on the
    root: one evaluation is shared, and the root is expanded once."""
    calls = []
    policy, value, _ = make_fns(with_pass=False)

    def counting_policy(states):
        calls.append(len(states))
        return [policy(s) for s in states]

    for mod, pg in PACKAGES:
        calls.clear()
        search = mod.ParallelMCTS(batch(value), counting_policy,
                                  batch_outcomes, lmbda=0.5, n_playout=8,
                                  leaf_batch=8,
                                  rng=np.random.default_rng(0))
        search.get_move(pg.GameState(size=SIZE))
        assert calls == [1]
        assert search._root._n_visits == 8


def tiny_players():
    """An ``MCTSPlayer`` of each package over tiny nets, their search
    swapped for one on injected callables (the nets stay unused)."""
    policy, value, _ = make_fns(with_pass=False)
    out = []
    for (mod, _), nets in zip(PACKAGES, (
            (RefPolicy(("board", "ones"), board=SIZE, layers=2,
                       filters_per_layer=4),
             RefValue(("board", "ones", "color"), board=SIZE, layers=2,
                      filters_per_layer=4)),
            (CNNPolicy(("board", "ones"), board=SIZE, layers=2,
                       filters_per_layer=4, device="cpu"),
             CNNValue(("board", "ones", "color"), board=SIZE, layers=2,
                      filters_per_layer=4, device="cpu")))):
        player = mod.MCTSPlayer(nets[1], nets[0], lmbda=0.5, n_playout=16,
                                leaf_batch=4, playout_depth=4, seed=0)
        player.mcts = mod.ParallelMCTS(
            batch(value), batch(policy), batch_outcomes, lmbda=0.5,
            playout_depth=4, n_playout=16, leaf_batch=4,
            rng=np.random.default_rng(0))
        out.append(player)
    return out


def test_player_sync_tree_matches():
    """Alternating play re-roots along the opponent's move; a jump in
    the history (an undo) resets the tree -- both packages alike."""
    players = tiny_players()
    states = [pg.GameState(size=SIZE) for _, pg in PACKAGES]
    opponent = np.random.default_rng(1)
    for ply in range(6):
        moves = [p.get_move(st) for p, st in zip(players, states)]
        assert moves[0] == moves[1]
        assert_same_tree(players[0].mcts._root, players[1].mcts._root)
        assert players[0]._tree_history == players[1]._tree_history
        for st in states:
            st.do_move(moves[0])
        legal = states[0].get_legal_moves(include_eyes=False)
        reply = legal[opponent.integers(len(legal))]
        if ply == 3:                  # an undo: the history jumps
            states = [pg.GameState(size=SIZE) for _, pg in PACKAGES]
        for st in states:
            st.do_move(reply)
        for p in players:
            p._sync_tree(list(states[1].history))
        assert_same_tree(players[0].mcts._root, players[1].mcts._root)
        if ply == 3:
            assert players[1].mcts._root._n_visits == 0


def test_player_clock_shrinks_playouts():
    """Under a short budget the player runs whole leaf waves, floored
    at one; the first search never feeds the rate -- both packages
    alike."""
    players = tiny_players()
    states = [pg.GameState(size=SIZE) for _, pg in PACKAGES]
    runs = []
    for p, st in zip(players, states):
        p.set_move_time(5.0)            # clock set, but no rate yet
        p.get_move(st)
        got = [p.last_n_playout, p._clock.rate]
        for rate, budget, move in ((8.0, 1.0, (2, 2)), (8.0, 0.1, (1, 1)),
                                   (8.0, 1000.0, (3, 3))):
            p._clock.rate = rate
            p.set_move_time(budget)
            st.do_move(move)
            p.get_move(st)
            got.append(p.last_n_playout)
        runs.append(got)
    assert runs[0] == runs[1] == [16, None, 8, 4, 16]
