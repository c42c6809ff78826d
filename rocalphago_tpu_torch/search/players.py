"""Host-facing agents: the port of ``search/players.py`` -- the greedy,
probabilistic and value players -- and the factory that also builds the
search players: the host APV-MCTS player with rollouts
(:class:`~.mcts.MCTSPlayer`) and the device-search players, PUCT and
Gumbel (:class:`~.device_mcts.DeviceMCTSPlayer`)."""

from __future__ import annotations

import inspect

import numpy as np

from rocalphago_tpu_torch.models.policy import CNNPolicy
from rocalphago_tpu_torch.models.value import CNNValue

KINDS = ("greedy", "probabilistic", "mcts", "device-mcts", "gumbel-mcts")


def _sensible_moves(state, move_limit=None):
    if move_limit is not None and state.turns_played >= move_limit:
        return []
    return state.get_legal_moves(include_eyes=False)


class GreedyPolicyPlayer:
    """Plays the policy's argmax move over sensible legal moves.
    ``pass_when_offered``: pass after move 100 when the opponent just
    passed. ``symmetric``: ensemble the policy over the 8 board
    symmetries."""

    def __init__(self, policy: CNNPolicy, pass_when_offered: bool = False,
                 move_limit: int | None = None, symmetric: bool = False):
        self.policy = policy
        self.pass_when_offered = pass_when_offered
        self.move_limit = move_limit
        self.symmetric = symmetric

    def get_move(self, state):
        return self.get_moves([state])[0]

    def get_moves(self, states):
        out = [None] * len(states)
        idx, live, moves_lists = [], [], []
        for i, st in enumerate(states):
            if self.pass_when_offered and st.history and \
                    st.history[-1] is None and st.turns_played > 100:
                continue
            sensible = _sensible_moves(st, self.move_limit)
            if sensible:
                idx.append(i)
                live.append(st)
                moves_lists.append(sensible)
        if not live:
            return out
        dists = self.policy.batch_eval_state(live, moves_lists,
                                             symmetric=self.symmetric)
        for i, dist in zip(idx, dists):
            if dist:
                out[i] = max(dist, key=lambda mp: mp[1])[0]
        return out


class ProbabilisticPolicyPlayer:
    """Samples moves ∝ p^(1/temperature) over sensible legal moves,
    with numpy's ``default_rng`` as in the reference. From move
    ``greedy_start`` on it plays the argmax instead; ``symmetric``
    ensembles the policy over the 8 board symmetries."""

    def __init__(self, policy: CNNPolicy, temperature: float = 1.0,
                 seed: int | None = None, move_limit: int | None = 500,
                 greedy_start: int | None = None,
                 symmetric: bool = False):
        self.policy = policy
        self.temperature = float(temperature)
        self.move_limit = move_limit
        self.greedy_start = greedy_start
        self.symmetric = symmetric
        self.rng = np.random.default_rng(seed)

    def get_move(self, state):
        return self.get_moves([state])[0]

    def get_moves(self, states):
        out = [None] * len(states)
        idx, live, moves_lists = [], [], []
        for i, st in enumerate(states):
            sensible = _sensible_moves(st, self.move_limit)
            if sensible:
                idx.append(i)
                live.append(st)
                moves_lists.append(sensible)
        if not live:
            return out
        dists = self.policy.batch_eval_state(live, moves_lists,
                                             symmetric=self.symmetric)
        for k, (i, dist) in enumerate(zip(idx, dists)):
            if not dist:
                continue
            moves = [m for m, _ in dist]
            probs = np.asarray([p for _, p in dist], np.float64)
            greedy = (self.greedy_start is not None
                      and live[k].turns_played >= self.greedy_start)
            if self.temperature != 1.0 and not greedy:
                probs = probs ** (1.0 / self.temperature)
            probs = probs / probs.sum()
            if greedy:
                out[i] = moves[int(np.argmax(probs))]
            else:
                out[i] = moves[self.rng.choice(len(moves), p=probs)]
        return out


class ValuePlayer:
    """One-ply lookahead on the value net: every sensible move's
    successor is valued in one batched call, and the move that leaves
    the opponent (the player to move there) worst off is played. With
    ``policy`` and ``top_k``, only the policy's ``top_k`` moves are
    looked at."""

    def __init__(self, value: CNNValue, policy: CNNPolicy | None = None,
                 top_k: int | None = None, move_limit: int | None = None):
        self.value = value
        self.policy = policy
        self.top_k = top_k
        self.move_limit = move_limit

    def get_move(self, state):
        moves = _sensible_moves(state, self.move_limit)
        if not moves:
            return None
        if self.policy is not None and self.top_k:
            dist = self.policy.eval_state(state, moves=moves)
            dist.sort(key=lambda mp: -mp[1])
            moves = [m for m, _ in dist[:self.top_k]]
        succs = []
        for mv in moves:
            nxt = state.copy()
            nxt.do_move(mv)
            succs.append(nxt)
        vals = self.value.batch_eval_state(succs)
        return moves[int(np.argmin(vals))]

    def get_moves(self, states):
        return [self.get_move(s) for s in states]


def build_player(kind: str, policy_path: str, value_path: str | None = None,
                 rollout_path: str | None = None, temperature: float = 0.67,
                 playouts: int = 100, leaf_batch: int = 8,
                 lmbda: float = 0.5, symmetric: bool = False,
                 device_rollout: bool = False, device=None,
                 board: int | None = None):
    """A ``greedy``, ``probabilistic``, ``mcts``, ``device-mcts`` or
    ``gumbel-mcts`` player over saved model specs, on CUDA unless
    ``device`` names another device. The search players need a value
    net and run ``playouts`` playouts (simulations) a move; ``mcts``
    takes an optional rollout net (the policy rolls out without one),
    ``leaf_batch``, ``lmbda`` and ``device_rollout``. ``symmetric``
    ensembles the greedy, probabilistic and mcts players' evaluations
    over the 8 board symmetries. With ``board``, nets saved at another
    size are re-boarded through :meth:`~rocalphago_tpu_torch.models.
    nn_util.NeuralNetBase.at_board` (FCN heads play any size;
    size-locked heads raise ``ValueError``)."""
    from rocalphago_tpu_torch.models.nn_util import NeuralNetBase

    if kind not in KINDS:
        raise ValueError(f"unknown player kind {kind!r} (this port has "
                         f"{', '.join(KINDS)})")
    if kind in KINDS[2:] and not value_path:
        raise ValueError(f"{kind} player needs a value model")

    def load(path):
        net = NeuralNetBase.load_model(path, device=device)
        return net if board is None else net.at_board(board)

    policy = load(policy_path)
    if kind == "greedy":
        return GreedyPolicyPlayer(policy, symmetric=symmetric)
    if kind == "probabilistic":
        return ProbabilisticPolicyPlayer(policy, temperature=temperature,
                                         symmetric=symmetric)
    value = load(value_path)
    if kind == "mcts":
        from rocalphago_tpu_torch.search.mcts import MCTSPlayer

        rollout = load(rollout_path) if rollout_path else None
        return MCTSPlayer(value, policy, rollout=rollout, lmbda=lmbda,
                          n_playout=playouts, leaf_batch=leaf_batch,
                          symmetric=symmetric,
                          device_rollout=device_rollout)
    from rocalphago_tpu_torch.search.device_mcts import DeviceMCTSPlayer

    return DeviceMCTSPlayer(value, policy, n_sim=playouts,
                            gumbel=(kind == "gumbel-mcts"))


def player_board(player) -> int | None:
    """Board size the player's nets were built for, or None. Sees
    through a wrapper that exposes the wrapped agent as ``primary``
    (:class:`~rocalphago_tpu_torch.interface.resilient.
    ResilientPlayer`)."""
    board = getattr(player, "board", None)
    if board is None:
        board = getattr(getattr(player, "policy", None), "board", None)
    if board is None and getattr(player, "primary", None) is not None:
        board = player_board(player.primary)
    return board


def reset_player(player, reason: str = "new_game") -> None:
    """Clear any per-game search state (a new game starts): the host
    MCTS tree and its history, and a device player's carried tree and
    encode cache. ``reason`` labels the reset for players whose
    ``reset`` takes one (``encode_cache_resets_total{reason=}``); a
    plain ``reset()`` is called without it."""
    def call(fn):
        try:
            takes = "reason" in inspect.signature(fn).parameters
        except (TypeError, ValueError):
            takes = False
        return fn(reason=reason) if takes else fn()

    mcts = getattr(player, "mcts", None)
    if mcts is not None and hasattr(mcts, "reset"):
        call(mcts.reset)
    reset = getattr(player, "reset", None)
    if callable(reset):
        call(reset)
    if hasattr(player, "_tree_history"):
        player._tree_history = None
