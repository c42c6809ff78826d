"""Host-facing agents: the port of ``search/players.py`` for the greedy
and probabilistic policy players, and the factory that also builds the
device-search players, PUCT and Gumbel
(:class:`~.device_mcts.DeviceMCTSPlayer`)."""

from __future__ import annotations

import numpy as np

from rocalphago_tpu_torch.models.policy import CNNPolicy


def _sensible_moves(state, move_limit=None):
    if move_limit is not None and state.turns_played >= move_limit:
        return []
    return state.get_legal_moves(include_eyes=False)


class GreedyPolicyPlayer:
    """Plays the policy's argmax move over sensible legal moves."""

    def __init__(self, policy: CNNPolicy, move_limit: int | None = None):
        self.policy = policy
        self.move_limit = move_limit

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
        dists = self.policy.batch_eval_state(live, moves_lists)
        for i, dist in zip(idx, dists):
            if dist:
                out[i] = max(dist, key=lambda mp: mp[1])[0]
        return out


class ProbabilisticPolicyPlayer:
    """Samples moves ∝ p^(1/temperature) over sensible legal moves,
    with numpy's ``default_rng`` as in the reference."""

    def __init__(self, policy: CNNPolicy, temperature: float = 1.0,
                 seed: int | None = None, move_limit: int | None = 500):
        self.policy = policy
        self.temperature = float(temperature)
        self.move_limit = move_limit
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
        dists = self.policy.batch_eval_state(live, moves_lists)
        for i, dist in zip(idx, dists):
            if not dist:
                continue
            moves = [m for m, _ in dist]
            probs = np.asarray([p for _, p in dist], np.float64)
            if self.temperature != 1.0:
                probs = probs ** (1.0 / self.temperature)
            probs = probs / probs.sum()
            out[i] = moves[self.rng.choice(len(moves), p=probs)]
        return out


def build_player(kind: str, policy_path: str, value_path: str | None = None,
                 temperature: float = 0.67, playouts: int = 100,
                 device=None, board: int | None = None):
    """A ``greedy``, ``probabilistic``, ``device-mcts`` or ``gumbel-mcts``
    player over saved model specs, on CUDA unless ``device`` names
    another device. The search players need a value net and search
    ``playouts`` simulations per move. With ``board``, nets saved at
    another size are re-boarded through :meth:`~rocalphago_tpu_torch.
    models.nn_util.NeuralNetBase.at_board` (FCN heads play any size;
    size-locked heads raise ``ValueError``)."""
    from rocalphago_tpu_torch.models.nn_util import NeuralNetBase

    if kind == "mcts":
        raise ValueError(
            "the mcts player (host APV-MCTS with rollouts) is not ported "
            "yet (ROADMAP.md, Queue 1 item 2); this port has greedy, "
            "probabilistic, device-mcts and gumbel-mcts")
    if kind not in ("greedy", "probabilistic", "device-mcts", "gumbel-mcts"):
        raise ValueError(f"unknown player kind {kind!r} (this port has "
                         "greedy, probabilistic, device-mcts and "
                         "gumbel-mcts)")

    def load(path):
        net = NeuralNetBase.load_model(path, device=device)
        return net if board is None else net.at_board(board)

    policy = load(policy_path)
    if kind == "greedy":
        return GreedyPolicyPlayer(policy)
    if kind == "probabilistic":
        return ProbabilisticPolicyPlayer(policy, temperature=temperature)
    from rocalphago_tpu_torch.search.device_mcts import DeviceMCTSPlayer

    if not value_path:
        raise ValueError(f"{kind} player needs a value model")
    return DeviceMCTSPlayer(load(value_path), policy, n_sim=playouts,
                            gumbel=(kind == "gumbel-mcts"))


def player_board(player) -> int | None:
    """Board size the player's nets were built for, or None."""
    board = getattr(player, "board", None)
    if board is None:
        board = getattr(getattr(player, "policy", None), "board", None)
    return board


def reset_player(player) -> None:
    """Clear any per-game search state (a new game starts)."""
    reset = getattr(player, "reset", None)
    if callable(reset):
        reset()
