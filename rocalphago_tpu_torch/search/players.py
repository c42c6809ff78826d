"""Host-facing agents over the policy net: the port of
``search/players.py`` for the greedy and probabilistic players (the
search players wait for the device-search slice)."""

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


def build_player(kind: str, policy_path: str, temperature: float = 0.67,
                 device=None):
    """A ``greedy`` or ``probabilistic`` player over a saved policy
    spec, on CUDA unless ``device`` names another device."""
    from rocalphago_tpu_torch.models.nn_util import NeuralNetBase

    if kind not in ("greedy", "probabilistic"):
        raise ValueError(f"unknown player kind {kind!r} (this port has "
                         "greedy and probabilistic)")
    policy = NeuralNetBase.load_model(policy_path, device=device)
    if kind == "greedy":
        return GreedyPolicyPlayer(policy)
    return ProbabilisticPolicyPlayer(policy, temperature=temperature)


def player_board(player) -> int | None:
    """Board size the player's nets were built for, or None."""
    board = getattr(player, "board", None)
    if board is None:
        board = getattr(getattr(player, "policy", None), "board", None)
    return board
