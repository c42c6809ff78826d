"""APV-MCTS: PUCT tree search on the host with batched leaf evaluation
on the card -- the port of ``search/mcts.py``, the AlphaGo paper's own
player.

The tree (``TreeNode``, ``MCTS``, ``ParallelMCTS``) is pure host code,
copied from the reference with its float64 arithmetic: a tree is small,
pointer-chasing and branchy, a poor fit for a device. What goes to the
card is the leaf evaluation: ``ParallelMCTS`` runs ``leaf_batch``
playouts a wave under virtual loss, collects the distinct leaves, and
evaluates their priors and values in one batched forward per net. The
rollouts of the λ mix run in lockstep across the wave through an
injected batch-rollout callable: on host rules with one rollout forward
a ply (:func:`net_backends`), or wholly on the card
(:func:`device_rollout_fn`). Every net touchpoint is an injected
callable, so the tree is testable with plain lambdas.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from rocalphago_tpu_torch.engine import pygo, torchgo
from rocalphago_tpu_torch.search.clock import MoveClock

PASS_MOVE = pygo.PASS_MOVE


class TreeNode:
    """A node in the MCTS tree, holding the edge statistics of the move
    that led to it: prior ``_P``, mean value ``_Q`` (from the moving
    player's perspective), visit count ``_n_visits``, and the PUCT
    exploration bonus ``_u``."""

    __slots__ = ("_parent", "_children", "_n_visits", "_Q", "_u", "_P",
                 "_vloss")

    def __init__(self, parent: "TreeNode | None", prior_p: float):
        self._parent = parent
        self._children: dict = {}     # move -> TreeNode
        self._n_visits = 0
        self._Q = 0.0
        self._u = prior_p
        self._P = prior_p
        self._vloss = 0               # outstanding virtual losses

    def expand(self, action_priors) -> None:
        """Create children for ``[(move, prior), ...]``."""
        for action, prob in action_priors:
            if action not in self._children:
                self._children[action] = TreeNode(self, prob)

    def select(self, c_puct: float) -> tuple:
        """(move, child) maximizing Q + u."""
        return max(self._children.items(),
                   key=lambda ac: ac[1].get_value(c_puct))

    def get_value(self, c_puct: float) -> float:
        n_parent = self._parent._n_visits if self._parent else 1
        self._u = (c_puct * self._P * np.sqrt(max(n_parent, 1))
                   / (1 + self._n_visits))
        return self._Q + self._u

    def update(self, leaf_value: float) -> None:
        """Fold one evaluation (from this node's edge perspective) into
        the running mean."""
        self._n_visits += 1
        self._Q += (leaf_value - self._Q) / self._n_visits

    def update_recursive(self, leaf_value: float) -> None:
        """Update ancestors bottom-up, flipping the sign per level
        (alternating players)."""
        if self._parent:
            self._parent.update_recursive(-leaf_value)
        self.update(leaf_value)

    # ------------------------------------------------------ virtual loss

    def add_virtual_loss(self, loss: float = 1.0) -> None:
        """Pessimistic in-flight marker that steers later selections in
        the same wave away from this path (AlphaGo's n_vl trick)."""
        self._vloss += 1
        self._n_visits += 1
        self._Q += (-loss - self._Q) / self._n_visits

    def revert_virtual_loss(self, loss: float = 1.0) -> None:
        if self._vloss <= 0:
            return
        self._vloss -= 1
        self._Q = (self._Q * self._n_visits + loss) / max(
            self._n_visits - 1, 1)
        self._n_visits -= 1

    def is_leaf(self) -> bool:
        return not self._children

    def is_root(self) -> bool:
        return self._parent is None


class MCTS:
    """Asynchronous-policy-and-value MCTS (sequential reference form).

    ``policy_fn(state) -> [(move, prob), ...]`` over sensible moves;
    ``value_fn(state) -> float`` in [-1, 1] from the player to move's
    perspective; ``rollout_policy_fn(state) -> [(move, prob), ...]``
    used for playouts. Leaf value = (1−λ)·value + λ·rollout_outcome.
    """

    def __init__(self, value_fn, policy_fn, rollout_policy_fn,
                 lmbda: float = 0.5, c_puct: float = 5.0,
                 rollout_limit: int = 500, playout_depth: int = 20,
                 n_playout: int = 10000, rng=None):
        self._root = TreeNode(None, 1.0)
        self._value = value_fn
        self._policy = policy_fn
        self._rollout = rollout_policy_fn
        self._lmbda = lmbda
        self._c_puct = c_puct
        self._rollout_limit = rollout_limit
        self._L = playout_depth
        self._n_playout = n_playout
        self._rng = rng or np.random.default_rng(0)

    # ---------------------------------------------------------- playouts

    def _descend(self, state, path: list | None = None):
        """Walk from the root to a leaf (≤ playout_depth plies),
        mutating ``state`` along the way. Returns the leaf node;
        ``path`` (if given) collects every node stepped through."""
        node = self._root
        for _ in range(self._L):
            if node.is_leaf():
                break
            move, node = node.select(self._c_puct)
            state.do_move(move)
            if path is not None:
                path.append(node)
        return node

    def _playout(self, state) -> None:
        node = self._descend(state)
        # an internal node hit at the depth cap is already expanded —
        # don't spend a policy forward on it
        if not state.is_end_of_game and node.is_leaf():
            priors = self._policy(state)
            if priors:
                node.expand(priors)
        node.update_recursive(self._leaf_value(state))

    def _leaf_value(self, state) -> float:
        """λ-mixed evaluation from the leaf's player-to-move
        perspective, returned from the *edge* (previous mover's)
        perspective — i.e. negated — ready for ``update_recursive``."""
        if state.is_end_of_game:
            w = state.get_winner()
            v = 0.0 if w == 0 else (1.0 if w == state.current_player
                                    else -1.0)
        else:
            v = 0.0
            if self._lmbda < 1.0:
                v += (1.0 - self._lmbda) * float(self._value(state))
            if self._lmbda > 0.0:
                v += self._lmbda * self._evaluate_rollout(
                    state.copy(), self._rollout_limit)
        return -v

    def _evaluate_rollout(self, state, limit: int) -> float:
        """Play to the end (≤ limit plies) with the rollout policy;
        outcome from the perspective of the player to move at entry."""
        player = state.current_player
        for _ in range(limit):
            if state.is_end_of_game:
                break
            dist = self._rollout(state)
            if not dist:
                state.do_move(PASS_MOVE)
                continue
            probs = np.asarray([p for _, p in dist], np.float64)
            probs /= probs.sum()
            move = dist[self._rng.choice(len(dist), p=probs)][0]
            state.do_move(move)
        w = state.get_winner()
        return 0.0 if w == 0 else (1.0 if w == player else -1.0)

    # ------------------------------------------------------------ driving

    def get_move(self, state, n_playout: int | None = None):
        """Run playouts from ``state`` and return the most-visited
        move (``None`` = pass when the tree has no children).
        ``n_playout`` overrides the configured budget (a game clock
        may ask for fewer)."""
        for _ in range(n_playout if n_playout is not None
                       else self._n_playout):
            self._playout(state.copy())
        if self._root.is_leaf():
            return PASS_MOVE
        return max(self._root._children.items(),
                   key=lambda ac: ac[1]._n_visits)[0]

    def update_with_move(self, last_move) -> None:
        """Re-root at the played move, keeping the subtree (reference
        subtree reuse); unknown move → fresh tree."""
        child = self._root._children.get(last_move)
        if child is not None:
            child._parent = None
            self._root = child
        else:
            self.reset()

    def reset(self) -> None:
        """Discard the tree (e.g. the game position jumped)."""
        self._root = TreeNode(None, 1.0)


class ParallelMCTS(MCTS):
    """Batched-leaf APV-MCTS.

    Per wave: select ``leaf_batch`` leaves under virtual loss, then one
    batched call each to ``batch_policy_fn(states) -> [priors, ...]``,
    ``batch_value_fn(states) -> [v, ...]`` and (if λ>0)
    ``batch_rollout_fn(states) -> [outcome, ...]`` -- so the net cost
    per playout drops by ~leaf_batch× against the sequential form. All
    callables stay injected (testable with plain lambdas).
    """

    def __init__(self, batch_value_fn, batch_policy_fn, batch_rollout_fn,
                 lmbda: float = 0.5, c_puct: float = 5.0,
                 rollout_limit: int = 500, playout_depth: int = 20,
                 n_playout: int = 10000, leaf_batch: int = 8, rng=None,
                 batch_policy_value_fn=None):
        super().__init__(batch_value_fn, batch_policy_fn, batch_rollout_fn,
                         lmbda=lmbda, c_puct=c_puct,
                         rollout_limit=rollout_limit,
                         playout_depth=playout_depth, n_playout=n_playout,
                         rng=rng)
        self._leaf_batch = leaf_batch
        # optional fused evaluator: (states, want_priors flags) →
        # (priors list, values) off ONE shared encode per wave
        self._pv = batch_policy_value_fn

    def get_move(self, state, n_playout: int | None = None):
        n = self._n_playout if n_playout is None else n_playout
        waves, rem = divmod(n, self._leaf_batch)
        for _ in range(waves):
            self._wave(state, self._leaf_batch)
        if rem:
            self._wave(state, rem)
        if self._root.is_leaf():
            return PASS_MOVE
        return max(self._root._children.items(),
                   key=lambda ac: ac[1]._n_visits)[0]

    def _wave(self, state, width: int) -> None:
        # descend under virtual loss applied to EVERY node on the path
        # (standard APV-MCTS: upper levels must look worse too, or
        # later descents in the wave re-trace the same line and leaf
        # diversity collapses); duplicate arrivals at the same node
        # (forced when the tree is tiny) share one evaluation
        paths = []                   # per playout: nodes under vloss
        leaves = []                  # per playout: its leaf node
        uniq_idx: dict = {}          # id(node) -> index below
        nodes, leaf_states = [], []
        for _ in range(width):
            st = state.copy()
            path: list = []
            node = self._descend(st, path)
            vpath = path or [node]
            for nd in vpath:
                nd.add_virtual_loss()
            paths.append(vpath)
            leaves.append(node)
            if id(node) not in uniq_idx:
                uniq_idx[id(node)] = len(nodes)
                nodes.append(node)
                leaf_states.append(st)

        live = [i for i, st in enumerate(leaf_states)
                if not st.is_end_of_game]
        need_priors = [i for i in live if nodes[i].is_leaf()]
        priors = [None] * len(nodes)
        values = np.zeros(len(nodes))
        if live:
            live_states = [leaf_states[i] for i in live]
            if self._pv is not None and self._lmbda < 1.0:
                # fused path: one shared encode for priors AND values
                need = set(need_priors)
                dists, vals = self._pv(live_states,
                                       [i in need for i in live])
                for k, i in enumerate(live):
                    if dists[k] is not None:
                        priors[i] = dists[k]
                values[live] += (1.0 - self._lmbda) * np.asarray(
                    vals, np.float64)
            else:
                if need_priors:
                    dists = self._policy(
                        [leaf_states[i] for i in need_priors])
                    for i, pri in zip(need_priors, dists):
                        priors[i] = pri
                if self._lmbda < 1.0:
                    vals = np.asarray(self._value(live_states),
                                      np.float64)
                    values[live] += (1.0 - self._lmbda) * vals
            if self._lmbda > 0.0:
                outs = np.asarray(
                    self._rollout([s.copy() for s in live_states]),
                    np.float64)
                values[live] += self._lmbda * outs
        for i, st in enumerate(leaf_states):
            if st.is_end_of_game:
                w = st.get_winner()
                values[i] = 0.0 if w == 0 else (
                    1.0 if w == st.current_player else -1.0)

        for vpath in paths:
            for nd in vpath:
                nd.revert_virtual_loss()
        for node in leaves:
            i = uniq_idx[id(node)]
            if priors[i]:
                node.expand(priors[i])
            node.update_recursive(-values[i])


# --------------------------------------------------------------- wiring


def device_rollout_fn(rollout_net, rollout_limit: int = 500,
                      temperature: float = 1.0, min_batch: int = 8,
                      seed: int = 0, noise=None):
    """``batch_rollout`` callable that plays a wave's leaves to the end
    wholly on the rollout net's device (no host ``do_move`` a ply).

    Bridges the host leaf states into one batched :class:`GoState`
    (``from_pygo`` without history -- the net's config has superko off
    -- and without labels, refilled by one labels launch), pads the
    wave to ``min_batch`` with *done* copies (they step nothing, and
    the rollout ends when every live game has), runs
    :func:`~.selfplay.make_device_rollout` and maps the area-scored
    winners back to each entry player's view.

    Scoring uses the game's komi, read from the wave's states, so the
    outcomes agree with the host path's ``get_winner()``; one rollout
    runner per komi. The draws come from one ``torch.Generator`` on the
    device seeded with ``seed``, or from ``noise(call)`` -- for the
    ``call``-th wave, a float32 ``[rollout_limit, min_batch, N]``
    tensor of Gumbel draws (the seam for the reference's key chain).
    ``batch_rollout.last_plies`` is the last wave's executed plies."""
    from rocalphago_tpu_torch.search.selfplay import make_device_rollout

    base_cfg = rollout_net.cfg
    device = rollout_net.device
    runs: dict = {}       # komi -> (cfg, rollout runner)
    generator = torch.Generator(device=device).manual_seed(seed)
    calls = [0]

    def for_komi(komi: float):
        if komi not in runs:
            cfg = dataclasses.replace(base_cfg, komi=komi)
            runs[komi] = (cfg, make_device_rollout(
                cfg, rollout_net.feature_list, rollout_net.forward,
                rollout_limit=rollout_limit, temperature=temperature,
                with_steps=True))
        return runs[komi]

    def batch_rollout(states):
        cfg, run = for_komi(float(states[0].komi))
        entry = [s.current_player for s in states]
        pad = max(min_batch - len(states), 0)
        batched = torchgo.from_pygo(
            cfg, list(states) + [states[0]] * pad, device=device,
            with_history=False, with_labels=False)
        if pad:
            done = batched.done.clone()
            done[len(states):] = True
            batched = batched._replace(done=done)
        batched = torchgo.seed_labels(cfg, batched)
        wave_noise = noise(calls[0]) if noise is not None else None
        calls[0] += 1
        winners, batch_rollout.last_plies = run(
            batched, generator=generator, noise=wave_noise)
        winners = winners.cpu().numpy()
        return [0.0 if w == 0 else (1.0 if w == p else -1.0)
                for w, p in zip(winners[:len(states)], entry)]

    batch_rollout.last_plies = None
    return batch_rollout


def net_backends(policy, value, rollout=None, rollout_limit: int = 500,
                 rng=None, symmetric: bool = False,
                 device_rollout: bool = False, leaf_batch: int = 8):
    """Batch callables for :class:`ParallelMCTS` from the nets: one
    forward per net a wave. Returns ``(batch_value, batch_policy,
    batch_rollout, batch_policy_value)``.

    ``rollout`` (a fast policy net, or the policy itself when none is
    given, as the reference does) drives lockstep playouts to the end:
    on host rules by default, one rollout forward a ply and numpy's
    ``rng.choice`` for the draw, or with ``device_rollout=True`` wholly
    on the card through :func:`device_rollout_fn`. ``symmetric``
    ensembles priors and values over the 8 board symmetries (8× the
    evaluation, rollouts excluded).

    When the value features are the policy features plus ``color`` (the
    AlphaGo 48/49 layout) and ``symmetric`` is off, ``batch_policy_value``
    pays the encode once a wave: the policy reads the first planes of
    the value net's encode. Otherwise it is None."""
    rng = rng or np.random.default_rng(0)

    def batch_policy(states):
        sensible = [s.get_legal_moves(include_eyes=False) for s in states]
        return policy.batch_eval_state(states, sensible,
                                       symmetric=symmetric)

    def batch_value(states):
        return value.batch_eval_state(states, symmetric=symmetric)

    batch_policy_value = None
    nested = (tuple(value.feature_list[:-1]) == tuple(policy.feature_list)
              and value.feature_list[-1] == "color")
    if nested and not symmetric:
        n_policy_planes = policy.preprocess.output_dim

        def batch_policy_value(states, want_priors):
            planes = value._states_to_planes(states)
            vals = value.values_from_planes(planes)
            priors = [None] * len(states)
            pidx = [i for i, w in enumerate(want_priors) if w]
            if pidx:
                sub = [states[i] for i in pidx]
                sensible = [s.get_legal_moves(include_eyes=False)
                            for s in sub]
                rows = torch.as_tensor(pidx, device=planes.device)
                pplanes = planes[rows][..., :n_policy_planes]
                for i, d in zip(pidx, policy.dists_from_planes(
                        sub, pplanes, sensible)):
                    priors[i] = d
            return priors, vals

    rollout_net = rollout or policy

    if device_rollout:
        return (batch_value, batch_policy,
                device_rollout_fn(rollout_net,
                                  rollout_limit=rollout_limit,
                                  min_batch=leaf_batch,
                                  seed=int(rng.integers(2**31))),
                batch_policy_value)

    def batch_rollout(states):
        entry_players = [s.current_player for s in states]
        for _ in range(rollout_limit):
            if all(s.is_end_of_game for s in states):
                break
            # the whole fixed-size batch every ply (finished games get
            # an empty support and are skipped)
            sens = [[] if s.is_end_of_game
                    else s.get_legal_moves(include_eyes=False)
                    for s in states]
            dists = rollout_net.batch_eval_state(states, sens)
            for st, dist in zip(states, dists):
                if st.is_end_of_game:
                    continue
                if not dist:
                    st.do_move(PASS_MOVE)
                    continue
                probs = np.asarray([p for _, p in dist], np.float64)
                probs /= probs.sum()
                st.do_move(dist[rng.choice(len(dist), p=probs)][0])
        outs = []
        for st, player in zip(states, entry_players):
            w = st.get_winner()
            outs.append(0.0 if w == 0 else (1.0 if w == player else -1.0))
        return outs

    return batch_value, batch_policy, batch_rollout, batch_policy_value


class MCTSPlayer:
    """The full AlphaGo agent: batched-leaf APV-MCTS over the policy,
    value and rollout nets (the reference's ``MCTSPlayer``).

    Subtree reuse is history-aware: the player records the move history
    its root stands for, re-roots along the opponent's move when the
    incoming state extends it by exactly one ply, and otherwise resets
    the tree, so a stale tree never searches the wrong position.

    Time control: ``set_move_time(seconds)`` (the GTP engine calls it)
    caps the next search at ``seconds ×`` the measured playouts/s
    (:class:`~.clock.MoveClock`, samples keyed per komi so each komi's
    first search, which builds its runners and pays cuDNN's algorithm
    choice, is left out), floored at one leaf wave. ``last_n_playout``
    is what the last search ran."""

    def __init__(self, value, policy, rollout=None, lmbda: float = 0.5,
                 c_puct: float = 5.0, rollout_limit: int = 500,
                 playout_depth: int = 20, n_playout: int = 100,
                 leaf_batch: int = 8, seed: int | None = None,
                 symmetric: bool = False, device_rollout: bool = False):
        self.board = policy.board   # GTP boardsize validation
        rng = np.random.default_rng(seed)
        bv, bp, br, bpv = net_backends(policy, value, rollout,
                                       rollout_limit=rollout_limit,
                                       rng=rng, symmetric=symmetric,
                                       device_rollout=device_rollout,
                                       leaf_batch=leaf_batch)
        self.mcts = ParallelMCTS(bv, bp, br, lmbda=lmbda, c_puct=c_puct,
                                 rollout_limit=rollout_limit,
                                 playout_depth=playout_depth,
                                 n_playout=n_playout,
                                 leaf_batch=leaf_batch, rng=rng,
                                 batch_policy_value_fn=bpv)
        self._tree_history: list | None = None
        self._clock = MoveClock()
        self.last_n_playout = None

    def set_move_time(self, seconds) -> None:
        """Per-move wall budget in seconds (None = no clock)."""
        self._clock.set_move_time(seconds)

    def _effective_playouts(self) -> int:
        allowed = self._clock.allowed_units()
        if allowed is None:
            return self.mcts._n_playout
        wave = self.mcts._leaf_batch
        return min(self.mcts._n_playout,
                   max(wave, allowed // wave * wave))

    def _sync_tree(self, history: list) -> None:
        if self._tree_history is None or history == self._tree_history:
            return
        n = len(self._tree_history)
        if len(history) == n + 1 and history[:n] == self._tree_history:
            self.mcts.update_with_move(history[-1])
        else:
            self.mcts.reset()

    def get_move(self, state):
        history = list(state.history)
        self._sync_tree(history)
        sensible = state.get_legal_moves(include_eyes=False)
        if state.is_end_of_game or not sensible:
            self._tree_history = None
            self.mcts.reset()
            return PASS_MOVE
        eff = self._effective_playouts()
        t0 = time.monotonic()
        move = self.mcts.get_move(state, n_playout=eff)
        self._clock.note(float(state.komi), eff, time.monotonic() - t0)
        self.last_n_playout = eff
        self.mcts.update_with_move(move)
        self._tree_history = history + [move]
        return move
