"""On-device batched PUCT search: the port of ``search/device_mcts.py``.

The tree lives on the card in fixed-shape slabs (``max_nodes`` per
game), and select → expand → evaluate → backup steps every game of the
batch in lockstep, so each policy and value forward runs at the full
batch and the host sends root states in and reads visit counts out.
Semantics are the reference's (PUCT selection, priors as a masked
softmax over sensible moves, value-net leaf evaluation, terminal leaves
scored by area, sign-alternating backup, a capacity-bounded slab that
keeps evaluating once full) and the trees are bit-identical to it
(``tests/test_torch_device_mcts.py``).

Where the reference runs the two tree walks as ``lax.while_loop``s, the
port runs the tree kernel (:mod:`rocalphago_tpu_torch.ops.tree`); with
it, the engine step, the group analysis, the encode (with its chase
launch), both forwards, terminal scoring (with its labels launch) and
the slab writes, a simulation makes no device→host sync, so the host
queues a chunk of simulations without waiting for the card.

The slabs are updated in place (:meth:`DeviceMCTS.apply_sim`), as XLA
updates the reference's donated buffers; :meth:`DeviceMCTS.run_sims`
and ``run_sims_chunked(owned=False)`` copy the tree first, so a
caller's tree is never changed under it.

Forced playouts at the root (``forced_k``) and their pruned policy
target (:meth:`DeviceMCTS.pruned_targets`) serve search self-play
(:func:`make_mcts_selfplay`: a fresh search per ply, optional Dirichlet
root noise, the move sampled from the root visits).

Not ported yet: the Gumbel root rule, the playout caps, per-row komi,
the incremental root encode and the serving seam's transposition keys
(later slices, ``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from rocalphago_tpu_torch.device import resolve_device
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.engine.torchgo import (
    GoConfig,
    GoState,
    group_data,
    new_states,
    step,
    winner,
)
from rocalphago_tpu_torch.features.planes import encode
from rocalphago_tpu_torch.features.pyfeatures import output_planes
from rocalphago_tpu_torch.ops import tree as tree_ops
from rocalphago_tpu_torch.runtime.deadline import Deadline
from rocalphago_tpu_torch.runtime.pipeline import ChunkPipeline
from rocalphago_tpu_torch.search.clock import MoveClock
from rocalphago_tpu_torch.search.selfplay import gumbel_argmax, sensible_mask


class SimStep(NamedTuple):
    """One simulation between SELECT/EXPAND and EVALUATE:
    :meth:`DeviceMCTS.prepare_sim` descends and steps, an evaluator
    scores ``eval_states``, :meth:`DeviceMCTS.apply_sim` writes the node
    and backs the value up."""

    node: torch.Tensor         # i32 [B] node the descent ended on
    safe_action: torch.Tensor  # i32 [B] selected edge (pass where none)
    expanding: torch.Tensor    # bool [B] True = a new leaf was stepped
    eval_states: GoState       # [B, ...] the states to evaluate: the
    #   stepped children where ``expanding``, else the terminal node


class DeviceTree(NamedTuple):
    """Per-game search slab (leading axis = game batch ``B``);
    ``A = N + 1`` actions (last = pass), ``M = max_nodes``."""

    states: GoState            # node states, fields [B, M, ...]
    prior: torch.Tensor        # f32 [B, M, A]
    visits: torch.Tensor       # i32 [B, M, A]
    value_sum: torch.Tensor    # f32 [B, M, A], the node player's view
    child: torch.Tensor        # i32 [B, M, A] node index, -1 unexpanded
    parent: torch.Tensor       # i32 [B, M]    -1 at the first root
    paction: torch.Tensor      # i32 [B, M]
    n_nodes: torch.Tensor      # i32 [B]
    root: torch.Tensor         # i32 [B] current root (advance_root)


def _state_at(states: GoState, idx: torch.Tensor) -> GoState:
    """Row ``b``'s node ``idx[b]`` out of ``[B, M, ...]`` slabs."""
    ar = torch.arange(idx.shape[0], device=idx.device)
    return GoState(*(x[ar, idx.long()] for x in states))


def _terminal_value(cfg: GoConfig, st: GoState) -> torch.Tensor:
    """Outcome in {-1, 0, 1} from the player to move's view."""
    return (winner(cfg, st) * st.turn).float()


def copy_tree(tree: DeviceTree) -> DeviceTree:
    return DeviceTree(GoState(*(x.clone() for x in tree.states)),
                      *(x.clone() for x in tree[1:]))


class DeviceMCTS:
    """The searcher of one configuration (see :func:`make_device_mcts`).

    Calling it searches a batch of roots: ``search(roots) ->
    (root_visits i32 [B, A], root_q f32 [B, A])``, ``root_q`` the mean
    backed-up value per root action from the root player's view (0
    where unvisited)."""

    def __init__(self, cfg: GoConfig, policy_features: tuple,
                 value_features: tuple, policy_fn: Callable,
                 value_fn: Callable, n_sim: int, max_nodes: int,
                 c_puct: float, forced_k: float = 0.0):
        self.cfg = cfg
        self.value_features = tuple(value_features)
        self.policy_fn = policy_fn
        self.value_fn = value_fn
        self.n_sim = n_sim
        self.max_nodes = max_nodes
        self.c_puct = float(c_puct)
        self.forced_k = float(forced_k)
        self.n_policy_planes = output_planes(policy_features)
        self.last_ran = None           # sims the last chunked run ran

    # ------------------------------------------------------ evaluation

    def _eval_from(self, states: GoState, gd, planes: torch.Tensor):
        sens = sensible_mask(self.cfg, states, gd)              # [B, N]
        logits = self.policy_fn(planes[..., :self.n_policy_planes])
        masked = torch.where(sens, logits, torch.finfo(logits.dtype).min)
        board_p = torch.softmax(masked, dim=-1)
        any_sens = sens.any(dim=-1, keepdim=True)
        board_p = torch.where(any_sens, board_p, 0.0)
        pass_p = torch.where(any_sens, 0.0, 1.0)
        priors = torch.cat([board_p, pass_p], dim=-1).float()
        values = self.value_fn(planes).float()
        values = torch.where(states.done,
                             _terminal_value(self.cfg, states), values)
        return priors, values

    @torch.no_grad()
    def eval_batch(self, states: GoState):
        """One evaluation of a batch of states: ``(priors f32 [B, A],
        values f32 [B])``. Priors are a float32 softmax over sensible
        moves (the rest filled with the type's minimum first); pass has
        probability 1 exactly when no move is sensible. Values are the
        value net's where live, the terminal outcome where done."""
        # no plane reads the dense member rows: the encode builds its
        # candidate bitmaps from the labels
        gd = group_data(self.cfg, states.board,
                        with_zxor=self.cfg.enforce_superko,
                        labels=states.labels)
        planes = encode(self.cfg, states, self.value_features, gd=gd)
        return self._eval_from(states, gd, planes)

    # ------------------------------------------------------ the slab

    def assemble_tree(self, roots: GoState,
                      root_priors: torch.Tensor) -> DeviceTree:
        b, m = roots.board.shape[0], self.max_nodes
        dev = roots.board.device
        a = self.cfg.num_points + 1
        # every slot starts as a fresh state; the root goes to slot 0
        slab = new_states(self.cfg, b * m, device=dev)
        slab = GoState(*(x.reshape((b, m) + x.shape[1:]) for x in slab))
        for buf, r in zip(slab, roots):
            buf[:, 0] = r
        prior = torch.zeros((b, m, a), dtype=torch.float32, device=dev)
        prior[:, 0] = root_priors
        return DeviceTree(
            states=slab, prior=prior,
            visits=torch.zeros((b, m, a), dtype=torch.int32, device=dev),
            value_sum=torch.zeros((b, m, a), dtype=torch.float32,
                                  device=dev),
            child=torch.full((b, m, a), -1, dtype=torch.int32, device=dev),
            parent=torch.full((b, m), -1, dtype=torch.int32, device=dev),
            paction=torch.zeros((b, m), dtype=torch.int32, device=dev),
            n_nodes=torch.ones((b,), dtype=torch.int32, device=dev),
            root=torch.zeros((b,), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def init(self, roots: GoState) -> DeviceTree:
        root_priors, _ = self.eval_batch(roots)
        return self.assemble_tree(roots, root_priors)

    # ------------------------------------------------ one simulation

    @torch.no_grad()
    def prepare_sim(self, tree: DeviceTree,
                    root_actions: torch.Tensor) -> SimStep:
        """SELECT + EXPAND: descend (the tree kernel), step the selected
        edge, and return the :class:`SimStep` whose ``eval_states`` an
        evaluator must score. ``root_actions`` (i32 [B], -1 = free)
        forces each game's first edge."""
        node, action = tree_ops.descend(
            tree.prior, tree.visits, tree.value_sum, tree.child,
            tree.states.done, tree.root, root_actions, self.c_puct,
            self.forced_k)
        parent_states = _state_at(tree.states, node)
        safe_action = torch.where(action >= 0, action, self.cfg.num_points)
        # a terminal descent steps a pass on a finished game: a no-op
        # whose result the evaluator never sees
        stepped = step(self.cfg, parent_states, safe_action)
        expanding = action >= 0
        return SimStep(node=node, safe_action=safe_action.int(),
                       expanding=expanding,
                       eval_states=torchgo.where_rows(
                           expanding, stepped, parent_states))

    @torch.no_grad()
    def apply_sim(self, tree: DeviceTree, ctx: SimStep, priors: torch.Tensor,
                  values: torch.Tensor) -> DeviceTree:
        """WRITE + BACKUP, in place: store the evaluated leaf where
        expanding and the slab is not full, then back ``values`` (the
        evaluation of ``ctx.eval_states``) up the path (the tree
        kernel). Returns ``tree``."""
        b = tree.n_nodes.shape[0]
        ar = torch.arange(b, device=tree.n_nodes.device)
        node, act = ctx.node.long(), ctx.safe_action.long()
        write = ctx.expanding & (tree.n_nodes < self.max_nodes)
        idx = torch.where(write, torch.clamp(tree.n_nodes,
                                             max=self.max_nodes - 1), 0)
        idx_l = idx.long()

        def put(buf, at, new):
            w = write.view((-1,) + (1,) * (new.dim() - 1))
            buf[at] = torch.where(w, new.to(buf.dtype), buf[at])

        for buf, new in zip(tree.states, ctx.eval_states):
            put(buf, (ar, idx_l), new)
        put(tree.prior, (ar, idx_l), priors)
        put(tree.child, (ar, node, act), idx)
        put(tree.parent, (ar, idx_l), ctx.node)
        put(tree.paction, (ar, idx_l), ctx.safe_action)
        tree.n_nodes.add_(write.int())

        # the backup starts on the edge INTO the evaluated state: the
        # selected edge for expansions (stored or not), the terminal
        # node's own parent edge otherwise (-1 at a terminal root: no
        # backup)
        start_node = torch.where(ctx.expanding, ctx.node,
                                 tree.parent[ar, node])
        start_action = torch.where(ctx.expanding, ctx.safe_action,
                                   tree.paction[ar, node])
        tree_ops.backup(tree.visits, tree.value_sum, tree.parent,
                        tree.paction, start_node.contiguous(),
                        start_action.contiguous(),
                        values.float().contiguous())
        return tree

    def _free(self, tree: DeviceTree) -> torch.Tensor:
        return torch.full_like(tree.n_nodes, -1)

    @torch.no_grad()
    def simulate(self, tree: DeviceTree,
                 root_actions: torch.Tensor | None = None) -> DeviceTree:
        """One lockstep simulation of every game, in place:
        :meth:`prepare_sim` → :meth:`eval_batch` → :meth:`apply_sim`."""
        if root_actions is None:
            root_actions = self._free(tree)
        ctx = self.prepare_sim(tree, root_actions)
        priors, values = self.eval_batch(ctx.eval_states)
        return self.apply_sim(tree, ctx, priors, values)

    # ------------------------------------------------------ driving

    @torch.no_grad()
    def run_sims(self, tree: DeviceTree, k: int) -> DeviceTree:
        """``k`` simulations on a copy of ``tree``."""
        tree = copy_tree(tree)
        for _ in range(k):
            self.simulate(tree)
        return tree

    @torch.no_grad()
    def run_sims_chunked(self, tree: DeviceTree, chunk: int,
                         n: int | None = None,
                         deadline: Deadline | None = None,
                         owned: bool = False):
        """``n`` simulations (default ``n_sim``) in chunks of ``chunk``,
        queued on the card one chunk ahead of the host
        (:class:`~..runtime.pipeline.ChunkPipeline`). ``deadline`` is
        checked before every chunk after the first (one chunk is the
        anytime floor); on expiry at most one more chunk is in flight,
        and its simulations count. ``owned=False`` works on a copy of
        ``tree``. Returns ``(tree, ran)``."""
        n = self.n_sim if n is None else n
        enforce = deadline is not None and not deadline.unlimited
        pipe = ChunkPipeline(tree.n_nodes.device)
        if not owned and n > 0:
            tree = copy_tree(tree)
        free = self._free(tree)
        ran = 0
        for done in range(0, n, chunk):
            if ran and enforce and deadline.expired():
                break
            k = min(chunk, n - done)
            for _ in range(k):
                self.simulate(tree, free)
            pipe.push()
            ran += k
        pipe.drain()
        return tree, ran

    @torch.no_grad()
    def run_chunked(self, roots: GoState, chunk: int,
                    tree: DeviceTree | None = None,
                    deadline: Deadline | None = None, owned: bool = False,
                    n: int | None = None):
        """A whole search as chunks (see :meth:`run_sims_chunked`), from
        ``init(roots)`` or from a prepared ``tree``; returns
        :meth:`root_stats`."""
        if tree is None:
            tree = self.init(roots)
            owned = True
        tree, self.last_ran = self.run_sims_chunked(
            tree, chunk, n=n, deadline=deadline, owned=owned)
        return self.root_stats(tree)

    @torch.no_grad()
    def __call__(self, roots: GoState):
        tree = self.init(roots)
        for _ in range(self.n_sim):
            self.simulate(tree)
        return self.root_stats(tree)

    @staticmethod
    def root_stats(tree: DeviceTree):
        """``(visits i32 [B, A], q f32 [B, A])`` at each game's root."""
        ar = torch.arange(tree.root.shape[0], device=tree.root.device)
        r = tree.root.long()
        visits = tree.visits[ar, r]
        vsum = tree.value_sum[ar, r]
        q = torch.where(visits > 0,
                        vsum / torch.clamp(visits.float(), min=1.0), 0.0)
        return visits, q

    def pruned_targets(self, tree: DeviceTree):
        """Policy target with the forced playouts pruned back out (the
        KataGo rule): every root child but the most visited loses its
        forced floor ``sqrt(forced_k * p * N)``, children left under one
        visit drop to 0, the most visited keeps all its visits, and the
        rest is normalised. ``(target f32 [B, A] summing to 1 on a
        searched row, pruned i32 [B] visits removed)``; at ``forced_k =
        0`` the target is the normalised visit count. The floor is
        computed in the order XLA compiles the reference's to."""
        visits, _ = self.root_stats(tree)
        ar = torch.arange(tree.root.shape[0], device=tree.root.device)
        prior = tree.prior[ar, tree.root.long()]
        nv = visits.float()
        total = nv.sum(dim=-1, keepdim=True)
        floor = torch.sqrt(prior * (total * self.forced_k))
        on_best = (torch.arange(nv.shape[-1], device=nv.device)[None, :]
                   == torch.argmax(nv, dim=-1)[:, None])
        kept = torch.clamp(nv - floor, min=0.0)
        kept = torch.where(kept < 1.0, 0.0, kept)
        kept = torch.where(on_best, nv, kept)
        norm = kept.sum(dim=-1, keepdim=True)
        target = torch.where(norm > 0, kept / torch.clamp(norm, min=1.0),
                             0.0)
        return target, (total - norm)[:, 0].int()

    @staticmethod
    def advance_root(tree: DeviceTree, actions: torch.Tensor):
        """Move each game's root down its ``actions`` edge (subtree
        reuse after a move). Returns ``(tree, ok bool [B])``; where the
        edge is unexpanded the root stays and the caller rebuilds."""
        ar = torch.arange(tree.root.shape[0], device=tree.root.device)
        nxt = tree.child[ar, tree.root.long(), actions.long()]
        ok = nxt >= 0
        return tree._replace(root=torch.where(ok, nxt, tree.root)), ok


def make_device_mcts(cfg: GoConfig, policy_features: tuple,
                     value_features: tuple, policy_fn: Callable,
                     value_fn: Callable, n_sim: int,
                     max_nodes: int | None = None,
                     c_puct: float = 5.0,
                     forced_k: float = 0.0) -> DeviceMCTS:
    """Build the searcher. ``policy_fn(planes) -> logits f32 [B, N]``
    and ``value_fn(planes) -> values [B]`` take NHWC float32 planes;
    ``value_features`` must be ``policy_features + ("color",)`` (the
    nested 48/49 layout), so one encode serves both nets, the policy
    reading the leading planes. ``max_nodes=None`` sizes the slab to
    ``2 * n_sim``. ``forced_k > 0`` turns on forced playouts at the root
    (:func:`~rocalphago_tpu_torch.ops.tree.descend`); serving keeps
    0."""
    if max_nodes is None:
        max_nodes = 2 * n_sim
    if tuple(value_features[:-1]) != tuple(policy_features) or \
            value_features[-1] != "color":
        raise ValueError(
            "device MCTS requires the nested feature layout: "
            "value_features == policy_features + ('color',); got "
            f"{policy_features} / {value_features}")
    return DeviceMCTS(cfg, policy_features, value_features, policy_fn,
                      value_fn, n_sim, max_nodes, c_puct, forced_k)


class DeviceMCTSPlayer:
    """GTP-facing agent over the device search (PUCT).

    ``get_move(pygo.GameState) -> move | None`` (None = pass): the host
    state is bridged once (``from_pygo`` and one labels launch; the
    root is encoded from scratch), the search runs on the card in
    chunks of ``sim_chunk`` simulations, and the most-visited move
    comes back.

    Subtree reuse: the tree is carried across ``get_move`` calls and its
    root walked down the moves actually played, so a search resumes
    from the visits already spent below that child. It falls back to a
    fresh tree on a komi or board change, an undo, an unexpanded edge,
    a slab more than three quarters full, or a position that does not
    match (stones placed outside the history); ``reuses`` counts the
    reused searches.

    Time: ``set_move_time(seconds)`` (from the GTP time commands) caps
    the next searches at ``seconds × measured sims/sec``, in whole
    chunks; the first search of each searcher runs the full budget and
    seeds the rate. The same budget arms a :class:`Deadline` checked
    between chunks; ``last_deadline_hit`` and ``deadline_hits`` report
    it and ``last_n_sim`` what the last search ran. ``sim_limit``
    (None = none) caps every search.
    """

    def __init__(self, value_net, policy_net, n_sim: int = 100,
                 max_nodes: int | None = None, c_puct: float = 5.0,
                 sim_chunk: int = 8, gumbel: bool = False):
        if gumbel:
            raise NotImplementedError(
                "the Gumbel root search is not ported yet (a later "
                "device-search slice); use the PUCT player")
        self.policy = policy_net
        self.value = value_net
        self.board = policy_net.board
        self.device = policy_net.device
        self._cfg = policy_net.cfg
        self._chunk = sim_chunk
        self._n_sim = n_sim
        self._max_nodes = max_nodes
        self._c_puct = c_puct
        self._carry = None
        self.reuses = 0
        self._clock = MoveClock()
        self.last_n_sim = None
        self.last_deadline_hit = False
        self.deadline_hits = 0
        self.sim_limit: int | None = None
        # one searcher per komi: terminal leaves score with its komi
        self._searchers: dict = {}
        # build the default-komi searcher now, so a feature-layout
        # mismatch fails at construction and not on the first genmove
        self._max_nodes = self._searcher_for(self._cfg.komi)[1].max_nodes

    @property
    def n_sim(self) -> int:
        """Nominal per-move simulation budget (uncapped)."""
        return self._n_sim

    def reset(self) -> None:
        """Forget the carried subtree (a new game)."""
        self._carry = None

    def set_move_time(self, seconds) -> None:
        """Per-move wall budget in seconds (None = no clock)."""
        self._clock.set_move_time(seconds)

    def _effective_sims(self) -> int:
        """Simulations for the next search: ``move_time × sims/sec`` in
        whole chunks, at least one chunk, at most ``n_sim``; the full
        budget with no clock or no rate yet."""
        allowed = self._clock.allowed_units()
        if self.sim_limit is not None:
            allowed = (self.sim_limit if allowed is None
                       else min(allowed, self.sim_limit))
        if allowed is None:
            return self._n_sim
        return min(self._n_sim,
                   max(self._chunk, allowed // self._chunk * self._chunk))

    def _searcher_for(self, komi: float):
        key = (komi, self._n_sim)
        if key not in self._searchers:
            cfg = dataclasses.replace(self._cfg, komi=komi)
            self._searchers[key] = (cfg, make_device_mcts(
                cfg, self.policy.feature_list, self.value.feature_list,
                self.policy.module, self.value.module, n_sim=self._n_sim,
                max_nodes=self._max_nodes, c_puct=self._c_puct))
        return self._searchers[key]

    def _reused_tree(self, search: DeviceMCTS, state, komi: float,
                     bridged: GoState):
        """The carried tree with its root walked down the moves played
        since; None when a fresh tree is needed."""
        if self._carry is None:
            return None
        ck, csize, cturns, tree = self._carry
        if (ck != komi or csize != state.size
                or state.turns_played < cturns):
            return None
        n = csize * csize
        for mv in state.history[cturns:]:
            a = n if mv is None else mv[0] * csize + mv[1]
            tree, ok = search.advance_root(
                tree, torch.tensor([a], device=self.device))
            if not bool(ok[0]):
                return None
        if int(tree.n_nodes[0]) > 0.75 * self._max_nodes:
            return None                # slab nearly full: rebuild
        # the reused root must be the position asked about (board,
        # turn, ko): handicap stones and the like are outside the
        # history walk
        r = int(tree.root[0])
        same = (torch.equal(tree.states.board[0, r], bridged.board[0])
                and int(tree.states.turn[0, r]) == int(bridged.turn[0])
                and int(tree.states.ko[0, r]) == int(bridged.ko[0]))
        return tree if same else None

    @torch.no_grad()
    def get_move(self, state):
        komi = float(state.komi)
        eff = self._effective_sims()
        skey = (komi, self._n_sim)
        cfg, search = self._searcher_for(komi)
        root = torchgo.seed_labels(cfg, torchgo.from_pygo(
            cfg, [state], device=self.device, with_labels=False))
        # the clock plans eff simulations; the deadline enforces the
        # budget between chunks once the rate is measured (the first
        # search of a searcher pays the builds)
        deadline = Deadline.after(
            self._clock.move_time if self._clock.rate is not None
            else None)
        t0 = time.monotonic()
        tree = self._reused_tree(search, state, komi, root)
        if tree is not None:
            self.reuses += 1
        else:
            tree = search.init(root)
        # the search updates the tree in place: drop the carry first,
        # so a search that fails half way is never walked again
        self._carry = None
        tree, ran = search.run_sims_chunked(tree, self._chunk, n=eff,
                                            deadline=deadline, owned=True)
        visits, _ = search.root_stats(tree)
        counts = visits[0].cpu().numpy()
        action = int(np.argmax(counts))
        self._carry = (komi, state.size, state.turns_played, tree)
        self.last_deadline_hit = ran < eff
        self.deadline_hits += int(self.last_deadline_hit)
        self._clock.note(skey, ran, time.monotonic() - t0)
        self.last_n_sim = ran
        if action >= cfg.num_points or counts[action] == 0:
            return None                                  # pass
        return divmod(action, cfg.size)


def make_mcts_selfplay(cfg: GoConfig, policy_features: tuple,
                       value_features: tuple, policy_fn: Callable,
                       value_fn: Callable, batch: int, max_moves: int,
                       n_sim: int, max_nodes: int | None = None,
                       c_puct: float = 5.0, temperature: float = 1.0,
                       sim_chunk: int = 8, record_visits: bool = False,
                       dirichlet_alpha: float = 0.0,
                       noise_frac: float = 0.25, forced_k: float = 0.0,
                       device=None):
    """Search self-play, PUCT: every move of every game comes from a
    fresh search over the batch (:func:`make_device_mcts`, ``n_sim``
    simulations in chunks of ``sim_chunk``, no subtree reuse), and the
    move is sampled from the root visits ``∝ visits^(1/temperature)``
    (argmax at temperature 0). One net plays both colours.

    ``dirichlet_alpha > 0`` mixes root noise into each ply's root priors
    before the simulations: ``p ← (1 − ε)·p + ε·Dir(α)`` over the
    prior-supported actions, ``ε = noise_frac``. The gamma draws behind
    ``Dir(α)`` are made on the host by the caller's
    ``numpy.random.Generator`` (one ``[B, A]`` draw per ply) and copied
    to the card; torch's gamma sampler takes no generator.

    ``forced_k > 0``: forced playouts at the root, and the recorded
    target is :meth:`DeviceMCTS.pruned_targets` (f32); the move is still
    sampled from the raw visits.

    Returns ``run(generator, noise_rng=None) -> (final GoState, actions
    i32 [T, B], live bool [T, B])``, and ``targets [T, B, A]`` after
    them with ``record_visits`` (i32 root visits, or the f32 pruned
    targets under ``forced_k``). The loop stops after the ply on which
    every game has ended (a host read of the done flags per ply).
    ``run.search_ply``, ``run.pick_and_step`` and ``run.add_root_noise``
    are its parts; ``run.search`` is the searcher."""
    dev = resolve_device(device)
    search = make_device_mcts(cfg, policy_features, value_features,
                              policy_fn, value_fn, n_sim, max_nodes,
                              c_puct, forced_k=forced_k)
    n_act = cfg.num_points + 1

    def sample_weighted(weights: torch.Tensor,
                        generator: torch.Generator) -> torch.Tensor:
        """An action per game ``∝ weights^(1/temperature)``; argmax at
        temperature 0."""
        if temperature > 0:
            logits = torch.where(
                weights > 0,
                torch.log(torch.clamp(weights, min=1e-9)) / temperature,
                float("-inf"))
            return gumbel_argmax(logits, generator).int()
        return torch.argmax(weights, dim=-1).int()

    @torch.no_grad()
    def pick_and_step(states: GoState, visits: torch.Tensor,
                      generator: torch.Generator):
        """``(new states, action i32 [B], live bool [B])``."""
        action = sample_weighted(visits.float(), generator)
        return step(cfg, states, action), action, ~states.done

    @torch.no_grad()
    def add_root_noise(tree: DeviceTree, gamma: torch.Tensor) -> DeviceTree:
        """Mix ``Dir(α)``, normalised from the gamma draws ``gamma``
        (f32 ``[B, A]``), into the root priors, in place."""
        p0 = tree.prior[:, 0]
        valid = p0 > 0
        gam = torch.where(valid, gamma, 0.0)
        dirichlet = gam / torch.clamp(gam.sum(dim=-1, keepdim=True),
                                      min=1e-12)
        tree.prior[:, 0] = torch.where(
            valid, (1.0 - noise_frac) * p0 + noise_frac * dirichlet, 0.0)
        return tree

    @torch.no_grad()
    def search_ply(states: GoState, gamma: torch.Tensor | None = None):
        """One ply's search: ``(root visits i32 [B, A], target)``."""
        tree = search.init(states)
        if gamma is not None:
            add_root_noise(tree, gamma)
        tree, _ = search.run_sims_chunked(tree, sim_chunk, owned=True)
        visits, _ = search.root_stats(tree)
        target = search.pruned_targets(tree)[0] if forced_k else visits
        return visits, target

    def run(generator: torch.Generator,
            noise_rng: np.random.Generator | None = None):
        if dirichlet_alpha > 0 and noise_rng is None:
            raise ValueError("root noise needs a numpy noise_rng")
        states = new_states(cfg, batch, device=dev)
        actions, lives, targets = [], [], []
        for _ in range(max_moves):
            gamma = None
            if dirichlet_alpha > 0:
                gamma = torch.as_tensor(
                    noise_rng.gamma(dirichlet_alpha, size=(batch, n_act)),
                    dtype=torch.float32).to(dev)
            visits, target = search_ply(states, gamma)
            states, action, live = pick_and_step(states, visits, generator)
            actions.append(action)
            lives.append(live)
            if record_visits:
                targets.append(target)
            if bool(states.done.all()):
                break
        out = (states,
               torch.stack(actions) if actions else torch.zeros(
                   (0, batch), dtype=torch.int32, device=dev),
               torch.stack(lives) if lives else torch.zeros(
                   (0, batch), dtype=torch.bool, device=dev))
        if record_visits:
            tdtype = torch.float32 if forced_k else torch.int32
            out += (torch.stack(targets) if targets else torch.zeros(
                (0, batch, n_act), dtype=tdtype, device=dev),)
        return out

    run.search = search
    run.search_ply = search_ply
    run.pick_and_step = pick_and_step
    run.add_root_noise = add_root_noise
    return run
