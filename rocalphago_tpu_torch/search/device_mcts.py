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

The Gumbel root rule (:class:`GumbelMCTS`, :func:`make_gumbel_mcts`):
Gumbel-top-k root candidates and sequential halving over them, every
simulation forcing its root edge through the same tree kernel; it
serves GTP (``DeviceMCTSPlayer(gumbel=True)``) and search self-play.

Forced playouts at the root (``forced_k``) and their pruned policy
target (:meth:`DeviceMCTS.pruned_targets`) serve search self-play
(:func:`make_mcts_selfplay`: a fresh search per ply, PUCT with optional
Dirichlet root noise and the move sampled from the root visits, or
Gumbel playing the halving winner or sampling π′).

Playout caps (``budget=`` on :meth:`DeviceMCTS.run_sims_chunked` and
:meth:`GumbelMCTS.run_chunked`, ``cap_p`` / ``cap_cheap`` /
``cap_per_row`` on :func:`make_mcts_selfplay`): a row past its
simulation budget keeps its slab bit for bit. The mask is plain PyTorch
inside :meth:`DeviceMCTS.apply_sim` -- a retired row writes no node and
backs nothing up (its backup starts at node -1, which the tree kernel
skips) -- so the tree kernel is unchanged and the mask adds no host
sync.

The serving seam (the serve pool, :mod:`rocalphago_tpu_torch.serve`):
:meth:`DeviceMCTS.prepare_sim` and :meth:`DeviceMCTS.apply_sim` split a
simulation around an external evaluator, :meth:`DeviceMCTS.
eval_with` evaluates with a given pair of nets (a params version of the
pool), :meth:`DeviceMCTS.eval_batch_komi` rescoring terminal rows under
a komi per row, and :meth:`DeviceMCTS.eval_key` and
``SimStep.eval_keys`` give the transposition-cache keys. The keys are
computed only when asked for (``keys=True``): the reference's compiler
drops them from its fused path, and the port's eager path would
otherwise pay their launches on every simulation.

The incremental root encode (:meth:`DeviceMCTS.init_cached`,
:meth:`GumbelMCTS.init_cached`, ``run_chunked(caches=)``): the root
planes through :func:`~..features.incremental.encode_step` and a cache
the caller carries from one root to the next (the player carries one
across moves and komi changes), bit-identical priors.

Telemetry, the reference's names: ``device_mcts_chunk_seconds``,
``device_mcts_sims_per_s``, ``device_mcts_deadline_margin_s`` and
``device_mcts_sims_total`` from the chunk loops, the fault barrier
``search.chunk`` before every chunk, the player's
``device_mcts_get_move_seconds``, and search self-play's
``selfplay_ply_seconds``, ``selfplay_sims_per_move``,
``selfplay_fullsearch_frac`` and ``policy_targets_pruned_total``.
Rates and margins are read only where the loop already waits for the
card (a deadline drains the pipeline; a get_move reads the visits).
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
    area_scores,
    group_data,
    new_states,
    step,
    winner,
)
from rocalphago_tpu_torch.features.api import (
    count_cache_reset,
    observe_incremental,
)
from rocalphago_tpu_torch.features.incremental import (
    encode_step,
    init_cache,
)
from rocalphago_tpu_torch.features.planes import encode
from rocalphago_tpu_torch.features.pyfeatures import output_planes
from rocalphago_tpu_torch.obs import registry as obs_registry
from rocalphago_tpu_torch.ops import tree as tree_ops
from rocalphago_tpu_torch.runtime import faults
from rocalphago_tpu_torch.runtime.deadline import Deadline
from rocalphago_tpu_torch.runtime.pipeline import ChunkPipeline
from rocalphago_tpu_torch.search.clock import MoveClock
from rocalphago_tpu_torch.search.selfplay import (
    gumbel_argmax,
    gumbel_noise,
    sensible_mask,
)


#: whether :class:`DeviceMCTSPlayer` encodes its roots incrementally by
#: default: the mode the card measured faster (PERF.md §6)
INCREMENTAL_DEFAULT = True


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
    eval_keys: torch.Tensor | None = None  # int64 [B, 2] (uint32 words)
    #   eval signature of each ``eval_states`` row, the serve pool's
    #   transposition-cache key; None unless asked for


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


def _terminal_value_komi(cfg: GoConfig, st: GoState,
                         komi: torch.Tensor) -> torch.Tensor:
    """:func:`_terminal_value` rescored under a komi per row (f32
    ``[B]``) instead of ``cfg.komi``: ``area_scores`` counts
    ``cfg.komi`` into white's total, so the margin shifts by the komi
    difference -- exactly ``0.0`` at ``komi == cfg.komi``, where the
    result is :func:`_terminal_value`'s."""
    b, w = area_scores(cfg, st)
    # a Python float meets a float32 tensor in float32: no host copy
    margin = (b - w) + (cfg.komi - komi.to(torch.float32))
    return (torch.sign(margin) * st.turn).float()


def copy_tree(tree: DeviceTree) -> DeviceTree:
    return DeviceTree(GoState(*(x.clone() for x in tree.states)),
                      *(x.clone() for x in tree[1:]))


def _search_metrics():
    """The chunk loops' metrics, hoisted per searcher (both searchers
    share the names): ``(sims/s histogram, deadline margin gauge, sims
    counter)``. The reference observes ``device_mcts_chunk_seconds``
    only at pipeline depth 0; the port's pipeline keeps one chunk in
    flight, so it is registered and stays empty, as the reference's
    does at its default depth."""
    obs_registry.histogram("device_mcts_chunk_seconds")
    return (obs_registry.histogram("device_mcts_sims_per_s",
                                   edges=obs_registry.RATE_EDGES),
            obs_registry.gauge("device_mcts_deadline_margin_s"),
            obs_registry.counter("device_mcts_sims_total"))


def _note_search(metrics, ran: int, t_start: float, deadline, enforce: bool):
    """Record a drained chunk loop: the simulations, and under a
    deadline the rate and the margin left."""
    rate_h, margin_g, sims_c = metrics
    sims_c.inc(ran)
    if enforce:
        elapsed = time.monotonic() - t_start
        if elapsed > 0:
            rate_h.observe(ran / elapsed)
        rem = deadline.remaining()
        if rem is not None:
            margin_g.set(rem)


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
        self._metrics = _search_metrics()

    # ------------------------------------------------------ evaluation

    def _eval_from(self, states: GoState, gd, planes: torch.Tensor,
                   policy_fn: Callable, value_fn: Callable,
                   komi: torch.Tensor | None = None):
        sens = sensible_mask(self.cfg, states, gd)              # [B, N]
        logits = policy_fn(planes[..., :self.n_policy_planes])
        masked = torch.where(sens, logits, torch.finfo(logits.dtype).min)
        board_p = torch.softmax(masked, dim=-1)
        any_sens = sens.any(dim=-1, keepdim=True)
        board_p = torch.where(any_sens, board_p, 0.0)
        pass_p = torch.where(any_sens, 0.0, 1.0)
        priors = torch.cat([board_p, pass_p], dim=-1).float()
        values = value_fn(planes).float()
        term = (_terminal_value(self.cfg, states) if komi is None
                else _terminal_value_komi(self.cfg, states, komi))
        values = torch.where(states.done, term, values)
        return priors, values

    @torch.no_grad()
    def eval_with(self, policy_fn: Callable, value_fn: Callable,
                  states: GoState, komi: torch.Tensor | None = None):
        """One evaluation of a batch of states with the given nets:
        ``(priors f32 [B, A], values f32 [B])``. Priors are a float32
        softmax over sensible moves (the rest filled with the type's
        minimum first); pass has probability 1 exactly when no move is
        sensible. Values are the value net's where live, the terminal
        outcome where done -- under ``cfg.komi``, or with ``komi`` (f32
        ``[B]``) under each row's own komi."""
        # no plane reads the dense member rows: the encode builds its
        # candidate bitmaps from the labels
        gd = group_data(self.cfg, states.board,
                        with_zxor=self.cfg.enforce_superko,
                        labels=states.labels)
        planes = encode(self.cfg, states, self.value_features, gd=gd)
        return self._eval_from(states, gd, planes, policy_fn, value_fn,
                               komi)

    def eval_batch(self, states: GoState):
        """:meth:`eval_with` on the searcher's own nets."""
        return self.eval_with(self.policy_fn, self.value_fn, states)

    def eval_batch_komi(self, states: GoState, komi: torch.Tensor):
        """:meth:`eval_batch` with a komi per row (f32 ``[B]``):
        terminal rows score as if played under ``komi[i]``; rows at
        ``cfg.komi`` score as :meth:`eval_batch`'s bit for bit."""
        return self.eval_with(self.policy_fn, self.value_fn, states, komi)

    def eval_key(self, states: GoState) -> torch.Tensor:
        """The eval signatures of a batch of states (int64 ``[B, 2]``,
        :func:`~rocalphago_tpu_torch.engine.torchgo.eval_signature`):
        the transposition-cache keys of rows that do not come through
        :meth:`prepare_sim` (root evaluations)."""
        return torchgo.eval_signature(self.cfg, states)

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

    @torch.no_grad()
    def init_cached(self, roots: GoState, caches):
        """:meth:`init` with the root planes through the incremental
        encoder: ``(tree, caches')``, the same tree. The caller carries
        ``caches`` (:func:`~..features.incremental.init_caches`, one a
        root) from one root to the next."""
        gd = group_data(self.cfg, roots.board,
                        with_zxor=self.cfg.enforce_superko,
                        labels=roots.labels)
        planes, caches = encode_step(self.cfg, roots, caches,
                                     self.value_features, gd=gd)
        priors, _ = self._eval_from(roots, gd, planes, self.policy_fn,
                                    self.value_fn)
        return self.assemble_tree(roots, priors), caches

    # ------------------------------------------------ one simulation

    @torch.no_grad()
    def prepare_sim(self, tree: DeviceTree, root_actions: torch.Tensor,
                    keys: bool = False) -> SimStep:
        """SELECT + EXPAND: descend (the tree kernel), step the selected
        edge, and return the :class:`SimStep` whose ``eval_states`` an
        evaluator must score. ``root_actions`` (i32 [B], -1 = free)
        forces each game's first edge; ``keys`` fills
        ``SimStep.eval_keys``."""
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
        eval_states = torchgo.where_rows(expanding, stepped, parent_states)
        return SimStep(node=node, safe_action=safe_action.int(),
                       expanding=expanding, eval_states=eval_states,
                       eval_keys=(self.eval_key(eval_states) if keys
                                  else None))

    @torch.no_grad()
    def apply_sim(self, tree: DeviceTree, ctx: SimStep, priors: torch.Tensor,
                  values: torch.Tensor,
                  active: torch.Tensor | None = None) -> DeviceTree:
        """WRITE + BACKUP, in place: store the evaluated leaf where
        expanding and the slab is not full, then back ``values`` (the
        evaluation of ``ctx.eval_states``) up the path (the tree
        kernel). ``active`` (bool ``[B]``, None = every row) retires the
        other rows: they write nothing and back nothing up, so their
        slabs stay bit for bit (the reference's ``_where_rows`` of a
        budget-masked simulation). Returns ``tree``."""
        b = tree.n_nodes.shape[0]
        ar = torch.arange(b, device=tree.n_nodes.device)
        node, act = ctx.node.long(), ctx.safe_action.long()
        write = ctx.expanding & (tree.n_nodes < self.max_nodes)
        if active is not None:
            write = write & active
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
        if active is not None:
            start_node = torch.where(active, start_node, -1)
        tree_ops.backup(tree.visits, tree.value_sum, tree.parent,
                        tree.paction, start_node.contiguous(),
                        start_action.contiguous(),
                        values.float().contiguous())
        return tree

    def _free(self, tree: DeviceTree) -> torch.Tensor:
        return torch.full_like(tree.n_nodes, -1)

    @torch.no_grad()
    def simulate(self, tree: DeviceTree,
                 root_actions: torch.Tensor | None = None,
                 active: torch.Tensor | None = None) -> DeviceTree:
        """One lockstep simulation of every game, in place:
        :meth:`prepare_sim` → :meth:`eval_batch` → :meth:`apply_sim`
        (``active`` as there)."""
        if root_actions is None:
            root_actions = self._free(tree)
        ctx = self.prepare_sim(tree, root_actions)
        priors, values = self.eval_batch(ctx.eval_states)
        return self.apply_sim(tree, ctx, priors, values, active)

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
                         owned: bool = False,
                         budget: torch.Tensor | None = None):
        """``n`` simulations (default ``n_sim``) in chunks of ``chunk``,
        queued on the card one chunk ahead of the host
        (:class:`~..runtime.pipeline.ChunkPipeline`). ``deadline`` is
        checked before every chunk after the first (one chunk is the
        anytime floor); on expiry at most one more chunk is in flight,
        and its simulations count. ``owned=False`` works on a copy of
        ``tree``. ``budget`` (i32 ``[B]``, the playout caps) runs
        simulation ``j`` only on the rows whose budget exceeds ``j``;
        the others keep their slabs bit for bit. Callers pass ``n =
        max(budget)`` (host-known) so the loop stops there. Returns
        ``(tree, ran)``."""
        n = self.n_sim if n is None else n
        if budget is not None:
            budget = budget.to(torch.int32)
        enforce = deadline is not None and not deadline.unlimited
        pipe = ChunkPipeline(tree.n_nodes.device, runner="device_mcts")
        if not owned and n > 0:
            tree = copy_tree(tree)
        free = self._free(tree)
        ran = 0
        t_start = time.monotonic()
        for done in range(0, n, chunk):
            if ran and enforce and deadline.expired():
                break
            faults.barrier("search.chunk", done // chunk)
            k = min(chunk, n - done)
            for i in range(k):
                self.simulate(tree, free, None if budget is None
                              else budget > done + i)
            pipe.push()
            ran += k
        pipe.drain()
        _note_search(self._metrics, ran, t_start, deadline, enforce)
        return tree, ran

    @torch.no_grad()
    def run_chunked(self, roots: GoState, chunk: int,
                    tree: DeviceTree | None = None,
                    deadline: Deadline | None = None, owned: bool = False,
                    n: int | None = None,
                    budget: torch.Tensor | None = None):
        """A whole search as chunks (see :meth:`run_sims_chunked`), from
        ``init(roots)`` or from a prepared ``tree``; returns
        :meth:`root_stats`. ``last_ran`` holds the simulations run."""
        if tree is None:
            tree = self.init(roots)
            owned = True
        tree, self.last_ran = self.run_sims_chunked(
            tree, chunk, n=n, deadline=deadline, owned=owned, budget=budget)
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


def _halving_schedule(n_sim: int, m: int) -> list[tuple[int, int]]:
    """Sequential-halving plan: ``[(k_candidates, visits_per_cand)]``.

    The candidate count halves each phase (m, m//2, …, 2); the budget is
    split evenly across phases, and what the integer division leaves
    goes to the final 2-candidate phase. Every phase visits each
    survivor at least once, so for a tiny ``n_sim`` the plan's total
    exceeds ``n_sim``."""
    ks, k = [], m
    while k >= 2:
        ks.append(k)
        k //= 2
    p = len(ks)
    sched = [(k, max(1, n_sim // (p * k))) for k in ks]
    used = sum(k * v for k, v in sched)
    leftover = n_sim - used
    if leftover >= ks[-1]:
        k, v = sched[-1]
        sched[-1] = (k, v + leftover // k)
    return sched


def gumbel_plan_sims(n_sim: int, m_root: int, num_actions: int) -> int:
    """Simulations a Gumbel search's halving plan really runs (e.g. 30
    for n_sim 8 and m_root 16); slabs are sized from this."""
    m = max(2, min(m_root, num_actions))
    return sum(k * v for k, v in _halving_schedule(n_sim, m))


class GumbelMCTS:
    """Gumbel root search over the device tree (Danihelka et al. 2022),
    built by :func:`make_gumbel_mcts` over a :class:`DeviceMCTS`.

    The root draws ``m`` candidates without replacement by Gumbel-top-k
    on the masked prior logits (``g = logits + Gumbel noise``), then
    runs sequential halving (:func:`_halving_schedule`): in each phase
    every survivor is forced as the root edge of the same number of
    simulations (below the root, selection stays PUCT), and the
    candidates are re-ranked by ``g + σ(q̂)`` so the next phase keeps the
    better half. ``best`` is the last survivor; ``π′ = softmax(logits +
    σ)`` is the improved policy.

    The noise is a ``[B, A]`` float32 draw, ``-log(-log(u))`` with ``u``
    uniform in ``[finfo.tiny, 1)`` from the caller's generator
    (:meth:`draw_noise`), or a given ``noise=`` tensor."""

    def __init__(self, base: DeviceMCTS, m: int, c_visit: float,
                 c_scale: float):
        self.base = base
        self.cfg = base.cfg
        self.max_nodes = base.max_nodes
        self.m_root = m
        self.schedule = _halving_schedule(base.n_sim, m)
        self.plan_sims = sum(k * v for k, v in self.schedule)
        self.c_visit = float(c_visit)
        self.c_scale = float(c_scale)
        self.root_stats = base.root_stats
        self.last_ran = None           # sims the last chunked run ran
        self.last_caches = None        # the last run_chunked's caches
        self._metrics = _search_metrics()

    def draw_noise(self, batch: int,
                   generator: torch.Generator) -> torch.Tensor:
        """Standard Gumbel noise f32 ``[batch, A]`` on the generator's
        device."""
        return gumbel_noise((batch, self.cfg.num_points + 1), generator)

    def root_draw(self, tree: DeviceTree, noise: torch.Tensor):
        """``(g f32 [B, A], cand i32 [B, m], logits f32 [B, A])`` off a
        tree's root priors: the perturbed logits, the top-``m``
        candidates by ``g`` and the noise-free masked logits."""
        neg = torch.finfo(torch.float32).min
        prior = tree.prior[:, 0]
        valid = prior > 0
        logits = torch.where(valid, torch.log(torch.clamp(prior, min=1e-38)),
                             neg)
        g = torch.where(valid, logits + noise.to(prior.device), neg)
        cand = torch.topk(g, self.m_root, dim=-1).indices.int()
        return g, cand, logits

    @torch.no_grad()
    def init(self, roots: GoState, noise: torch.Tensor | None = None,
             generator: torch.Generator | None = None):
        """``(tree, g, cand, logits)``: the tree with its root priors and
        the root draw from ``noise`` (or from ``generator``)."""
        tree = self.base.init(roots)
        if noise is None:
            noise = self.draw_noise(roots.board.shape[0], generator)
        return (tree,) + self.root_draw(tree, noise)

    @torch.no_grad()
    def init_cached(self, roots: GoState, caches,
                    noise: torch.Tensor | None = None,
                    generator: torch.Generator | None = None):
        """:meth:`init` with the root encode through the incremental
        encoder (:meth:`DeviceMCTS.init_cached`): ``(tree, g, cand,
        logits, caches')``. Gumbel rebuilds its tree every move, so its
        root encode is a successive position each move."""
        tree, caches = self.base.init_cached(roots, caches)
        if noise is None:
            noise = self.draw_noise(roots.board.shape[0], generator)
        return (tree,) + self.root_draw(tree, noise) + (caches,)

    def sigma(self, tree: DeviceTree):
        """``(visits, σ)``: the completed q̂ (unvisited actions take the
        visit-weighted mean q), min–max rescaled over the
        prior-supported actions, times ``(c_visit + max N) · c_scale``."""
        visits, q = self.root_stats(tree)
        nv = visits.float()
        total = nv.sum(dim=-1, keepdim=True)
        q_bar = (nv * q).sum(dim=-1, keepdim=True) / torch.clamp(total,
                                                                 min=1.0)
        completed = torch.where(visits > 0, q, q_bar)
        valid = tree.prior[:, 0] > 0
        lo = torch.where(valid, completed, float("inf")).amin(
            dim=-1, keepdim=True)
        hi = torch.where(valid, completed, float("-inf")).amax(
            dim=-1, keepdim=True)
        rescaled = (completed - lo) / torch.clamp(hi - lo, min=1e-8)
        rescaled = torch.where(valid & (hi > lo), rescaled, 0.0)
        maxn = visits.amax(dim=-1, keepdim=True).float()
        return visits, (self.c_visit + maxn) * self.c_scale * rescaled

    def improved_policy(self, tree: DeviceTree,
                        logits: torch.Tensor) -> torch.Tensor:
        """π′ = softmax(logits + σ) over the prior-supported actions."""
        neg = torch.finfo(torch.float32).min
        _, sig = self.sigma(tree)
        masked = torch.where(logits > neg / 2, logits + sig, neg)
        return torch.softmax(masked, dim=-1)

    def rerank(self, tree: DeviceTree, g: torch.Tensor, cand: torch.Tensor,
               k: int) -> torch.Tensor:
        """The first ``k`` candidates sorted by ``g + σ`` descending,
        stably (ties keep their order); the rest as they were."""
        visits, sig = self.sigma(tree)
        scores = torch.where(visits > 0, g + sig, g)
        head = cand[:, :k]
        s = scores.gather(1, head.long())
        order = torch.sort(-s, dim=-1, stable=True).indices
        return torch.cat([head.gather(1, order), cand[:, k:]], dim=-1)

    @staticmethod
    def forced_candidate(g: torch.Tensor, cand: torch.Tensor,
                         slot: int) -> torch.Tensor:
        """The root edge schedule slot ``slot`` forces (i32 ``[B]``); a
        slot past the sensible moves (its g is the type's minimum)
        forces the top candidate instead."""
        forced = cand[:, slot]
        g_f = g.gather(1, forced.long()[:, None])[:, 0]
        return torch.where(g_f > torch.finfo(torch.float32).min / 2, forced,
                           cand[:, 0]).contiguous()

    @torch.no_grad()
    def run_phase(self, tree: DeviceTree, g: torch.Tensor,
                  cand: torch.Tensor, j0: int, count: int, k: int,
                  ran0: int = 0,
                  budget: torch.Tensor | None = None) -> DeviceTree:
        """``count`` scheduled simulations in place: simulation ``i``
        forces candidate slot ``(j0 + i) % k``. ``budget`` (i32 ``[B]``)
        counts the plan's simulations globally (``ran0`` already run):
        a row past its budget keeps its slab bit for bit."""
        for i in range(count):
            self.base.simulate(tree,
                               self.forced_candidate(g, cand, (j0 + i) % k),
                               None if budget is None
                               else budget > ran0 + i)
        return tree

    @torch.no_grad()
    def __call__(self, roots: GoState, generator: torch.Generator | None = None,
                 noise: torch.Tensor | None = None):
        """The whole plan: ``(visits i32 [B, A], q f32 [B, A], best i32
        [B], π′ f32 [B, A])``."""
        tree, g, cand, logits = self.init(roots, noise, generator)
        for k, v in self.schedule:
            self.run_phase(tree, g, cand, 0, k * v, k)
            cand = self.rerank(tree, g, cand, k)
        visits, q = self.root_stats(tree)
        return visits, q, cand[:, 0], self.improved_policy(tree, logits)

    @torch.no_grad()
    def run_chunked(self, roots: GoState, chunk: int,
                    generator: torch.Generator | None = None,
                    noise: torch.Tensor | None = None,
                    deadline: Deadline | None = None, n: int | None = None,
                    budget: torch.Tensor | None = None, caches=None):
        """The plan phase by phase, in chunks of ``chunk`` simulations
        queued one chunk ahead of the host (:class:`ChunkPipeline`); the
        same result as :meth:`__call__` unless cut. ``deadline`` is
        checked before every chunk after the first, and ``n`` truncates
        the plan; a cut phase is still re-ranked, so ``best`` is the
        anytime answer. ``budget`` (i32 ``[B]``, the playout caps)
        freezes each row past its budget of the plan's simulations
        (see :meth:`run_phase`). ``caches`` sends the root encode
        through the incremental encoder (:meth:`init_cached`); the
        carried caches come back on ``last_caches``, the simulations
        run on ``last_ran``. Nothing in the loop reads the card from
        the host."""
        if budget is not None:
            budget = budget.to(torch.int32)
        if caches is None:
            tree, g, cand, logits = self.init(roots, noise, generator)
        else:
            tree, g, cand, logits, caches = self.init_cached(
                roots, caches, noise, generator)
        self.last_caches = caches
        enforce = deadline is not None and not deadline.unlimited
        pipe = ChunkPipeline(tree.n_nodes.device, runner="gumbel")
        ran, cut, chunk_i = 0, False, 0
        t_start = time.monotonic()
        for k, v in self.schedule:
            total = k * v
            for j0 in range(0, total, chunk):
                if ((ran and enforce and deadline.expired())
                        or (n is not None and ran >= n)):
                    cut = True
                    break
                faults.barrier("search.chunk", chunk_i)
                chunk_i += 1
                count = min(chunk, total - j0)
                if n is not None:
                    count = min(count, n - ran)
                self.run_phase(tree, g, cand, j0, count, k, ran, budget)
                pipe.push()
                ran += count
            cand = self.rerank(tree, g, cand, k)
            if cut:
                break
        pipe.drain()
        _note_search(self._metrics, ran, t_start, deadline, enforce)
        self.last_ran = ran
        visits, q = self.root_stats(tree)
        return visits, q, cand[:, 0], self.improved_policy(tree, logits)


def make_gumbel_mcts(cfg: GoConfig, policy_features: tuple,
                     value_features: tuple, policy_fn: Callable,
                     value_fn: Callable, n_sim: int,
                     max_nodes: int | None = None, m_root: int = 16,
                     c_visit: float = 50.0, c_scale: float = 0.1,
                     c_puct: float = 5.0) -> GumbelMCTS:
    """Build the Gumbel searcher (:class:`GumbelMCTS`) over a
    :func:`make_device_mcts` searcher. ``m_root`` is clamped to
    ``[2, A]``; ``max_nodes=None`` sizes the slab to twice the halving
    plan's real simulation count (:func:`gumbel_plan_sims`)."""
    num_actions = cfg.num_points + 1
    m = max(2, min(m_root, num_actions))
    if max_nodes is None:
        max_nodes = 2 * gumbel_plan_sims(n_sim, m_root, num_actions)
    base = make_device_mcts(cfg, policy_features, value_features,
                            policy_fn, value_fn, n_sim=n_sim,
                            max_nodes=max_nodes, c_puct=c_puct)
    return GumbelMCTS(base, m, c_visit, c_scale)


class DeviceMCTSPlayer:
    """GTP-facing agent over the device search, PUCT or (``gumbel=True``)
    the Gumbel root search.

    ``get_move(pygo.GameState) -> move | None`` (None = pass): the host
    state is bridged once (``from_pygo`` and one labels launch), the
    search runs on the card in chunks of ``sim_chunk`` simulations, and
    the most-visited move comes back (under Gumbel, the halving winner
    ``best``).

    Incremental root encode (``incremental``, default
    :data:`INCREMENTAL_DEFAULT`): a fresh root's planes go through an
    encode cache the player carries across moves (and komi changes:
    the planes do not read komi), so only ladder lanes whose footprint
    the moves since touched are read again; the priors are the same
    bit for bit. ``reset(reason)`` drops it and counts
    ``encode_cache_resets_total{reason=}``; the cache's statistics are
    folded into the registry after each move's visits are read.

    Subtree reuse (PUCT only): the tree is carried across ``get_move``
    calls and its root walked down the moves actually played, so a
    search resumes from the visits already spent below that child. It
    falls back to a fresh tree on a komi or board change, an undo, an
    unexpanded edge, a slab more than three quarters full, or a
    position that does not match (stones placed outside the history);
    ``reuses`` counts the reused searches. Gumbel rebuilds its tree
    every move: its root draw is per move. The draws come from one
    ``torch.Generator`` on the player's device, seeded from ``seed``.

    Time: ``set_move_time(seconds)`` (from the GTP time commands) caps
    the next searches at ``seconds × measured sims/sec``: PUCT in whole
    chunks, Gumbel by halving ``n_sim`` (a tier) while its plan exceeds
    the allowed simulations, down to the plan's floor. The first search
    of each searcher runs the full budget and seeds the rate. The same
    budget arms a :class:`Deadline` checked between chunks;
    ``last_deadline_hit`` and ``deadline_hits`` report it and
    ``last_n_sim`` what the last search ran. ``sim_limit`` (None =
    none) caps every search.
    """

    def __init__(self, value_net, policy_net, n_sim: int = 100,
                 max_nodes: int | None = None, c_puct: float = 5.0,
                 sim_chunk: int = 8, gumbel: bool = False,
                 m_root: int = 16, seed: int = 0,
                 incremental: bool | None = None):
        self.policy = policy_net
        self.value = value_net
        self.board = policy_net.board
        self.device = policy_net.device
        self._cfg = policy_net.cfg
        self._chunk = sim_chunk
        self._n_sim = n_sim
        self._max_nodes = max_nodes
        self._c_puct = c_puct
        self._gumbel = gumbel
        self._m_root = m_root
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._carry = None
        self.reuses = 0
        self._incremental = (INCREMENTAL_DEFAULT if incremental is None
                             else incremental)
        self._enc_cache = None
        self._enc_stats = None
        self._clock = MoveClock()
        self.last_n_sim = None
        self.last_deadline_hit = False
        self.deadline_hits = 0
        self.sim_limit: int | None = None
        self._move_h = obs_registry.histogram(
            "device_mcts_get_move_seconds")
        self._rate_h = obs_registry.histogram(
            "device_mcts_sims_per_s", edges=obs_registry.RATE_EDGES)
        # one searcher per komi (terminal leaves score with its komi)
        # and, under Gumbel, per tier
        self._searchers: dict = {}
        # build the default searcher now, so a feature-layout mismatch
        # fails at construction and not on the first genmove; every
        # tier shares its slab size
        self._max_nodes = self._searcher_for(self._cfg.komi)[1].max_nodes

    @property
    def n_sim(self) -> int:
        """Nominal per-move simulation budget (uncapped)."""
        return self._n_sim

    def reset(self, reason: str = "new_game") -> None:
        """Forget the carried subtree and the encode cache (a new game),
        counting the cache's reset per ``reason``."""
        self._carry = None
        if self._enc_cache is not None:
            count_cache_reset(reason)
        self._enc_cache = None
        self._enc_stats = None

    def set_move_time(self, seconds) -> None:
        """Per-move wall budget in seconds (None = no clock)."""
        self._clock.set_move_time(seconds)

    def _effective_sims(self) -> int:
        """Simulations for the next search: ``move_time × sims/sec``,
        PUCT in whole chunks (at least one, at most ``n_sim``), Gumbel
        as the largest halving tier whose plan fits (or the plan's
        floor); the full budget with no clock or no rate yet."""
        allowed = self._clock.allowed_units()
        if self.sim_limit is not None:
            allowed = (self.sim_limit if allowed is None
                       else min(allowed, self.sim_limit))
        if allowed is None:
            return self._n_sim
        if self._gumbel:
            tier = self._n_sim
            num_actions = self._cfg.num_points + 1
            plan = gumbel_plan_sims(tier, self._m_root, num_actions)
            while tier > 2 and plan > allowed:
                nxt = max(2, tier // 2)
                nxt_plan = gumbel_plan_sims(nxt, self._m_root, num_actions)
                if nxt_plan >= plan:
                    break               # the plan's floor
                tier, plan = nxt, nxt_plan
            return tier
        return min(self._n_sim,
                   max(self._chunk, allowed // self._chunk * self._chunk))

    def _searcher_for(self, komi: float, n_sim: int | None = None):
        key = (komi, n_sim or self._n_sim)
        if key not in self._searchers:
            cfg = dataclasses.replace(self._cfg, komi=komi)
            args = (cfg, self.policy.feature_list, self.value.feature_list,
                    self.policy.module, self.value.module)
            if self._gumbel:
                search = make_gumbel_mcts(
                    *args, n_sim=key[1], max_nodes=self._max_nodes,
                    m_root=self._m_root, c_puct=self._c_puct)
            else:
                search = make_device_mcts(
                    *args, n_sim=key[1], max_nodes=self._max_nodes,
                    c_puct=self._c_puct)
            self._searchers[key] = (cfg, search)
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
        tier = eff if self._gumbel else self._n_sim
        skey = (komi, tier)
        cfg, search = self._searcher_for(komi, tier)
        root = torchgo.seed_labels(cfg, torchgo.from_pygo(
            cfg, [state], device=self.device, with_labels=False))
        # the clock plans eff simulations; the deadline enforces the
        # budget between chunks once the rate is measured (the first
        # search of a searcher pays the builds)
        deadline = Deadline.after(
            self._clock.move_time if self._clock.rate is not None
            else None)
        t0 = time.monotonic()
        if self._incremental and self._enc_cache is None:
            self._enc_cache = init_cache(self._cfg, device=self.device)
        if self._gumbel:
            visits, _, best, _ = search.run_chunked(
                root, self._chunk,
                noise=search.draw_noise(1, self._generator),
                deadline=deadline,
                caches=self._enc_cache if self._incremental else None)
            if self._incremental:
                self._enc_cache = search.last_caches
            action = int(best[0])
            counts = visits[0].cpu().numpy()
            planned = search.plan_sims        # not eff: the plan's total
            ran = search.last_ran
        else:
            tree = self._reused_tree(search, state, komi, root)
            if tree is not None:
                self.reuses += 1
            elif self._incremental:
                tree, self._enc_cache = search.init_cached(root,
                                                           self._enc_cache)
            else:
                tree = search.init(root)
            # the search updates the tree in place: drop the carry
            # first, so a search that fails half way is never walked
            # again
            self._carry = None
            tree, ran = search.run_sims_chunked(
                tree, self._chunk, n=eff, deadline=deadline, owned=True)
            planned = eff
            visits, _ = search.root_stats(tree)
            counts = visits[0].cpu().numpy()
            action = int(np.argmax(counts))
            self._carry = (komi, state.size, state.turns_played, tree)
        if self._incremental:
            # after the visits read: the stats cost one small copy
            self._enc_stats = observe_incremental(self._enc_stats,
                                                  self._enc_cache.stats)
        self.last_deadline_hit = ran < planned
        self.deadline_hits += int(self.last_deadline_hit)
        dt = time.monotonic() - t0
        self._clock.note(skey, ran, dt)
        self._move_h.observe(dt)
        if dt > 0:
            self._rate_h.observe(ran / dt)
        self.last_n_sim = ran
        if action >= cfg.num_points or counts[action] == 0:
            return None                                  # pass
        return divmod(action, cfg.size)


class MCTSSelfplay:
    """Search self-play over one batch (built by
    :func:`make_mcts_selfplay`; see there for the move rules and the
    return contract of a call). Its draws go through
    :meth:`draw_budget`, :meth:`draw_noise`, :meth:`draw_gamma` and
    :meth:`sample_weighted`, so a caller can hand in another stream's
    draws (the parity tests replace them with the reference's);
    :meth:`search_ply`, :meth:`pick_and_step`, :meth:`step_best` and
    :meth:`add_root_noise` are the parts of a ply; ``search`` is the
    searcher."""

    def __init__(self, cfg: GoConfig, search, batch: int, max_moves: int,
                 n_sim: int, temperature: float, sim_chunk: int,
                 record_visits: bool, gumbel: bool, gumbel_sample: bool,
                 dirichlet_alpha: float, noise_frac: float, forced_k: float,
                 cap_p: float, cheap: int, cap_per_row: bool, device):
        self.cfg = cfg
        self.search = search
        self.batch = batch
        self.max_moves = max_moves
        self.n_sim = n_sim
        self.temperature = temperature
        self.sim_chunk = sim_chunk
        self.record_visits = record_visits
        self.gumbel = gumbel
        self.gumbel_sample = gumbel_sample
        self.dirichlet_alpha = dirichlet_alpha
        self.noise_frac = noise_frac
        self.forced_k = forced_k
        self.cap_p = cap_p
        self.cheap = cheap
        self.cap_per_row = cap_per_row
        # playout-cap randomisation is live only when a cheap search is
        # really cheaper; the flags off draw nothing, so the run's
        # stream (and everything after it) is the uncapped runner's
        self.econ = cap_p > 0 and cheap < n_sim
        self.device = device
        self.last_full_frac = None     # full-search share of the last run
        self.last_sims = None          # lockstep simulations it ran
        self.last_pruned = None        # i32 [B] the last ply's pruned
        #   visits (forced playouts), None otherwise
        # per-ply telemetry, registered with the runner
        self._ply_h = obs_registry.histogram("selfplay_ply_seconds")
        self._sims_h = obs_registry.histogram(
            "selfplay_sims_per_move", edges=obs_registry.COUNT_EDGES)
        self._full_g = obs_registry.gauge("selfplay_fullsearch_frac")
        self._pruned_c = obs_registry.counter("policy_targets_pruned_total")

    # ---------------------------------------------------------- draws

    def draw_budget(self, generator: torch.Generator):
        """``(full bool [B], budget i32 [B])``: one Bernoulli(cap_p)
        for the whole batch (lockstep games: a full row makes the batch
        pay full price), or one per game with ``cap_per_row``; a full
        ply gets ``n_sim`` simulations, the rest ``cap_cheap``."""
        shape = (self.batch,) if self.cap_per_row else (1,)
        return self.budget_from(torch.rand(shape, generator=generator,
                                           device=self.device))

    def budget_from(self, u: torch.Tensor):
        """:meth:`draw_budget` from given uniforms ``u`` (f32 ``[1]``,
        or ``[B]`` with ``cap_per_row``): a ply is full where ``u <
        cap_p``, the Bernoulli draw's own rule."""
        full = (u.to(self.device) < self.cap_p).expand(self.batch)
        return full, torch.where(full, self.n_sim, self.cheap).int()

    def draw_noise(self, generator: torch.Generator) -> torch.Tensor:
        """The Gumbel root draw of a ply (f32 ``[B, A]``)."""
        return self.search.draw_noise(self.batch, generator)

    def draw_gamma(self, noise_rng: np.random.Generator) -> torch.Tensor:
        """The gamma draws behind a ply's ``Dir(α)`` root noise, made on
        the host (torch's gamma sampler takes no generator)."""
        return torch.as_tensor(
            noise_rng.gamma(self.dirichlet_alpha,
                            size=(self.batch, self.cfg.num_points + 1)),
            dtype=torch.float32).to(self.device)

    def sample_weighted(self, weights: torch.Tensor,
                        generator: torch.Generator) -> torch.Tensor:
        """An action per game ``∝ weights^(1/temperature)``; argmax at
        temperature 0."""
        if self.temperature > 0:
            logits = torch.where(
                weights > 0,
                torch.log(torch.clamp(weights, min=1e-9)) / self.temperature,
                float("-inf"))
            return gumbel_argmax(logits, generator).int()
        return torch.argmax(weights, dim=-1).int()

    # ---------------------------------------------------------- a ply

    @torch.no_grad()
    def pick_and_step(self, states: GoState, weights: torch.Tensor,
                      generator: torch.Generator):
        """``(new states, action i32 [B], live bool [B])``, the action
        sampled from ``weights`` (root visits, or π′)."""
        action = self.sample_weighted(weights.float(), generator)
        return step(self.cfg, states, action), action, ~states.done

    @torch.no_grad()
    def step_best(self, states: GoState, best: torch.Tensor):
        """The Gumbel move rule: play the halving winner."""
        return step(self.cfg, states, best), best, ~states.done

    @torch.no_grad()
    def add_root_noise(self, tree: DeviceTree,
                       gamma: torch.Tensor) -> DeviceTree:
        """Mix ``Dir(α)``, normalised from the gamma draws ``gamma``
        (f32 ``[B, A]``), into the root priors, in place."""
        p0 = tree.prior[:, 0]
        valid = p0 > 0
        gam = torch.where(valid, gamma, 0.0)
        dirichlet = gam / torch.clamp(gam.sum(dim=-1, keepdim=True),
                                      min=1e-12)
        tree.prior[:, 0] = torch.where(
            valid, (1.0 - self.noise_frac) * p0
            + self.noise_frac * dirichlet, 0.0)
        return tree

    @torch.no_grad()
    def search_ply(self, states: GoState, gamma: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None, n: int | None = None,
                   budget: torch.Tensor | None = None):
        """One ply's search: PUCT ``(root visits i32 [B, A], target)``;
        Gumbel ``(root visits, π′ f32 [B, A], best i32 [B])`` from the
        root noise ``noise``. ``n`` caps the simulations and ``budget``
        (i32 ``[B]``) masks rows past their own cap (the playout caps)."""
        search = self.search
        if self.gumbel:
            visits, _, best, pi = search.run_chunked(
                states, self.sim_chunk, noise=noise, n=n, budget=budget)
            return visits, pi, best
        tree = search.init(states)
        if gamma is not None:
            self.add_root_noise(tree, gamma)
        tree, search.last_ran = search.run_sims_chunked(
            tree, self.sim_chunk, n=n, owned=True, budget=budget)
        visits, _ = search.root_stats(tree)
        target, self.last_pruned = (search.pruned_targets(tree)
                                    if self.forced_k else (visits, None))
        return visits, target

    # ---------------------------------------------------------- a run

    def __call__(self, generator: torch.Generator,
                 noise_rng: np.random.Generator | None = None):
        if self.dirichlet_alpha > 0 and noise_rng is None:
            raise ValueError("root noise needs a numpy noise_rng")
        batch, dev = self.batch, self.device
        states = new_states(self.cfg, batch, device=dev)
        actions, lives, targets, fulls, pruned = [], [], [], [], []
        full_sum, sims = 0.0, 0
        for _ in range(self.max_moves):
            t_ply = time.monotonic()
            n_ply = budget = None
            if self.econ:
                # the budget is drawn first; the ply's simulation count
                # is host-known (a read of the draw), so the chunk loop
                # stops at the batch's largest budget
                full, budget_rows = self.draw_budget(generator)
                fh = full.cpu()
                n_ply = self.n_sim if bool(fh.any()) else self.cheap
                budget = budget_rows if self.cap_per_row else None
                full_sum += float(fh.float().mean())
                fulls.append(full)
            if self.gumbel:
                _, target, best = self.search_ply(
                    states, noise=self.draw_noise(generator), n=n_ply,
                    budget=budget)
                if self.gumbel_sample:
                    states, action, live = self.pick_and_step(
                        states, target, generator)
                else:
                    states, action, live = self.step_best(states, best)
            else:
                gamma = (self.draw_gamma(noise_rng)
                         if self.dirichlet_alpha > 0 else None)
                visits, target = self.search_ply(states, gamma, n=n_ply,
                                                 budget=budget)
                # the move comes from the raw visits; pruning reshapes
                # only the recorded target
                states, action, live = self.pick_and_step(states, visits,
                                                          generator)
                if self.last_pruned is not None:
                    pruned.append(self.last_pruned.sum())
            sims += self.search.last_ran
            if self.econ:
                self._sims_h.observe(self.search.last_ran)
            actions.append(action)
            lives.append(live)
            if self.record_visits:
                targets.append(target)
            done = bool(states.done.all())
            self._ply_h.observe(time.monotonic() - t_ply)
            if done:
                break
        self.last_full_frac = (full_sum / len(fulls)) if fulls else None
        if self.last_full_frac is not None:
            self._full_g.set(self.last_full_frac)
        if pruned:
            self._pruned_c.inc(int(torch.stack(pruned).sum()))
        self.last_sims = sims
        out = (states, self._stack(actions, torch.int32),
               self._stack(lives, torch.bool))
        if self.record_visits:
            tdtype = (torch.float32 if (self.gumbel or self.forced_k)
                      else torch.int32)
            n_act = self.cfg.num_points + 1
            out += (torch.stack(targets) if targets else torch.zeros(
                (0, batch, n_act), dtype=tdtype, device=dev),)
            if self.econ:
                out += (self._stack(fulls, torch.bool),)
        return out

    def _stack(self, rows: list, dtype) -> torch.Tensor:
        if rows:
            return torch.stack(rows)
        return torch.zeros((0, self.batch), dtype=dtype, device=self.device)


def make_mcts_selfplay(cfg: GoConfig, policy_features: tuple,
                       value_features: tuple, policy_fn: Callable,
                       value_fn: Callable, batch: int, max_moves: int,
                       n_sim: int, max_nodes: int | None = None,
                       c_puct: float = 5.0, temperature: float = 1.0,
                       sim_chunk: int = 8, record_visits: bool = False,
                       gumbel: bool = False, m_root: int = 16,
                       gumbel_sample: bool = False,
                       dirichlet_alpha: float = 0.0,
                       noise_frac: float = 0.25, forced_k: float = 0.0,
                       cap_p: float = 0.0, cap_cheap: int | None = None,
                       cap_per_row: bool = False,
                       device=None) -> MCTSSelfplay:
    """Search self-play: every move of every game comes from a fresh
    search over the batch (no subtree reuse), ``n_sim`` simulations in
    chunks of ``sim_chunk``; one net plays both colours.

    PUCT (:func:`make_device_mcts`): the move is sampled from the root
    visits ``∝ visits^(1/temperature)`` (argmax at temperature 0).
    ``dirichlet_alpha > 0`` mixes root noise into each ply's root priors
    before the simulations: ``p ← (1 − ε)·p + ε·Dir(α)`` over the
    prior-supported actions, ``ε = noise_frac``. The gamma draws behind
    ``Dir(α)`` are made on the host by the caller's
    ``numpy.random.Generator`` (one ``[B, A]`` draw per ply) and copied
    to the card; torch's gamma sampler takes no generator.
    ``forced_k > 0``: forced playouts at the root, and the recorded
    target is :meth:`DeviceMCTS.pruned_targets` (f32); the move is still
    sampled from the raw visits.

    Gumbel (``gumbel=True``, :func:`make_gumbel_mcts` with ``m_root``
    candidates): each ply draws its root noise from the run's generator
    and plays the halving winner, or with ``gumbel_sample`` a move
    sampled from π′ as above (the noise is drawn first); the recorded
    target is π′ (f32). Root noise and forced playouts are PUCT knobs
    and raise ``ValueError`` with ``gumbel``.

    Playout caps (KataGo's playout-cap randomisation, off by default):
    with ``cap_p > 0`` each ply first draws its budget from the run's
    generator -- ``n_sim`` simulations with probability ``cap_p``, else
    ``cap_cheap`` (default ``max(1, n_sim // 4)``) -- shared by the
    batch, or per game with ``cap_per_row`` (rows past their budget are
    masked, :meth:`DeviceMCTS.run_sims_chunked`). The draw is read on
    the host once a ply. With the caps off nothing is drawn for them, so
    the games are those of the uncapped runner.

    Returns an :class:`MCTSSelfplay`: ``run(generator, noise_rng=None)
    -> (final GoState, actions i32 [T, B], live bool [T, B])``, and
    ``targets [T, B, A]`` after them with ``record_visits`` (i32 root
    visits under plain PUCT, f32 otherwise), and then ``full bool [T,
    B]`` (the plies searched in full) when the caps are live. The loop
    stops after the ply on which every game has ended (a host read of
    the done flags per ply)."""
    if gumbel and dirichlet_alpha > 0:
        raise ValueError(
            "dirichlet_alpha is a PUCT-mode knob; gumbel self-play's "
            "root exploration is the gumbel draw itself")
    if gumbel and forced_k:
        raise ValueError(
            "forced_k is a PUCT-root knob; gumbel search visits "
            "candidates by schedule, not PUCT selection")
    if not 0.0 <= cap_p <= 1.0:
        raise ValueError(f"cap_p must be in [0, 1], got {cap_p}")
    if cap_cheap is None:
        cap_cheap = max(1, n_sim // 4)
    cheap = max(1, min(int(cap_cheap), n_sim))
    dev = resolve_device(device)
    if gumbel:
        search = make_gumbel_mcts(cfg, policy_features, value_features,
                                  policy_fn, value_fn, n_sim, max_nodes,
                                  m_root=m_root, c_puct=c_puct)
    else:
        search = make_device_mcts(cfg, policy_features, value_features,
                                  policy_fn, value_fn, n_sim, max_nodes,
                                  c_puct, forced_k=forced_k)
    return MCTSSelfplay(cfg, search, batch, max_moves, n_sim, temperature,
                        sim_chunk, record_visits, gumbel, gumbel_sample,
                        dirichlet_alpha, noise_frac, forced_k, cap_p, cheap,
                        cap_per_row, dev)
