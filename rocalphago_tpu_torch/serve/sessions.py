"""Session manager: many concurrent games over one device searcher.

The port of the reference package's ``serve/sessions.py``.
:class:`ServePool` owns what is expensive and shared: one device
searcher (:func:`rocalphago_tpu_torch.search.device_mcts.
make_device_mcts`: ``assemble_tree`` / ``prepare_sim`` / ``apply_sim``
for every session), one :class:`~rocalphago_tpu_torch.
serve.evaluator.BatchingEvaluator` holding the weights, and one
:class:`~rocalphago_tpu_torch.serve.admission.AdmissionController`.
:meth:`ServePool.open_session` hands out :class:`ServeSession` handles
whose :class:`SessionPlayer` carries only its own search tree.

A session's ``get_move`` is the device search driven one simulation at
a time through the shared evaluator: ``prepare_sim`` (select and
expand, batch 1), ``evaluator.evaluate`` (the leaf coalesced with every
other live game's leaf into one device batch), then ``apply_sim``
(write and back up). The split path is the fused
path of ``DeviceMCTS.simulate`` by construction, so a pooled session's
visits equal a standalone ``DeviceMCTSPlayer``'s wherever both evaluate
at the same batch size.

Resilience: sessions are wrapped in the
:class:`~rocalphago_tpu_torch.interface.resilient.ResilientPlayer`
ladder -- an evaluator shed (:class:`~rocalphago_tpu_torch.serve.
admission.EvaluatorOverload`, reason ``overload``) steps the session
down to the reduced retry, then the raw policy net, then the rules
fallback; a hung session is abandoned by the ladder's watchdog without
touching the evaluator. The per-genmove SLO (``slo_s``, off by default,
or the GTP clock through ``set_move_time``) arms a
:class:`~rocalphago_tpu_torch.runtime.deadline.Deadline` checked
between simulations with a one-simulation anytime floor, once the pool
is warm.

Komi: the pool's komi is the pinned default. A session may carry its
own (``open_session(komi=...)``, re-threaded by GTP ``komi`` through
:meth:`ServeSession.set_komi`): komi rides the request as data, and the
evaluator rescores such batches with a komi per row
(``search.eval_with(..., komi)``). Rows at the default komi score
identically either way.

:class:`FleetDriver` is the throughput mode: one loop advances many
sessions' searches in lockstep, one convoy of leaves per simulation.

Host syncs: a genmove reads its root visits once, at its end; the
evaluator's fan-out slices device tensors.
"""

from __future__ import annotations

import threading
import time

import torch

from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.models.nn_util import working_copy
from rocalphago_tpu_torch.obs import registry as obs_registry
from rocalphago_tpu_torch.obs.torchobs import track
from rocalphago_tpu_torch.runtime.deadline import Deadline
from rocalphago_tpu_torch.serve.admission import AdmissionController
from rocalphago_tpu_torch.serve.evaluator import BatchingEvaluator


def bridge_roots(cfg, states, device) -> torchgo.GoState:
    """Host positions → one batched device state, labels seeded in one
    launch."""
    return torchgo.seed_labels(cfg, torchgo.from_pygo(
        cfg, list(states), device=device, with_labels=False))


def pick_move(counts, cfg):
    """The most-visited action as a move; None (pass) for the pass
    action or an unvisited row."""
    action = int(counts.argmax())
    if action >= cfg.num_points or counts[action] == 0:
        return None
    return divmod(action, cfg.size)


def _search(pool, roots: torchgo.GoState, n_sim: int, free: torch.Tensor,
            deadline: Deadline | None = None, komi=None,
            version: int | None = None, evaluate=None):
    """The device search of one genmove for every row of ``roots``: the
    root evaluation, then ``n_sim`` simulations of one evaluator request
    each (all rows together). ``deadline`` is checked between
    simulations with a one-simulation floor, once the pool is warm.
    ``evaluate`` (default: the pool's queue, ``evaluator.evaluate``)
    takes ``(states, rows, komi, version, keys)``. Returns ``(tree,
    ran)``; nothing in it reads the card from the host (without a
    cache, which reads its keys)."""
    search = pool.search
    evaluate = evaluate or pool.evaluator.evaluate
    n = int(roots.board.shape[0])
    keys = pool.evaluator.cache is not None
    enforce = deadline is not None and not deadline.unlimited \
        and pool.warmed
    priors, _ = evaluate(roots, rows=n, komi=komi, version=version,
                         keys=search.eval_key(roots) if keys else None)
    tree = search.assemble_tree(roots, priors)
    ran = 0
    while True:
        ctx = search.prepare_sim(tree, free, keys)
        priors, values = evaluate(ctx.eval_states, rows=n, komi=komi,
                                  version=version, keys=ctx.eval_keys)
        search.apply_sim(tree, ctx, priors, values)
        ran += 1
        if ran >= n_sim or (enforce and deadline.expired()):
            return tree, ran


def _warm_search(pool, n: int, evaluate=None) -> None:
    """One two-simulation search at batch ``n`` from empty boards,
    waited for: the path a genmove (``n`` = 1) or a fleet round takes."""
    roots = torchgo.new_states(pool.cfg, n, device=pool.device)
    free = torch.full((n,), -1, dtype=torch.int32, device=pool.device)
    tree, _ = _search(pool, roots, 2, free, evaluate=evaluate)
    pool.search.root_stats(tree)[0].cpu()
    pool.warmed = True


class SessionPlayer:
    """Per-session search agent over the pool's shared searcher.

    The ``get_move(pygo.GameState) -> move | None`` surface every
    wrapper expects (GTP engine, ResilientPlayer, tournament), plus the
    hooks of the ladder: ``n_sim`` / ``sim_limit`` (the reduced rung),
    ``policy`` (the raw policy rung over the same net), and the deadline
    stats the health probe reads (``last_n_sim``, ``deadline_hits``,
    ``last_deadline_hit``). It has no ``reset``: a session carries no
    state across moves (its tree is rebuilt every move)."""

    def __init__(self, pool: "ServePool"):
        self.pool = pool
        self.policy = pool.policy
        self.board = pool.board
        self._cfg = pool.cfg
        self.komi: float | None = None    # None = the pool's pinned
        #   komi; a float rescores terminal leaf values per request
        self.sim_limit: int | None = None
        self.last_n_sim = None
        self.deadline_hits = 0
        self.last_deadline_hit = False
        self._move_time: float | None = None
        #: a staged params version this session searches on; None
        #: follows the pool's current pointer. A retired pin falls back
        #: to the current version
        self.pinned_version: int | None = None
        self.last_version: int | None = None
        # the free root_actions row, built once
        self._free = torch.full((1,), -1, dtype=torch.int32,
                                device=pool.device)

    @property
    def n_sim(self) -> int:
        return self.pool.n_sim

    def set_move_time(self, seconds) -> None:
        """GTP clock hook: the per-move wall budget (None = no clock).
        The tighter of this and the pool SLO arms the deadline."""
        self._move_time = (None if seconds is None
                           else max(float(seconds), 0.0))

    def _budget_s(self) -> float | None:
        slo = self.pool.slo_s
        if self._move_time is None:
            return slo
        return self._move_time if slo is None else min(self._move_time,
                                                       slo)

    def _komi(self) -> float | None:
        """The komi this session's requests carry: None (the pinned
        default) unless a custom komi differs from the pool's."""
        k = self.komi
        if k is None or float(k) == float(self._cfg.komi):
            return None
        return float(k)

    @torch.no_grad()
    def get_move(self, state):
        pool = self.pool
        t0 = time.monotonic()
        roots = bridge_roots(self._cfg, [state], pool.device)
        eff = self.n_sim
        if self.sim_limit is not None:
            eff = max(1, min(eff, self.sim_limit))
        # one params version for the whole genmove: a hot swap in the
        # middle of a search never mixes two nets in one tree
        try:
            ver = pool.evaluator.acquire(self.pinned_version)
        except KeyError:
            self.pinned_version = None
            ver = pool.evaluator.acquire(None)
        self.last_version = ver
        try:
            # the SLO or clock deadline
            tree, ran = _search(pool, roots, eff, self._free,
                                Deadline.after(self._budget_s()),
                                self._komi(), ver)
        finally:
            pool.evaluator.release(ver)
        visits, _ = pool.search.root_stats(tree)
        counts = visits[0].cpu().numpy()
        self.last_deadline_hit = ran < eff
        self.deadline_hits += int(self.last_deadline_hit)
        self.last_n_sim = ran
        pool.note_genmove(time.monotonic() - t0, ran)
        return pick_move(counts, self._cfg)


class FleetDriver:
    """Throughput drive: advance many sessions' searches in lockstep
    rounds, one convoy of cross-game leaves per simulation.

    The thread-per-session path (:class:`SessionPlayer` under the
    ladder) is the latency and robustness mode. The same searches can
    instead be driven by one loop: the driver stacks the games' search
    trees on the batch axis the device search already has, submits each
    simulation's leaf rows to the shared evaluator as one request
    (coalesced and padded like any other), and steps every tree with one
    ``apply_sim`` a round. Same trees, same evaluation, same answers;
    the per-row launch cost is paid once for the fleet instead of once
    per session.

    One call is one genmove for every driven session. The pool SLO
    still applies, checked between convoys with a one-convoy floor."""

    def __init__(self, pool: "ServePool", sessions):
        self.pool = pool
        self.sessions = list(sessions)
        self.last_n_sim = None
        self.deadline_hits = 0

    def _komi_rows(self, n: int):
        """The komi per row of a convoy: None unless some driven
        session carries a custom komi (then one float per session, the
        pool default where unset)."""
        default = float(self.pool.cfg.komi)
        if len(self.sessions) != n:
            return None
        ks = [getattr(getattr(s, "raw", s), "komi", None)
              for s in self.sessions]
        if all(k is None or float(k) == default for k in ks):
            return None
        return [default if k is None else float(k) for k in ks]

    @torch.no_grad()
    def genmove_all(self, states) -> list:
        """One move for each of ``states`` (aligned with the driven
        sessions): a list of ``(x, y)`` or None (pass)."""
        pool = self.pool
        n = len(states)
        t0 = time.monotonic()
        tree = self.run_round(bridge_roots(pool.cfg, states, pool.device))
        visits, _ = pool.search.root_stats(tree)
        counts = visits.cpu().numpy()          # the round's one host read
        dt = time.monotonic() - t0
        for _ in range(n):
            pool.note_genmove(dt, self.last_n_sim)
        return [pick_move(counts[i], pool.cfg) for i in range(n)]

    @torch.no_grad()
    def run_round(self, roots: torchgo.GoState):
        """The lockstep search of one round from bridged roots, one
        convoy a simulation; returns the tree. Nothing in it reads the
        card from the host (without a cache, which reads its keys)."""
        pool = self.pool
        n = int(roots.board.shape[0])
        free = torch.full((n,), -1, dtype=torch.int32, device=pool.device)
        # the whole lockstep round searches one pinned version
        ver = pool.evaluator.acquire(None)
        try:
            tree, ran = _search(pool, roots, pool.n_sim, free,
                                Deadline.after(pool.slo_s),
                                self._komi_rows(n), ver)
        finally:
            pool.evaluator.release(ver)
        self.last_n_sim = ran
        self.deadline_hits += int(ran < pool.n_sim)
        return tree

    @torch.no_grad()
    def warm(self) -> None:
        """Run the driver's fleet-size path once (batch = fleet) and
        the evaluator sizes its convoys pad to."""
        _warm_search(self.pool, len(self.sessions))


class ServeSession:
    """One live game's handle: the (ladder-wrapped) player and the
    admission slot, released by :meth:`close`."""

    def __init__(self, pool: "ServePool", sid: int, player, raw):
        self.pool = pool
        self.id = sid
        self.player = player        # what callers serve moves from
        self.raw = raw              # the unwrapped SessionPlayer
        self._closed = False

    def get_move(self, state):
        return self.player.get_move(state)

    @property
    def komi(self) -> float | None:
        """This session's komi (None = the pool's pinned default)."""
        return self.raw.komi

    def set_komi(self, komi: float | None) -> None:
        """Re-thread this session's komi (GTP ``komi`` lands here): it
        takes effect on the next genmove, with no rebuild. None
        restores the pool default."""
        self.raw.komi = None if komi is None else float(komi)

    @property
    def params_version(self) -> int | None:
        """The version this session's last genmove searched on."""
        return self.raw.last_version

    def pin_version(self, version: int | None) -> None:
        """Pin future genmoves to a staged params version; None rejoins
        the pool's current pointer."""
        self.raw.pinned_version = None if version is None else int(version)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.pool._release(self.id)

    def __enter__(self) -> "ServeSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ServePool:
    """The serving subsystem's root object (the module docstring).

    Parameters mirror :class:`~rocalphago_tpu_torch.search.device_mcts.
    DeviceMCTSPlayer` where they overlap (``n_sim``, ``max_nodes``,
    ``c_puct``). Serving arguments: ``max_sessions`` / ``queue_rows``
    (admission; defaults 256 and 1,024), ``batch_sizes`` /
    ``max_wait_us`` (dispatch; defaults ``1, 8, 32, 64, 256`` clipped
    to the session cap, and 500 µs), ``slo_s`` (the per-genmove
    deadline, default off), ``hang_timeout_s`` and ``metrics`` (each
    session's ladder), ``eval_cache`` (an :class:`~rocalphago_tpu_torch.
    serve.evalcache.EvalCache` to share; None or False for none, and
    refused under ``enforce_superko``, where the evaluation is not a
    pure function of the eval signature). The pool runs on the nets'
    device.
    """

    def __init__(self, value_net, policy_net, n_sim: int = 64,
                 max_nodes: int | None = None, c_puct: float = 5.0,
                 max_sessions: int | None = None,
                 queue_rows: int | None = None,
                 batch_sizes=None, max_wait_us: float | None = None,
                 slo_s: float | None = None,
                 hang_timeout_s: float | None = None, metrics=None,
                 searcher=None, label_board: bool = False,
                 eval_cache=None):
        from rocalphago_tpu_torch.search.device_mcts import make_device_mcts

        self.policy = policy_net
        self.value = value_net
        self.cfg = policy_net.cfg
        self.board = policy_net.board
        self.device = policy_net.device
        self.n_sim = n_sim
        self.slo_s = slo_s
        self.hang_timeout_s = hang_timeout_s
        self.metrics = metrics
        # ``searcher``: share one searcher across pools
        self.search = searcher if searcher is not None else \
            make_device_mcts(
                self.cfg, policy_net.feature_list, value_net.feature_list,
                policy_net.module, value_net.module, n_sim=n_sim,
                max_nodes=max_nodes, c_puct=c_puct)
        # label_board: a pool inside a MultiSizePool labels its
        # admission metrics per size (serve_sessions_live{board=})
        self.admission = AdmissionController(
            max_sessions, queue_rows,
            board=self.board if label_board else None)
        cache = eval_cache or None
        if self.cfg.enforce_superko:
            # the sensible mask reads the hash history, which the eval
            # signature does not cover: no cache
            cache = None
        self.eval_cache = cache
        # version 0: working copies of the nets, cast once
        # the evaluator's two programs, tracked under the reference's
        # entry names (obs.torchobs)
        self.evaluator = BatchingEvaluator(
            track("device_mcts.eval_batch", self.search.eval_with),
            working_copy(policy_net.module),
            working_copy(value_net.module),
            batch_sizes=batch_sizes, max_wait_us=max_wait_us,
            admission=self.admission,
            eval_komi_fn=track("device_mcts.eval_batch_komi",
                               self.search.eval_with),
            default_komi=self.cfg.komi, cache=cache,
            key_fn=self.search.eval_key, board=self.board)
        self.warmed = False
        self._lock = threading.Lock()
        self._sessions: dict = {}         # guarded-by: self._lock
        self._next_id = 0                 # guarded-by: self._lock
        self._move_h = obs_registry.histogram("serve_genmove_seconds")
        self._sims_c = obs_registry.counter("serve_session_sims_total")

    # ------------------------------------------------------- sessions

    def open_session(self, resilient: bool = True,
                     reduced_sims: int | None = None,
                     komi: float | None = None) -> ServeSession:
        """Admit one game (:class:`~rocalphago_tpu_torch.serve.
        admission.AdmissionError` at capacity). ``resilient=False``
        returns the raw player; ``komi`` gives this session its own
        komi (None = the pool's default)."""
        self.admission.admit_session()
        raw = SessionPlayer(self)
        raw.komi = None if komi is None else float(komi)
        player = raw
        if resilient:
            from rocalphago_tpu_torch.interface.resilient import (
                ResilientPlayer,
            )

            player = ResilientPlayer(
                raw, metrics=self.metrics, reduced_sims=reduced_sims,
                hang_timeout_s=self.hang_timeout_s)
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            sess = ServeSession(self, sid, player, raw)
            self._sessions[sid] = sess
        return sess

    def _release(self, sid: int) -> None:
        with self._lock:
            if self._sessions.pop(sid, None) is None:
                return
        self.admission.release_session()

    def note_genmove(self, dt: float, sims: int) -> None:
        self._move_h.observe(dt)
        self._sims_c.inc(sims)

    def driver(self, sessions) -> FleetDriver:
        """The lockstep throughput drive over ``sessions``."""
        return FleetDriver(self, sessions)

    # -------------------------------------------------------- rollout

    @property
    def params_version(self) -> int:
        return self.evaluator.params_version

    def _working(self, params_p, params_v):
        return (working_copy(self.policy.module, params_p),
                working_copy(self.value.module, params_v))

    def set_params(self, params_p=None, params_v=None,
                   version: int | None = None) -> int:
        """Hot-swap the pool's nets: install the state dicts
        ``(params_p, params_v)`` (or promote a registered ``version``)
        as the current pair; live sessions keep playing, and genmoves in
        flight finish on the version they pinned. The pool's nets follow
        so the degraded rungs serve the same weights
        (:meth:`_follow`)."""
        pair = (None, None) if params_p is None else \
            self._working(params_p, params_v)
        v = self.evaluator.set_params(*pair, version=version)
        self._follow(v)
        return v

    def _follow(self, version: int) -> None:
        """Point the pool's nets at ``version``'s modules by reference
        (the evaluator's working copies, which compute the same outputs
        bit for bit), one attribute store each, as the reference points
        its nets' params. A forward already running on another thread
        (the ladder's policy rung) keeps the module it started on, so it
        never reads half-swapped weights, as an in-place copy into the
        live module would let it."""
        self.policy.module, self.value.module = \
            self.evaluator.version_params(version)

    def stage_params(self, params_p, params_v,
                     version: int | None = None) -> int:
        """Register a candidate pair WITHOUT flipping current (the
        canary's arm): sessions reach it only through
        :meth:`ServeSession.pin_version`."""
        return self.evaluator.add_version(
            *self._working(params_p, params_v), version=version)

    def promote_version(self, version: int) -> int:
        """Full rollout of a staged version: flip current to it and drop
        the stage pin."""
        v = self.set_params(version=version)
        self.evaluator.release(v)
        return v

    def discard_version(self, version: int) -> None:
        """Roll a staged version back: drop the stage pin, so it retires
        once in-flight pinned searches finish; sessions pinned to it fall
        back to current on their next genmove."""
        self.evaluator.release(version)

    # --------------------------------------------------------- warmup

    @torch.no_grad()
    def warm(self, sizes=None) -> None:
        """Ready the pool before traffic: build the kernels, run one
        evaluation at every size of the ladder and one simulation of a
        session's path; the SLO is enforced only on a warm pool."""
        for size in (sizes or self.evaluator.batch_sizes):
            out = self.evaluator.eval_direct(
                torchgo.new_states(self.cfg, size, device=self.device))
            out[0].cpu()
        # off the queue: warming adds no load and no batch count
        _warm_search(self, 1, lambda states, rows, komi, version, keys:
                     self.evaluator.eval_direct(states))

    # ------------------------------------------------------ lifecycle

    def close(self) -> None:
        with self._lock:
            sessions = list(self._sessions.values())
        for sess in sessions:
            sess.close()
        self.evaluator.close()

    def __enter__(self) -> "ServePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------- stats

    def stats(self) -> dict:
        """The probes' ``serve`` block: live sessions, queue depth,
        batch occupancy, sheds -- the fields a load balancer keys its
        health on."""
        adm = self.admission.stats()
        ev = self.evaluator.stats()
        cs = ev["cache"]
        return {
            "sessions": {
                "live": adm["live_sessions"],
                "max": adm["max_sessions"],
                "rejects": adm["session_rejects"],
            },
            "queue": {
                "depth": ev["queue_depth"],
                "rows_bound": adm["queue_rows"],
                "sheds": adm["queue_sheds"],
            },
            "evaluator": {
                "batches": ev["batches"],
                "komi_batches": ev["komi_batches"],
                "rows": ev["rows"],
                "unique_rows": ev["unique_rows"],
                "dedup_saved": ev["dedup_saved"],
                "failures": ev["failures"],
                "batch_occupancy": ev["batch_occupancy"],
                "batch_sizes": ev["batch_sizes"],
                "max_wait_us": ev["max_wait_us"],
            },
            "cache": {
                "enabled": cs["enabled"],
                "entries": cs["entries"],
                "capacity": cs["capacity"],
                "hits": cs["hits"],
                "misses": cs["misses"],
                "evictions": cs["evictions"],
                "collisions": cs["collisions"],
                "hit_rate": cs["hit_rate"],
            },
            "params": {
                "version": ev["params_version"],
                "swaps": ev["swaps"],
            },
            "board": self.board,
            "komi_default": float(self.cfg.komi),
            "slo_ms": (None if self.slo_s is None
                       else round(self.slo_s * 1e3, 3)),
            "n_sim": self.n_sim,
            "warmed": self.warmed,
        }
