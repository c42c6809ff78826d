"""The shared batching evaluator: cross-game leaf evaluation.

The port of the reference package's ``serve/evaluator.py``. One
dispatcher thread owns the pool's evaluation (``search.eval_with`` of
:class:`~rocalphago_tpu_torch.search.device_mcts.DeviceMCTS`: encode,
both forwards, the sensible mask and terminal scoring) at a few fixed
batch sizes. Sessions submit pending leaf states (one row per live
search per simulation); the dispatcher coalesces whole requests across
sessions into one device batch, pads to the next size of the ladder
(padded rows replicate row 0 and are sliced off: every step of the
evaluation is per row), evaluates, and hands each request its slice --
views of the device outputs, so the fan-out makes no host sync.

Dispatch policy:

* **fill target** -- dispatch as soon as pending rows reach
  ``min(max_batch, live sessions)``: every live search has at most one
  leaf in flight, so a full convoy is the most that can arrive. With
  no admission controller attached the target is ``max_batch``.
* **max wait** -- a partial batch is flushed when its oldest request
  has waited ``max_wait_us`` (default 500 µs).
* **bounded queue** -- ``submit`` past the admission controller's
  ``queue_rows`` sheds (:class:`~rocalphago_tpu_torch.serve.admission.
  EvaluatorOverload`) instead of queueing; the session's resilience
  ladder absorbs it.

A failed batch (a fault at the ``serve.eval`` barrier, or a device
error) fails only the requests in that batch: their futures carry the
exception, the dispatcher survives, and every other session is still
served. The dispatcher thread is a
:class:`~rocalphago_tpu_torch.runtime.supervisor.SupervisedThread`: an
exception that escapes the per-batch handler (the ``serve.dispatch``
barrier at the top of the loop is the chaos harness's kill point)
re-enters the loop after a backoff with the queue intact, and a crash
loop parks the dispatcher and fails the pending requests instead of
hanging their sessions. Every thread stays on the default CUDA stream,
so the dispatcher's kernels are ordered after the submitting session's
``prepare_sim`` and before its ``apply_sim`` with no event or
``record_stream``.

Batch sizes default to ``1, 8, 32, 64, 256`` clipped to the admission
session cap, with the cap itself added (:func:`default_batch_sizes`).
The port compiles nothing: a size is a shape the kernels take, and
``ServePool.warm`` runs each once.

Versioned params: the evaluator holds a registry of ``version ->
(policy_fn, value_fn)`` pairs -- working copies of the nets, their
weights cast once to the working type when the version is added
(:func:`~rocalphago_tpu_torch.models.nn_util.working_copy`) -- with
one current pointer. :meth:`set_params` installs a new pair and flips
the pointer. A session pins one version for a whole genmove
(:meth:`acquire` / :meth:`release`), the dispatcher never coalesces
requests of different versions into one batch, and a non-current
version retires once its last pin (or queued request) drops.

Transposition cache: with an :class:`~rocalphago_tpu_torch.serve.
evalcache.EvalCache` attached, the dispatcher keys every coalesced row
by its eval signature (riding each request as ``keys=``, or computed
by ``key_fn``), reading the keys to the host once a batch; it serves
hits from the cache, collapses duplicate-key misses to one device row
(in-batch dedup), pads only the unique rows, and fans results back out.
Hits and dedup fan-outs are host copies of exact device outputs, so the
cached path is bit-identical to the plain one; a batch of pure hits
skips the device. Version retirement evicts that version's entries.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch

from rocalphago_tpu_torch.engine.torchgo import GoState
from rocalphago_tpu_torch.obs import registry as obs_registry
from rocalphago_tpu_torch.runtime import faults, supervisor

#: the partial-batch flush age, microseconds
MAX_WAIT_US = 500.0
#: the batch-size ladder before clipping to the session cap
BATCH_SIZES = (1, 8, 32, 64, 256)
#: batch-occupancy histogram edges (real rows / padded size)
OCC_EDGES = (0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)


def default_batch_sizes(cap: int | None = None) -> tuple:
    """The size ladder :data:`BATCH_SIZES` clipped to ``cap`` (the
    session cap: no convoy fills a larger batch), with ``cap`` itself
    added -- the full convoy, the steady-state batch, must be a size of
    the ladder, not padded up to one."""
    sizes = BATCH_SIZES
    if cap is not None and cap >= sizes[0]:
        sizes = tuple(sorted(set(s for s in sizes if s <= cap) | {cap}))
    return sizes


def cat_states(parts) -> GoState:
    """Concatenate batched states along the batch axis."""
    parts = list(parts)
    if len(parts) == 1:
        return parts[0]
    return GoState(*(torch.cat(xs, dim=0) for xs in zip(*parts)))


def pad_rows(states: GoState, size: int) -> GoState:
    """``states`` padded to ``size`` rows with replicas of row 0 (valid
    states, no NaN hazards); the caller slices the pad rows off."""
    pad = size - states.board.shape[0]
    if pad <= 0:
        return states
    return GoState(*(torch.cat([x, x[:1].expand((pad,) + x.shape[1:])])
                     for x in states))


def take_rows(states: GoState, idx: torch.Tensor) -> GoState:
    return GoState(*(x[idx] for x in states))


def _next_run(queue: deque, max_batch: int) -> tuple[list, int]:
    """Pop the next single-version run of whole requests that fits
    ``max_batch`` off ``queue`` (which the caller has locked):
    ``(requests, rows)``."""
    take, total = [], 0
    while queue and total + queue[0].rows <= max_batch:
        if take and queue[0].version != take[0].version:
            # never coalesce across a version edge: one device batch,
            # one net
            break
        req = queue.popleft()
        take.append(req)
        total += req.rows
    return take, total


class _Pending:
    """A submitted evaluation request: rows in, a future out. ``komi``
    is None (the pool's pinned komi) or the request's own komi -- a
    float for every row, or a sequence per row. ``keys`` is None or the
    rows' eval signatures (int64 ``[rows, 2]`` on the device,
    ``SimStep.eval_keys``)."""

    __slots__ = ("states", "rows", "komi", "version", "keys",
                 "t_submit", "_event", "_result", "_exc")

    def __init__(self, states, rows: int, komi=None,
                 version: int = 0, keys=None):
        self.states = states
        self.rows = rows
        self.komi = komi
        self.version = version
        self.keys = keys
        self.t_submit = time.monotonic()
        self._event = threading.Event()
        self._result = None
        self._exc = None

    def _finish(self, result) -> None:
        self._result = result
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def result(self, timeout: float | None = None):
        """Block for the batch holding this request; returns ``(priors
        f32 [rows, A], values f32 [rows])`` on the states' device, or
        re-raises the batch's failure. ``timeout`` raises
        TimeoutError."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"evaluation not served within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result


class BatchingEvaluator:
    """Coalesce leaf-evaluation requests from many sessions into
    fixed-size device batches (the module docstring has the policy).

    Parameters
    ----------
    eval_fn : ``(params_p, params_v, states[B]) -> (priors, values)``
        (``search.eval_with``), per row.
    params_p, params_v : version 0's nets (callables on planes).
    batch_sizes : the size ladder (default :func:`default_batch_sizes`).
    max_wait_us : the partial-batch flush age (default 500 µs).
    admission : optional :class:`~rocalphago_tpu_torch.serve.admission.
        AdmissionController`: the queue bound and the fill target.
    start : tests pass False to drive the queue by hand
        (:meth:`drain_once`).
    eval_komi_fn : optional ``(params_p, params_v, states[B], komi f32
        [B]) -> (priors, values)``, engaged only for batches holding a
        custom-komi request; rows without one ride it at
        ``default_komi``, which scores identically.
    default_komi : the pool's pinned komi.
    cache : optional :class:`~rocalphago_tpu_torch.serve.evalcache.
        EvalCache` (the cached dispatch path); None keeps the plain
        path.
    key_fn : ``(states[B]) -> int64 [B, 2]`` (``search.eval_key``) for
        requests that arrive without ``keys``; required with a
        non-symmetry cache.
    board : the pool's board size, part of every cache key.
    """

    def __init__(self, eval_fn, params_p, params_v,
                 batch_sizes=None, max_wait_us: float | None = None,
                 admission=None, start: bool = True,
                 eval_komi_fn=None, default_komi: float = 0.0,
                 cache=None, key_fn=None, board: int = 0):
        self._eval_fn = eval_fn
        self._eval_komi_fn = eval_komi_fn
        self.default_komi = float(default_komi)
        self.cache = cache
        self._key_fn = key_fn
        self.board = int(board)
        if cache is not None and key_fn is None and not cache.symmetry:
            raise ValueError(
                "an EvalCache needs key_fn (search.eval_key) to key "
                "requests that arrive without precomputed keys")
        # the versioned-params registry: the current pointer is what
        # unversioned submits resolve to; pins keep a version alive
        self._params = {0: (params_p, params_v)}  # guarded-by: _cond
        self._current = 0                 # guarded-by: self._cond
        self._pins: dict = {}             # guarded-by: self._cond
        self.swaps = 0                    # guarded-by: self._cond
        cap = admission.max_sessions if admission is not None else None
        self.batch_sizes = (tuple(sorted(batch_sizes)) if batch_sizes
                            else default_batch_sizes(cap))
        self.max_batch = self.batch_sizes[-1]
        self.max_wait_s = (MAX_WAIT_US if max_wait_us is None
                           else max_wait_us) / 1e6
        self.admission = admission
        self._cond = threading.Condition()
        self._queue: deque = deque()      # guarded-by: self._cond
        self._pending_rows = 0            # guarded-by: self._cond
        self._stop = False                # guarded-by: self._cond
        # dispatch accounting (stats() and the serve probes). rows_total
        # counts logical rows served, unique_rows_total the rows that
        # reached the device (equal on the plain path), so occupancy =
        # unique / padded cannot pass 1 under dedup
        self.batches = 0
        self.komi_batches = 0
        self.failures = 0
        self.rows_total = 0
        self.unique_rows_total = 0
        self.dedup_rows_saved_total = 0
        self.padded_total = 0
        self._uniq_c = obs_registry.counter("serve_unique_rows_total")
        self._dedup_c = obs_registry.counter("serve_dedup_rows_saved_total")
        self._occ_h = obs_registry.histogram("serve_batch_occupancy",
                                             edges=OCC_EDGES)
        self._wait_h = obs_registry.histogram("serve_queue_wait_seconds")
        self._rows_c = obs_registry.counter("serve_eval_rows_total")
        self._fail_c = obs_registry.counter("serve_eval_failures_total")
        self._depth_g = obs_registry.gauge("serve_queue_depth")
        self._swap_c = obs_registry.counter("serve_param_swaps_total")
        self._ver_g = obs_registry.gauge("serve_params_version")
        self._ver_g.set(0)
        # resurrect on death: the loop's state is all on self, so
        # re-entering it after an escaped exception loses nothing; a
        # crash loop parks and fails the queue (no hanging clients)
        self._thread = supervisor.SupervisedThread(
            self._loop, name="serve:dispatcher",
            on_park=self._fail_pending)
        if start:
            self._thread.start()

    # ----------------------------------------------------- versions

    @property
    def params_version(self) -> int:
        """The current version: what an unpinned submit resolves to."""
        with self._cond:
            return self._current

    def add_version(self, params_p, params_v,
                    version: int | None = None) -> int:
        """Register a pair without flipping the current pointer (a
        staged version). It arrives pinned once: :meth:`release` drops
        the stage pin."""
        with self._cond:
            v = max(self._params) + 1 if version is None else int(version)
            self._params[v] = (params_p, params_v)
            self._pins[v] = self._pins.get(v, 0) + 1
            return v

    def set_params(self, params_p=None, params_v=None,
                   version: int | None = None) -> int:
        """The hot swap: install ``(params_p, params_v)`` -- or, with
        the params omitted, promote a registered ``version`` -- as the
        current pair. In-flight pinned searches finish on the version
        they started. Returns the version."""
        with self._cond:
            if params_p is None:
                v = int(version)
                if v not in self._params:
                    raise KeyError(
                        f"params version {v} is not registered "
                        f"(have {sorted(self._params)})")
            else:
                v = (max(self._params) + 1 if version is None
                     else int(version))
                self._params[v] = (params_p, params_v)
            prev = self._current
            self._current = v
            if v != prev:
                self.swaps += 1
            # retire every version neither current nor pinned
            dead = [o for o in self._params
                    if o != v and not self._pins.get(o)]
            for old in dead:
                del self._params[old]
            self._cond.notify_all()
        # cache eviction after dropping _cond: shard locks never nest
        # under the dispatcher's condition
        self._evict_retired(dead)
        if v != prev:
            self._swap_c.inc()
        self._ver_g.set(v)
        return v

    def acquire(self, version: int | None = None) -> int:
        """Pin a version (None = current) for a whole search. Raises
        KeyError when the version is retired."""
        with self._cond:
            v = self._current if version is None else int(version)
            if v not in self._params:
                raise KeyError(f"params version {v} is retired "
                               f"(current {self._current})")
            self._pins[v] = self._pins.get(v, 0) + 1
            return v

    def release(self, version: int) -> None:
        """Drop one pin; a non-current version with no pin left retires
        at once (its nets become collectable, its cache entries
        evict)."""
        with self._cond:
            n = self._pins.get(version, 0) - 1
            if n > 0:
                self._pins[version] = n
            else:
                self._pins.pop(version, None)
            dead = [o for o in self._params
                    if o != self._current and not self._pins.get(o)]
            for old in dead:
                del self._params[old]
        self._evict_retired(dead)

    def _evict_retired(self, versions) -> None:
        """The cache's half of retirement; called with no lock held."""
        if self.cache is not None:
            for v in versions:
                self.cache.evict_version(v)

    def version_params(self, version: int | None = None) -> tuple:
        """The ``(params_p, params_v)`` pair of ``version`` (None =
        current)."""
        with self._cond:
            v = self._current if version is None else int(version)
            return self._params[v]

    # ------------------------------------------------------- client

    def submit(self, states: GoState, rows: int | None = None,
               komi=None, version: int | None = None,
               keys=None) -> _Pending:
        """Queue a ``[rows]``-batched state for evaluation. Raises
        :class:`~rocalphago_tpu_torch.serve.admission.EvaluatorOverload`
        when the bounded queue is full (the shed); the caller's ladder
        owns what comes next. ``komi`` (a float, or one per row) scores
        this request's terminal rows under that komi (it needs
        ``eval_komi_fn``); ``version`` pins a registered params version
        (None = the current one), held until the request is served;
        ``keys`` rides the rows' eval signatures to the cache."""
        if rows is None:
            rows = int(states.board.shape[0])
        if rows > self.max_batch:
            raise ValueError(
                f"request of {rows} rows exceeds the largest batch size "
                f"({self.max_batch})")
        if komi is not None and self._eval_komi_fn is None:
            raise ValueError(
                "per-request komi needs an eval_komi_fn "
                "(search.eval_with with a komi)")
        with self._cond:
            if self._stop:
                raise RuntimeError("evaluator is closed")
            v = self._current if version is None else int(version)
            if v not in self._params:
                raise KeyError(f"params version {v} is retired "
                               f"(current {self._current})")
            if self.admission is not None:
                self.admission.admit_rows(self._pending_rows, rows)
            req = _Pending(states, rows, komi, version=v, keys=keys)
            self._pins[v] = self._pins.get(v, 0) + 1
            self._queue.append(req)
            self._pending_rows += rows
            self._cond.notify_all()
        return req

    def evaluate(self, states: GoState, rows: int | None = None,
                 timeout: float | None = None, komi=None,
                 version: int | None = None, keys=None):
        """Blocking submit: ``(priors, values)`` for ``states``."""
        return self.submit(states, rows, komi=komi, version=version,
                           keys=keys).result(timeout)

    def eval_direct(self, states: GoState, komi=None,
                    version: int | None = None):
        """Run the evaluation directly, bypassing the queue (warm-up,
        and paths that must not add queue load). ``komi`` (f32 ``[B]``)
        selects the komi-aware evaluation."""
        pp, pv = self.version_params(version)
        if komi is None:
            return self._eval_fn(pp, pv, states)
        return self._eval_komi_fn(pp, pv, states, komi)

    # ---------------------------------------------------- dispatcher

    def _fill_target(self) -> int:
        live = self.admission.live() if self.admission is not None else 0
        return min(self.max_batch, live) if live > 0 else self.max_batch

    def _padded_size(self, rows: int) -> int:
        for s in self.batch_sizes:
            if s >= rows:
                return s
        return self.max_batch

    def _loop(self) -> None:
        # grad mode is per thread: the dispatcher sets its own
        with torch.no_grad():
            while True:
                # the dispatcher-kill point: outside the per-batch try
                # and before any request is popped, so an injected
                # kill takes the thread down with the queue intact
                faults.barrier("serve.dispatch", iteration=self.batches)
                with self._cond:
                    while not self._queue and not self._stop:
                        self._cond.wait(0.1)
                    if self._stop and not self._queue:
                        return
                    # fill to the target, else flush when the oldest
                    # request has aged out (close() can clear the
                    # queue under us: re-check it on every wake)
                    while not self._stop and self._queue:
                        if self._pending_rows >= self._fill_target():
                            break
                        age = time.monotonic() - self._queue[0].t_submit
                        if age >= self.max_wait_s:
                            break
                        self._cond.wait(self.max_wait_s - age)
                    take, total = _next_run(self._queue, self.max_batch)
                    self._pending_rows -= total
                    depth = self._pending_rows
                self._depth_g.set(depth)
                if take:
                    self._dispatch(take, total)

    def _komi_rows(self, take: list, device) -> torch.Tensor | None:
        """The batch's komi per row (f32), or None when no request
        carries its own: a custom-komi request switches the whole batch
        to the komi evaluation, and the others ride it at
        ``default_komi``, which scores identically."""
        if all(r.komi is None for r in take):
            return None
        return torch.cat([
            torch.full((r.rows,), self.default_komi, dtype=torch.float32)
            if r.komi is None
            else torch.as_tensor(r.komi, dtype=torch.float32
                                 ).expand(r.rows)
            for r in take]).to(device)

    @torch.no_grad()
    def _dispatch(self, take: list, total: int) -> None:
        now = time.monotonic()
        for req in take:
            self._wait_h.observe(now - req.t_submit)
        size = self._padded_size(total)
        self.batches += 1
        try:
            # the soak tests' injection point: a fault here fails
            # exactly this batch's requests, never the dispatcher
            faults.barrier("serve.eval", iteration=self.batches)
            states = cat_states(r.states for r in take)
            komi = self._komi_rows(take, states.board.device)
            if komi is not None:
                self.komi_batches += 1
            if self.cache is not None:
                priors, values, devrows, size = self._eval_cached(
                    states, komi, take, total)
            else:
                if size > total:
                    # pad rows replicate row 0 and are sliced off below;
                    # the evaluation is per row, so real rows are
                    # independent of them
                    states = pad_rows(states, size)
                    if komi is not None:
                        komi = torch.cat(
                            [komi, komi[:1].expand(size - total)])
                priors, values = self.eval_direct(
                    states, komi=komi, version=take[0].version)
                devrows = total
        except Exception as e:  # noqa: BLE001 -- fail the batch, not the
            #                     dispatcher (the sessions' ladders
            #                     classify it)
            self.failures += 1
            self._fail_c.inc()
            for req in take:
                req._fail(e)
                self.release(req.version)
            return
        self.rows_total += total
        self.unique_rows_total += devrows
        self.padded_total += size
        self._rows_c.inc(total)
        if devrows:
            self._uniq_c.inc(devrows)
        if size:
            self._occ_h.observe(devrows / size)
            obs_registry.counter("serve_eval_batches_total",
                                 size=str(size)).inc()
        offset = 0
        for req in take:
            # views of the device outputs: the fan-out reads nothing
            # back to the host
            req._finish((priors[offset:offset + req.rows],
                         values[offset:offset + req.rows]))
            offset += req.rows
            self.release(req.version)

    # ------------------------------------------------- cached dispatch

    def _row_keys(self, states: GoState, take: list, total: int,
                  komi_rows: list, version: int):
        """Cache key and (symmetry) orientation per coalesced row.

        Zobrist mode: the signatures come from the requests' keys (one
        host read) or from ``key_fn`` on the coalesced states; key =
        ``(sig_hi, sig_lo, board, komi, version)``. Symmetry mode:
        exact canonical byte keys from host copies of the fields the
        planes read."""
        from rocalphago_tpu_torch.serve import evalcache

        if not self.cache.symmetry:
            if all(r.keys is not None for r in take):
                sig = torch.cat([torch.as_tensor(r.keys).reshape(r.rows, 2)
                                 .cpu() for r in take]).numpy()
            else:
                sig = np.asarray(torch.as_tensor(
                    self._key_fn(states)).cpu()).reshape(total, 2)
            keys = [(int(s[0]), int(s[1]), self.board, komi_rows[i],
                     version) for i, s in enumerate(sig)]
            return keys, None
        board_h = states.board.cpu().numpy()
        ages_h = states.stone_ages.cpu().numpy()
        steps_h = states.step_count.cpu().numpy()
        ko_h = states.ko.cpu().numpy()
        turn_h = states.turn.cpu().numpy()
        done_h = states.done.cpu().numpy()
        # the age bucket the turns-since planes one-hot; -1 marks an
        # empty point, so the byte key covers what the nets see
        buckets = np.clip(steps_h.reshape(-1, 1) - 1 - ages_h,
                          0, 7).astype(np.int8)
        buckets[board_h == 0] = -1
        keys, perms = [], []
        for i in range(total):
            core, t = evalcache.canonical_key(
                self.board, board_h[i], buckets[i], int(ko_h[i]),
                int(turn_h[i]), bool(done_h[i]))
            keys.append(core + (self.board, komi_rows[i], version))
            perms.append(t)
        return keys, perms

    def _eval_cached(self, states: GoState, komi, take: list, total: int):
        """The transposition-cache path: lookup, in-batch dedup of the
        misses, one padded device evaluation of the unique rows
        (skipped when everything hits), fan-out and insert. Returns
        ``(priors [total, A], values [total], unique device rows,
        padded size)`` on the states' device -- bit-identical to the
        plain path, every row being a device output row (fresh or
        cached). The unique rows are gathered on the device."""
        from rocalphago_tpu_torch.serve import evalcache

        cache = self.cache
        # the cache path's fault barrier: a fault here fails only this
        # batch, never the dispatcher
        faults.barrier("serve.cache", iteration=self.batches)
        version = take[0].version
        device = states.board.device
        if komi is None:
            komi_rows = [self.default_komi] * total
        else:
            komi_rows = [float(k) for k in komi.cpu().numpy()]
        keys, perms = self._row_keys(states, take, total, komi_rows,
                                     version)
        boards_b = None
        if cache.verify:
            bh = states.board.cpu().numpy()
            boards_b = [bh[i].tobytes() for i in range(total)]
        out_p: list = [None] * total
        out_v = np.zeros(total, np.float32)
        miss_idx: list = []        # the first row of each missed key
        dup_of: list = [None] * total
        first_miss: dict = {}
        for i, key in enumerate(keys):
            hit = cache.lookup(
                key, board_bytes=boards_b[i] if boards_b else None)
            if hit is not None:
                p, v = hit
                if perms is not None:
                    p = evalcache.orient_priors(p, perms[i], self.board)
                out_p[i] = p
                out_v[i] = v
                continue
            j = first_miss.get(key)
            if j is None:
                first_miss[key] = i
                miss_idx.append(i)
            else:
                dup_of[i] = j
        unique = len(miss_idx)
        padded = 0
        if unique:
            padded = self._padded_size(unique)
            # one gather per field, its index pre-padded to the batch
            # size with the first missed row (the replicas the plain
            # path pads with)
            idx = np.full(padded, miss_idx[0], np.int64)
            idx[:unique] = miss_idx
            idx_d = torch.as_tensor(idx, device=device)
            ustates = take_rows(states, idx_d)
            ukomi = None if komi is None else komi[idx_d]
            priors_d, values_d = self.eval_direct(ustates, komi=ukomi,
                                                  version=version)
            pr = priors_d[:unique].cpu().numpy()
            va = values_d[:unique].float().cpu().numpy()
            for r, i in enumerate(miss_idx):
                out_p[i] = pr[r]
                out_v[i] = va[r]
                store = pr[r]
                if perms is not None:
                    store = evalcache.canonicalize_priors(store, perms[i],
                                                          self.board)
                cache.insert(keys[i], (store, va[r]),
                             board_bytes=boards_b[i] if boards_b else None)
        saved = 0
        for i, j in enumerate(dup_of):
            if j is not None:
                out_p[i] = out_p[j]
                out_v[i] = out_v[j]
                saved += 1
        if saved:
            self.dedup_rows_saved_total += saved
            self._dedup_c.inc(saved)
        priors = torch.as_tensor(np.stack(out_p)).to(device)
        values = torch.as_tensor(out_v).to(device)
        return priors, values, unique, padded

    def _fail_pending(self) -> None:
        """Parked-dispatcher cleanup: fail everything queued so that no
        session blocks forever on a dead dispatcher."""
        with self._cond:
            leftovers = list(self._queue)
            self._queue.clear()
            self._pending_rows = 0
        err = self._thread.error
        for req in leftovers:
            req._fail(RuntimeError(
                f"evaluator dispatcher parked"
                f"{f' ({type(err).__name__}: {err})' if err else ''}"))
            self.release(req.version)

    # ------------------------------------------------------ lifecycle

    def drain_once(self) -> None:
        """Tests (``start=False``): run one dispatch round inline."""
        with self._cond:
            take, total = _next_run(self._queue, self.max_batch)
            self._pending_rows -= total
        if take:
            self._dispatch(take, total)

    def close(self) -> None:
        """Stop the dispatcher; pending requests fail (closed)."""
        with self._cond:
            self._stop = True
            leftovers = list(self._queue)
            self._queue.clear()
            self._pending_rows = 0
            self._cond.notify_all()
        for req in leftovers:
            req._fail(RuntimeError("evaluator closed"))
            self.release(req.version)
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    # ---------------------------------------------------------- stats

    def stats(self) -> dict:
        """The probe snapshot (``rocalphago-health``'s ``serve``
        block)."""
        from rocalphago_tpu_torch.serve import evalcache

        with self._cond:
            depth = self._pending_rows
            version = self._current
            swaps = self.swaps
        return {
            "batches": self.batches,
            "komi_batches": self.komi_batches,
            "rows": self.rows_total,
            "unique_rows": self.unique_rows_total,
            "dedup_saved": self.dedup_rows_saved_total,
            "failures": self.failures,
            "queue_depth": depth,
            "params_version": version,
            "swaps": swaps,
            # unique device rows / padded rows: dedup cannot inflate
            # occupancy past 1 (the plain path has unique == rows)
            "batch_occupancy": (
                round(self.unique_rows_total / self.padded_total, 4)
                if self.padded_total else None),
            "batch_sizes": list(self.batch_sizes),
            "max_wait_us": round(self.max_wait_s * 1e6, 1),
            "cache": (self.cache.stats() if self.cache is not None
                      else evalcache.disabled_stats()),
        }
