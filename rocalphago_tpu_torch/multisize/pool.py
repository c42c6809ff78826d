"""One FCN checkpoint serving every board size: the multi-size pool.

The port of the reference package's ``multisize/pool.py``. The fully
convolutional heads make the weights board-size-free, so one set of
weights plays 9×9, 13×13 and 19×19 unchanged, but the device search is
still one searcher per size (its slabs, planes and action spaces all
carry H×W). :class:`MultiSizePool` owns that split: the weights are
shared by reference across a ladder of per-size
:class:`~rocalphago_tpu_torch.serve.sessions.ServePool` s (each with its
own searcher and :class:`~rocalphago_tpu_torch.serve.evaluator.
BatchingEvaluator`), and sessions route by requested size. Opening a
game at another size is a dict lookup, not a model rebuild.

The per-size nets come from :meth:`~rocalphago_tpu_torch.models.
nn_util.NeuralNetBase.at_board`, which shares the caller's module;
size-locked heads (``dense`` / ``bias``) are refused at construction.
Each member pool labels its admission metrics with its size
(``serve_sessions_live{board=}``), and :meth:`MultiSizePool.stats`
publishes one ``ServePool.stats()`` row per active size under
``boards``.
"""

from __future__ import annotations

import threading

from rocalphago_tpu_torch.serve.sessions import ServePool, ServeSession

#: the ladder a multi-size deployment serves by default
DEFAULT_SIZES = (9, 13, 19)


class MultiSizePool:
    """A ladder of per-size :class:`ServePool`\\ s over ONE shared
    FCN param pytree.

    Parameters
    ----------
    value_net, policy_net : size-generic nets (``size_generic()``
        True: FCN heads); their modules are shared by reference with
        every per-size facade.
    sizes : board sizes to serve (default ``(9, 13, 19)``); more can
        join later via :meth:`add_size`.
    default_size : the size :meth:`open_session` uses when none is
        requested (default: the nets' native board if it is in
        ``sizes``, else the largest size).
    pool_kwargs : everything else (``n_sim``, ``batch_sizes``,
        ``slo_s``, ``metrics`` …) is forwarded to every member
        :class:`ServePool` unchanged.
    """

    def __init__(self, value_net, policy_net, sizes=DEFAULT_SIZES,
                 default_size: int | None = None, **pool_kwargs):
        for net in (policy_net, value_net):
            if not net.size_generic():
                raise ValueError(
                    f"{type(net).__name__} has a size-locked head "
                    f"({net.spec_kwargs.get('head')!r}): a multi-size "
                    "pool needs FCN heads (head='fcn')")
        self.policy = policy_net
        self.value = value_net
        self._pool_kwargs = dict(pool_kwargs)
        self._pool_kwargs["label_board"] = True
        # one transposition cache across the whole ladder, when given
        # (cache keys carry the board size: members cannot cross-hit)
        self.eval_cache = self._pool_kwargs.get("eval_cache")
        self.warmed = False
        self._lock = threading.Lock()
        self._pools: dict = {}            # guarded-by: self._lock
        sizes = tuple(sorted(set(int(s) for s in sizes)))
        if not sizes:
            raise ValueError("a multi-size pool needs at least one size")
        for s in sizes:
            self._build_pool(s)
        if default_size is None:
            default_size = (policy_net.board
                            if policy_net.board in sizes else sizes[-1])
        self.default_size = int(default_size)
        self.pool_for(self.default_size)   # default must be active

    # ------------------------------------------------------- routing

    def _build_pool(self, size: int) -> ServePool:
        # at_board nets share the caller's module by reference: the
        # whole ladder serves one checkpoint
        policy = (self.policy if size == self.policy.board
                  else self.policy.at_board(size))
        value = (self.value if size == self.value.board
                 else self.value.at_board(size))
        pool = ServePool(value, policy, **self._pool_kwargs)
        with self._lock:
            self._pools[size] = pool
        return pool

    @property
    def sizes(self) -> tuple:
        """Active sizes, ascending."""
        with self._lock:
            return tuple(sorted(self._pools))

    def pool_for(self, size: int) -> ServePool:
        """The member pool serving ``size`` (KeyError when the size
        is not active: :meth:`add_size` activates one)."""
        with self._lock:
            pool = self._pools.get(int(size))
        if pool is None:
            raise KeyError(
                f"board size {size} not active (serving "
                f"{self.sizes}); MultiSizePool.add_size({size}) "
                "activates it")
        return pool

    def add_size(self, size: int) -> ServePool:
        """Activate a new size (idempotent): builds its pool (warmed by
        :meth:`warm`, or on its first traffic)."""
        size = int(size)
        with self._lock:
            pool = self._pools.get(size)
        return pool if pool is not None else self._build_pool(size)

    # ------------------------------------------------------ sessions

    def open_session(self, size: int | None = None,
                     **kwargs) -> ServeSession:
        """Admit one game at ``size`` (default ``default_size``);
        kwargs (``resilient``, ``komi`` …) go to
        :meth:`ServePool.open_session`."""
        return self.pool_for(
            self.default_size if size is None else size
        ).open_session(**kwargs)

    def driver(self, sessions):
        """Fleet drive over ``sessions``, which must all live in the
        same member pool (the lockstep drive stacks trees on one batch
        axis; mixed H×W cannot stack)."""
        boards = {s.raw.board for s in sessions}
        if len(boards) != 1:
            raise ValueError(
                f"fleet driver needs one board size, got {sorted(boards)}")
        return self.pool_for(boards.pop()).driver(sessions)

    # -------------------------------------------------------- rollout

    @property
    def params_version(self) -> int:
        """The ladder's version (the default pool's: every fan-out below
        applies one version number to all sizes)."""
        return self.pool_for(self.default_size).params_version

    def _fanout(self, op, version: int | None = None) -> int:
        # one version number across the ladder: the first pool
        # allocates it (when version is None), the rest reuse it
        v = version
        for s in self.sizes:
            v = op(self.pool_for(s), v)
        return v

    def set_params(self, params_p=None, params_v=None,
                   version: int | None = None) -> int:
        """Hot-swap every member pool to the state dicts ``(params_p,
        params_v)`` (or promote a registered ``version``): one checkpoint,
        one version number, every size. The source nets follow (by
        reference, as each member pool's do), so a later
        :meth:`add_size` net shares the new weights."""
        v = self._fanout(
            lambda pool, ver: pool.set_params(params_p, params_v,
                                              version=ver),
            version)
        self._follow()
        return v

    def _follow(self) -> None:
        """The source nets take the default pool's current modules (one
        attribute store each)."""
        pool = self.pool_for(self.default_size)
        self.policy.module = pool.policy.module
        self.value.module = pool.value.module

    def stage_params(self, params_p, params_v,
                     version: int | None = None) -> int:
        """Stage a candidate on every member pool (the canary's arm), one
        version number across the ladder."""
        return self._fanout(
            lambda pool, ver: pool.stage_params(params_p, params_v,
                                                version=ver),
            version)

    def promote_version(self, version: int) -> int:
        """Promote a staged version on every member pool."""
        v = int(version)
        for s in self.sizes:
            self.pool_for(s).promote_version(v)
        self._follow()
        return v

    def discard_version(self, version: int) -> None:
        """Retire a staged version on every member pool."""
        for s in self.sizes:
            self.pool_for(s).discard_version(version)

    # -------------------------------------------------------- warmup

    def warm(self, sizes=None) -> None:
        """Warm every (or the given) member pool before traffic."""
        for s in (self.sizes if sizes is None else sizes):
            self.pool_for(s).warm()
        self.warmed = True

    # ----------------------------------------------------- lifecycle

    def close(self) -> None:
        with self._lock:
            pools = list(self._pools.values())
        for pool in pools:
            pool.close()

    def __enter__(self) -> "MultiSizePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------- stats

    def stats(self) -> dict:
        """The multi-size probe block: one ``ServePool.stats()`` row
        per active size, plus the routing facts a balancer needs."""
        with self._lock:
            pools = dict(self._pools)
        boards = {str(s): pools[s].stats() for s in sorted(pools)}
        return {
            "multisize": True,
            "default_board": self.default_size,
            "params_version": self.params_version,
            "sessions_live": sum(
                b["sessions"]["live"] for b in boards.values()),
            "boards": boards,
        }
