"""Feature-encoder API: the reference's ``Preprocess`` contract on
tensors, with the stateful incremental encode (:meth:`Preprocess.
advance`) for sequential host callers.

Planes are NHWC ``[B, size, size, F]`` float32, like the reference's.
States are the batched :class:`~..engine.torchgo.GoState` (use
``torchgo.from_pygo`` at host boundaries).

Telemetry (the reference's names, labels and edges): every public
encode lands in the per-position cost histogram ``encode_pos_us{board=}``
and ``encode_positions_total{board=}``, inside an ``encode`` span;
scratch encodes count ``encode_full_total``, delta encodes
``encode_delta_total`` and ``encode_incr_<field>_total``
(:func:`observe_incremental`), cache resets
``encode_cache_resets_total{reason=}`` (:func:`count_cache_reset`), and
each encoder built ``encode_encoders_total{planes=}``; the kernel
launches of each call land in ``kernel_launches_total{entry=,kernel=}``
under the reference's entry names ``encode.one``, ``encode.batch``,
``encode.signature`` and ``encode.delta`` (:mod:`..obs.torchobs`). The
public calls
are host boundaries (GTP players, the host MCTS wave, the converter,
the value-corpus generator; no chunk, segment or fleet round goes
through them), so on the card they synchronise before the clock is
read: the microseconds are the encode's, not its dispatch's.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from rocalphago_tpu_torch.device import resolve_device
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.engine.torchgo import GoConfig, GoState
from rocalphago_tpu_torch.features import incremental as _incr
from rocalphago_tpu_torch.features.planes import encode
from rocalphago_tpu_torch.features.pyfeatures import (
    DEFAULT_FEATURES,
    FEATURE_PLANES,
    LADDER_FEATURES,
    output_planes,
)
from rocalphago_tpu_torch.obs import registry as obs_registry
from rocalphago_tpu_torch.obs import trace
from rocalphago_tpu_torch.obs.torchobs import track

#: per-position encode cost edges, microseconds
ENCODE_US_EDGES = (10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
                   2500.0, 5000.0, 10000.0, 25000.0, 50000.0,
                   100000.0, 250000.0, 1000000.0)


def observe_incremental(prev_stats, new_stats, positions=None):
    """Fold one incremental step's stat delta into the process
    registry: ``encode_delta_total`` (positions through the delta path)
    and ``encode_incr_<field>_total`` per stat field. ``new_stats`` is
    a cache's ``stats`` (int32 ``[B, 9]``, read to the host here, so
    call it only where the caller already waits for the card);
    ``prev_stats`` the host totals this returned last time (None: a
    fresh cache). Returns the new totals (int64 numpy ``[9]``)."""
    cur = np.asarray(torch.as_tensor(new_stats).cpu().numpy(), np.int64) \
        .reshape(-1, len(_incr.STAT_FIELDS)).sum(axis=0)
    prev = (np.zeros_like(cur) if prev_stats is None
            else np.asarray(prev_stats, np.int64))
    if positions is None:
        positions = int(cur[_incr.STAT_ENCODES] - prev[_incr.STAT_ENCODES])
    if positions > 0:
        obs_registry.counter("encode_delta_total").inc(positions)
    for i, field in enumerate(_incr.STAT_FIELDS):
        if field == "encodes":
            continue            # encode_delta_total counts these
        d = int(cur[i] - prev[i])
        if d > 0:
            obs_registry.counter(f"encode_incr_{field}_total").inc(d)
    return cur


def count_cache_reset(reason: str) -> None:
    """Count one incremental-cache reset at a host boundary (a new
    game, a board change, a rewind):
    ``encode_cache_resets_total{reason=...}``."""
    obs_registry.counter("encode_cache_resets_total", reason=reason).inc()


class Preprocess:
    """Batched encoder over a fixed feature list and board config, on
    one device (CUDA unless ``device`` names another).

    Ladder capacity: ``ladder_depth`` rungs per read (default 40),
    ``ladder_lanes`` candidates per plane (16) and ``ladder_chase_slots``
    chases per encode, shared by both ladder planes (6); chases beyond
    the slots read the conservative False -- the reference's contract.
    """

    def __init__(self, feature_list=DEFAULT_FEATURES,
                 cfg: GoConfig = GoConfig(), ladder_depth: int = 40,
                 ladder_lanes: int = 16, ladder_chase_slots: int = 6,
                 device=None):
        unknown = [f for f in feature_list if f not in FEATURE_PLANES]
        if unknown:
            raise KeyError(f"unknown features: {unknown}")
        if not feature_list:
            raise ValueError("feature_list must name at least one feature")
        self.feature_list = tuple(feature_list)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.output_dim = output_planes(self.feature_list)
        self._lad_kw = dict(ladder_depth=ladder_depth,
                            ladder_lanes=ladder_lanes,
                            ladder_chase_slots=ladder_chase_slots)
        self._encode = functools.partial(
            encode, cfg, features=self.feature_list, **self._lad_kw)
        # the reference's tracked entries (obs.torchobs): one wrapper
        # per public encode, each counting its own kernel launches
        self._one = track("encode.one", self._encode)
        self._batch = track("encode.batch", self._encode)
        self._sig = track("encode.signature", functools.partial(
            torchgo.eval_signature, cfg))
        self._delta_step = track("encode.delta", functools.partial(
            _incr.encode_step, cfg, features=self.feature_list,
            **self._lad_kw))
        board = str(cfg.size)
        self._pos_us = obs_registry.histogram(
            "encode_pos_us", edges=ENCODE_US_EDGES, board=board)
        self._positions = obs_registry.counter("encode_positions_total",
                                               board=board)
        self._full = obs_registry.counter("encode_full_total")
        ladder = any(f in LADDER_FEATURES for f in self.feature_list)
        obs_registry.counter("encode_encoders_total",
                             planes="ladder" if ladder else "noladder").inc()
        # the incremental carry of advance() and the host totals of its
        # stats at the last call
        self._cache = None
        self._cache_stats = None

    def _on_device(self, states: GoState) -> GoState:
        return GoState(*(x.to(self.device) for x in states))

    def _timed(self, fn, batch: int, **tags):
        with trace.span("encode", board=self.cfg.size, batch=batch, **tags):
            t0 = time.monotonic()
            out = fn()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.monotonic() - t0
        self._pos_us.observe(dt * 1e6 / max(batch, 1))
        self._positions.inc(batch)
        return out

    @torch.no_grad()
    def _scratch(self, fn, states: GoState) -> torch.Tensor:
        batch = int(states.board.shape[0])
        self._full.inc(batch)
        return self._timed(lambda: fn(self._on_device(states)), batch)

    def states_to_tensor(self, states: GoState) -> torch.Tensor:
        """Batched states → ``[B, size, size, F]`` on this device."""
        return self._scratch(self._batch, states)

    def state_to_tensor(self, state: GoState) -> torch.Tensor:
        """A batch of one state → ``[1, size, size, F]``."""
        if state.board.shape[0] != 1:
            raise ValueError("state_to_tensor takes a batch of one state")
        return self._scratch(self._one, state)

    def state_signature(self, states: GoState) -> torch.Tensor:
        """Eval signatures (int64 ``[B, 2]`` holding uint32 words) of
        batched states: the transposition key under which these planes,
        and an evaluation of them, may be reused
        (:func:`~..engine.torchgo.eval_signature`)."""
        return self._sig(self._on_device(states))

    # ------------------------------------------------- incremental API

    def reset_cache(self, reason: str = "new_game") -> None:
        """Drop the incremental carry (a new game, a rewind, a jump the
        caller knows of) and count it per ``reason`` when there was
        one. Not needed for correctness: :meth:`advance` diffs boards,
        so a carried cache is always exact; a reset keeps the reuse
        statistics honest."""
        if self._cache is not None:
            count_cache_reset(reason)
        self._cache = None
        self._cache_stats = None

    @torch.no_grad()
    def advance(self, state: GoState, move=None) -> torch.Tensor:
        """Opt-in stateful encode of a batch of one → ``[1, size, size,
        F]``, bit-identical to :meth:`state_to_tensor` at every call:
        the carried :class:`~.incremental.EncodeCache` re-reads only
        the ladder lanes whose recorded footprint the board delta
        touched. ``move`` (a flat index, ``N`` = pass): step ``state``
        by it first and encode the successor; the caller keeps its own
        state. A cold or reset cache reads everything."""
        state = self._on_device(state)
        if state.board.shape[0] != 1:
            raise ValueError("advance takes a batch of one state")
        if move is not None:
            state = torchgo.step(self.cfg, state, torch.tensor(
                [int(move)], dtype=torch.int32, device=self.device))
        if self._cache is None:
            self._cache = _incr.init_cache(self.cfg, device=self.device)

        def run():
            planes, self._cache = self._delta_step(state, self._cache)
            return planes

        planes = self._timed(run, 1, delta=True)
        self._cache_stats = observe_incremental(self._cache_stats,
                                                self._cache.stats)
        return planes
