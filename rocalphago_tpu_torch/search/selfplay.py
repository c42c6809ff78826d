"""Batched self-play on the card: the port of ``search/selfplay.py``.

Games run in lockstep over a batch: every ply encodes every game
(the 48 planes, the ladder planes through the chase kernel), runs the
policy forwards, samples a move among the sensible ones and steps the
rules engine, all on tensors of the whole batch. A ply makes no
device→host sync, so the host queues plies ahead of the card; the
chunked runner reads back only a retired segment's done flag
(:class:`~rocalphago_tpu_torch.runtime.pipeline.ChunkPipeline`).

Colours: games in the first half of the batch have net A as Black, the
second half net B, so every ply runs one half-batch forward through
each net; on odd plies the halves are swapped (a roll by ``B/2``). The
ply index is a host integer, so the swap is a host branch.

Move rule, the reference's: sample from ``softmax(logits / T)`` over the
*sensible* moves (legal, not filling an own true eye), pass only when
no move is sensible. Games end by two passes or at ``max_moves``;
unfinished games are scored as they stand (area scoring).

:func:`make_device_rollout` is the rollout leg of the host MCTS's λ
mix on the card: one rollout net plays a wave of leaves to the end,
reading the done flag once every :data:`ROLLOUT_CHECK_PLIES` plies.

Incremental encode (``incremental=``, default
:data:`INCREMENTAL_DEFAULT`): each game's ply encodes through an
:class:`~..features.incremental.EncodeCache` carried from ply to ply
(cold at the start of every run, carried across segments), which
re-reads only the ladder lanes the last move could change. The planes,
and so the games, are the same bit for bit, and a ply still makes no
host sync.

Telemetry, the reference's names: ``selfplay_segment_seconds`` and
``selfplay_plies_total`` per segment of the chunked runner, and the
fault barrier ``selfplay.chunk`` before each segment.

The sampler is Gumbel-max -- ``argmax(masked + G)`` with ``G =
-log(-log(U))`` drawn from the caller's ``torch.Generator`` -- in place
of ``torch.multinomial``, which raises a device-side assert on a row
with no sensible move. The reference draws from JAX's RNG, which torch
cannot reproduce: the parity tests replay the reference's actions
through :meth:`Ply.logits` and :meth:`Ply.advance` and compare
everything but the draw (``tests/test_torch_selfplay.py``).
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from rocalphago_tpu_torch.device import resolve_device
from rocalphago_tpu_torch.engine.pygo import score_board
from rocalphago_tpu_torch.engine.torchgo import (
    GoConfig,
    GoState,
    group_data,
    legal_mask,
    new_states,
    step,
    winner,
)
from rocalphago_tpu_torch.features.incremental import (
    encode_step,
    init_caches,
)
from rocalphago_tpu_torch.features.planes import encode, true_eyes
from rocalphago_tpu_torch.obs import registry as obs_registry
from rocalphago_tpu_torch.runtime import faults
from rocalphago_tpu_torch.runtime.pipeline import ChunkPipeline

# plies a device rollout plays between two reads of its done flag: the
# reference's while_loop tests the flag on the device every ply, which
# in eager PyTorch would be a device→host sync a ply
ROLLOUT_CHECK_PLIES = 16

#: whether the self-play runners encode incrementally by default: the
#: mode the card measured faster (PERF.md §6)
INCREMENTAL_DEFAULT = False


def sensible_mask(cfg: GoConfig, state: GoState, gd=None) -> torch.Tensor:
    """bool ``[B, N]``: legal board moves that do not fill an own true
    eye (the reference's ``get_legal_moves(include_eyes=False)``). Pass
    a precomputed ``gd`` to share the group analysis."""
    if gd is None:
        gd = group_data(cfg, state.board, with_zxor=cfg.enforce_superko,
                        labels=state.labels)
    legal = legal_mask(cfg, state, gd)[:, :-1]
    return legal & ~true_eyes(cfg, state, state.turn)


class SelfplayResult(NamedTuple):
    final: GoState             # batched end states
    actions: torch.Tensor      # int32 [T, B] action per ply (N = pass)
    live: torch.Tensor         # bool  [T, B] game was live when ply t played
    winners: torch.Tensor      # int32 [B]    +1 black / -1 white / 0
    num_moves: torch.Tensor    # int32 [B]    plies actually played


def _half_swap(x: torch.Tensor, swap: bool) -> torch.Tensor:
    """Swap the batch halves when ``swap``."""
    return torch.roll(x, x.shape[0] // 2, dims=0) if swap else x


def gumbel_argmax(logits: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of ``logits`` (int64 ``[B]``), by
    Gumbel-max: no host sync, and a row of minimum or ``-inf`` entries
    still yields an index (0 when the row is all ``-inf``)."""
    u = torch.rand(logits.shape, generator=generator,
                   device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


class Ply:
    """One ply of lockstep two-net self-play (the reference's
    ``_make_ply``), in three parts: :meth:`logits`, :meth:`sample` and
    :meth:`advance`; calling the ply composes them. ``policy_a`` and
    ``policy_b`` map NHWC float32 planes ``[B/2, s, s, F]`` to float32
    logits ``[B/2, N]``. Owns the even-batch rule: the colour split
    slices at ``batch // 2``.

    ``incremental``: encode through ``caches``, the games' encode
    caches, carried from each :meth:`logits` call to the next (made cold
    on the states' device when None; a runner sets it to None at the
    start of every run)."""

    def __init__(self, cfg: GoConfig, features: tuple, policy_a: Callable,
                 policy_b: Callable, batch: int, temperature: float,
                 incremental: bool = False):
        if batch % 2:
            raise ValueError(
                f"batch must be even (half-and-half colour split), got "
                f"{batch}")
        self.cfg = cfg
        self.features = tuple(features)
        self.policy_a = policy_a
        self.policy_b = policy_b
        self.batch = batch
        self.temperature = temperature
        self.incremental = incremental
        self.caches = None

    @torch.no_grad()
    def logits(self, states: GoState, t: int):
        """``(masked f32 [B, N], gd, sens bool [B, N])`` at ply ``t``:
        one group analysis shared by the encode, the mask and the step;
        each half of the batch through the net that plays it; logits
        over ``temperature`` where sensible, the type's minimum
        elsewhere."""
        cfg = self.cfg
        gd = group_data(cfg, states.board, with_zxor=cfg.enforce_superko,
                        labels=states.labels)
        if self.incremental:
            if self.caches is None:
                self.caches = init_caches(cfg, self.batch,
                                          device=states.board.device)
            planes, self.caches = encode_step(cfg, states, self.caches,
                                              self.features, gd=gd)
        else:
            planes = encode(cfg, states, self.features, gd=gd)
        swap = t % 2 == 1
        rolled = _half_swap(planes, swap)
        half = self.batch // 2
        logits = _half_swap(torch.cat([self.policy_a(rolled[:half]),
                                       self.policy_b(rolled[half:])]), swap)
        sens = sensible_mask(cfg, states, gd)
        masked = torch.where(sens, logits / self.temperature,
                             torch.finfo(logits.dtype).min)
        return masked, gd, sens

    def sample(self, masked: torch.Tensor, sens: torch.Tensor,
               generator: torch.Generator) -> torch.Tensor:
        """int32 ``[B]``: a draw from ``softmax(masked)``, pass where no
        move is sensible."""
        board_action = gumbel_argmax(masked, generator)
        must_pass = ~sens.any(dim=-1)
        return torch.where(must_pass, self.cfg.num_points,
                           board_action).int()

    @torch.no_grad()
    def advance(self, states: GoState, action: torch.Tensor, gd):
        """``(new states, live bool [B])``: step every game by its
        action on the ply's analysis; ``live`` marks the games that were
        not over before it."""
        return step(self.cfg, states, action, gd), ~states.done

    def __call__(self, states: GoState, generator: torch.Generator,
                 t: int):
        """``(new states, action i32 [B], live bool [B])``."""
        masked, gd, sens = self.logits(states, t)
        action = self.sample(masked, sens, generator)
        new, live = self.advance(states, action, gd)
        return new, action, live


def _finish(cfg: GoConfig, final: GoState, actions: torch.Tensor,
            live: torch.Tensor) -> SelfplayResult:
    """Result assembly shared by the runners: the winners scored on the
    card (one labels launch)."""
    return SelfplayResult(final, actions, live, winner(cfg, final),
                          live.sum(dim=0, dtype=torch.int32))


def _run_plies(ply: Ply, states: GoState, generator: torch.Generator,
               ts):
    """Play the plies ``ts``; ``(states, actions [T, B], live [T, B])``
    as lists of rows."""
    acts, lives = [], []
    for t in ts:
        states, action, live = ply(states, generator, t)
        acts.append(action)
        lives.append(live)
    return states, acts, lives


def _stack(rows: list, batch: int, dtype, device) -> torch.Tensor:
    if not rows:
        return torch.zeros((0, batch), dtype=dtype, device=device)
    return torch.stack(rows)


def _incremental(incremental: bool | None) -> bool:
    return INCREMENTAL_DEFAULT if incremental is None else incremental


def play_games(cfg: GoConfig, features: tuple, policy_a: Callable,
               policy_b: Callable, generator: torch.Generator, batch: int,
               max_moves: int = 500, temperature: float = 1.0,
               device=None, incremental: bool | None = None
               ) -> SelfplayResult:
    """Play ``batch`` lockstep games of net A against net B for
    ``max_moves`` plies. First half of the batch: A is Black; second
    half: B is Black. ``generator`` (on ``device``) drives the draws;
    ``device`` defaults to the card; ``incremental`` (default
    :data:`INCREMENTAL_DEFAULT`) carries an encode cache per game."""
    dev = resolve_device(device)
    ply = Ply(cfg, features, policy_a, policy_b, batch, temperature,
              _incremental(incremental))
    final, acts, lives = _run_plies(
        ply, new_states(cfg, batch, device=dev), generator,
        range(max_moves))
    return _finish(cfg, final, _stack(acts, batch, torch.int32, dev),
                   _stack(lives, batch, torch.bool, dev))


def make_selfplay(cfg: GoConfig, features: tuple, policy_a: Callable,
                  policy_b: Callable, batch: int, max_moves: int = 500,
                  temperature: float = 1.0, device=None,
                  incremental: bool | None = None):
    """``run(generator) -> SelfplayResult``: :func:`play_games` with
    its configuration bound."""
    dev = resolve_device(device)

    def run(generator: torch.Generator) -> SelfplayResult:
        return play_games(cfg, features, policy_a, policy_b, generator,
                          batch, max_moves, temperature, device=dev,
                          incremental=incremental)

    return run


def make_selfplay_chunked(cfg: GoConfig, features: tuple,
                          policy_a: Callable, policy_b: Callable,
                          batch: int, max_moves: int = 500,
                          chunk: int = 100, temperature: float = 1.0,
                          device=None, incremental: bool | None = None):
    """:func:`make_selfplay` in segments of ``chunk`` plies, driven
    through a :class:`ChunkPipeline` (one segment in flight while the
    host queues the next). The same generator gives the same games as
    the monolithic runner: the plies and their draws are the same.

    Returns ``run(generator, initial_states=None, deadline=None,
    stop_when_done=False, pipeline=None) -> SelfplayResult``:

    * ``initial_states`` (batched, on the device; default fresh games)
      continues play from given positions; they are not changed.
    * ``deadline`` (an absolute ``time.time()``): no segment starts
      after it; the one in flight completes, and the result then has
      fewer than ``max_moves`` rows (the short shape is the caller's
      sign of a truncation).
    * ``stop_when_done``: stop once every game has ended. Each
      segment's done flag is computed at its dispatch and read from a
      *retired* segment, so the host never waits on the fresh one; the
      one extra segment that may run on finished games steps nothing
      (the engine freezes them), and the rows from the first all-done
      segment on are zeros, so the result keeps its ``[max_moves, B]``
      shape whatever the timing. ``live``, ``num_moves`` and ``final``
      are those of the monolithic run.
    * ``pipeline``: share one pipeline across calls (its
      ``host_gap_frac``).

    ``incremental`` (default :data:`INCREMENTAL_DEFAULT`): the games'
    encode caches start cold with each run and ride across its
    segments. ``run.ply`` is the :class:`Ply` the segments play."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    dev = resolve_device(device)
    ply = Ply(cfg, features, policy_a, policy_b, batch, temperature,
              _incremental(incremental))
    seg_h = obs_registry.histogram("selfplay_segment_seconds")
    plies_c = obs_registry.counter("selfplay_plies_total")

    def run(generator: torch.Generator, initial_states: GoState | None = None,
            deadline: float | None = None, stop_when_done: bool = False,
            pipeline: ChunkPipeline | None = None) -> SelfplayResult:
        states = (new_states(cfg, batch, device=dev)
                  if initial_states is None else initial_states)
        ply.caches = None            # cold per run
        pipe = (pipeline if pipeline is not None
                else ChunkPipeline(dev, runner="selfplay"))
        acts, lives = [], []
        done_plies = None

        def first_done(retired):
            # retire order is dispatch order and done is monotonic
            for seg_plies, handle in retired:
                if handle is not None and bool(handle):
                    return seg_plies
            return None

        for offset in range(0, max_moves, chunk):
            if deadline is not None and time.time() > deadline:
                break
            faults.barrier("selfplay.chunk", offset)
            length = min(chunk, max_moves - offset)
            t0 = time.monotonic()
            states, a, lv = _run_plies(ply, states, generator,
                                       range(offset, offset + length))
            acts += a
            lives += lv
            plies_c.inc(length)
            handle = states.done.all() if stop_when_done else None
            retired = pipe.push(handle, payload=offset + length)
            seg_h.observe(time.monotonic() - t0)
            if stop_when_done:
                done_plies = first_done(retired)
                if done_plies is not None:
                    break
        if stop_when_done:
            retired = pipe.drain()
            if done_plies is None:
                done_plies = first_done(retired)
        else:
            pipe.finish()
        actions = _stack(acts, batch, torch.int32, dev)
        live = _stack(lives, batch, torch.bool, dev)
        if done_plies is not None:
            pad = max_moves - done_plies
            actions = torch.cat([actions[:done_plies], torch.zeros(
                (pad, batch), dtype=torch.int32, device=dev)])
            live = torch.cat([live[:done_plies], torch.zeros(
                (pad, batch), dtype=torch.bool, device=dev)])
        return _finish(cfg, states, actions, live)

    run.ply = ply
    return run


def host_winners(cfg: GoConfig, boards) -> np.ndarray:
    """Area-score final boards on the host: int32 ``[B]`` (+1/-1/0),
    the rules oracle's :func:`~..engine.pygo.score_board` per board.
    Equals :func:`~..engine.torchgo.winner` on the same boards."""
    if isinstance(boards, torch.Tensor):
        boards = boards.cpu().numpy()
    size = cfg.size
    boards = np.asarray(boards, np.int8).reshape(-1, size, size)
    out = np.zeros(len(boards), np.int32)
    for b, board in enumerate(boards):
        black, white = score_board(board, cfg.komi)
        diff = black - white
        out[b] = 0 if diff == 0 else (1 if diff > 0 else -1)
    return out


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws, float32 on the generator's device:
    ``-log(-log(u))`` with ``u`` uniform in ``[finfo.tiny, 1)``, as JAX's
    ``random.gumbel`` draws them."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(
        torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def make_device_rollout(cfg: GoConfig, features: tuple, apply_fn: Callable,
                        rollout_limit: int = 500, temperature: float = 1.0,
                        with_steps: bool = False):
    """``run(states, generator=None, noise=None, record=None) ->
    winners`` (``with_steps=True``: ``-> (winners, executed_plies)``):
    play a batched :class:`GoState` -- a wave of MCTS leaves -- to the
    end of the game, at most ``rollout_limit`` more plies, with one
    rollout net (``apply_fn``: NHWC planes → float32 logits) playing
    both colours, then area-score. Winners are int32 ``[B]`` (+1 black,
    -1 white, 0 draw) on the states' device.

    Each ply: the group analysis, the encode of ``features``, the
    forward, the sensible mask, ``masked = where(sens, logits / T,
    finfo.min)``, a categorical draw by Gumbel-max (``argmax(masked +
    g)``, the form of ``jax.random.categorical``), a pass on rows with
    nothing sensible, and ``step``. Finished or padded games stay frozen.

    The loop ends at the first ply after which every game is done, as
    the reference's ``while_loop`` does, but it reads the done flag only
    once every :data:`ROLLOUT_CHECK_PLIES` plies (each ply records its
    flag on the device; a segment's flags come back in one read). The
    few plies past the end step nothing, so the winners are the same;
    ``executed_plies`` is the reference's count.

    ``g`` is drawn from ``generator`` (on the states' device), or taken
    from ``noise[t]`` at ply ``t`` (float32 ``[B, N]`` rows -- the seam
    for the reference's draws). ``record``, a list, receives the int32
    ``[B]`` actions of the executed plies. ``run.ply(states, g) ->
    (states, action)`` is one ply."""
    n = cfg.num_points

    def ply(states: GoState, g: torch.Tensor):
        gd = group_data(cfg, states.board, with_zxor=cfg.enforce_superko,
                        labels=states.labels)
        logits = apply_fn(encode(cfg, states, features, gd=gd))
        sens = sensible_mask(cfg, states, gd)
        masked = torch.where(sens, logits / temperature,
                             torch.finfo(logits.dtype).min)
        action = torch.argmax(masked + g.to(masked.device), dim=-1)
        action = torch.where(sens.any(dim=-1), action, n).int()
        return step(cfg, states, action, gd), action

    @torch.no_grad()
    def run(states: GoState, generator: torch.Generator | None = None,
            noise=None, record: list | None = None):
        b = states.board.shape[0]
        kept = len(record) if record is not None else 0
        # counts[k]: plies played when flags[k] was taken
        counts, flags = [0], [states.done.all()]
        t = 0
        executed = rollout_limit
        while t < rollout_limit:
            for _ in range(min(ROLLOUT_CHECK_PLIES, rollout_limit - t)):
                g = (noise[t] if noise is not None
                     else gumbel_noise((b, n), generator))
                states, action = ply(states, g)
                if record is not None:
                    record.append(action)
                t += 1
                counts.append(t)
                flags.append(states.done.all())
            hit = np.flatnonzero(torch.stack(flags).cpu().numpy())
            if hit.size:
                executed = counts[hit[0]]
                break
            counts, flags = [], []
        if record is not None:
            del record[kept + executed:]
        winners = winner(cfg, states)
        return (winners, executed) if with_steps else winners

    run.ply = ply
    return run
