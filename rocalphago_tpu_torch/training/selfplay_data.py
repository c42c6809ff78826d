"""Self-play (state, outcome) corpus for value training, on one card.

The port of ``training/selfplay_data.py``. Following the AlphaGo
paper's recipe, each game draws a random ply U, plays plies ``t < U``
with the SL policy, ply ``U`` uniformly at random over the sensible
moves and plies ``t > U`` with the RL policy, and records exactly ONE
position per game: the state right after the random move, labelled
with the game's final outcome from that position's player to move.

Games run in lockstep over a batch, like :mod:`..search.selfplay`:
every ply encodes every game (the ladder planes through the chase
kernel), runs both policies on the whole batch, draws the three
candidate actions and picks one per game by ``t < U``, ``t == U`` or
``t > U``; the recorded position is a per-game select of the state
into a snapshot, so no ``[T, B, ...]`` planes are kept. Games are
scored once per batch (:func:`~..engine.torchgo.winner`, one labels
launch), and the snapshots are encoded with the *value* feature set
in one batched call and written in the npz shard layout the input
pipeline reads (``"targets": "outcome"``, z in the ``actions`` slot).

The draws come from a ``torch.Generator``, which cannot reproduce the
reference's JAX streams: the parity tests hand the reference's U to
the runners (their ``U`` argument) and its actions to
:meth:`ValuePly.sample`'s place (``tests/test_torch_selfplay_data.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from rocalphago_tpu_torch.device import resolve_device
from rocalphago_tpu_torch.engine.torchgo import (
    GoConfig,
    GoState,
    default_komi,
    group_data,
    new_states,
    step,
    where_rows,
    winner,
)
from rocalphago_tpu_torch.features import Preprocess
from rocalphago_tpu_torch.features.planes import encode
from rocalphago_tpu_torch.models.nn_util import NeuralNetBase
from rocalphago_tpu_torch.runtime.pipeline import ChunkPipeline
from rocalphago_tpu_torch.search.selfplay import gumbel_argmax, sensible_mask


class ValueSamples(NamedTuple):
    recorded: GoState        # batched snapshot states (one per game)
    z: torch.Tensor          # int32 [B] outcome for the player to move
    valid: torch.Tensor      # bool  [B] game reached its sample ply
    u: torch.Tensor          # int32 [B] the game's random-ply index U


class ValuePly:
    """One ply of the mixed-policy value game (the reference's
    ``_make_value_ply``), in parts: :meth:`record`, :meth:`logits`,
    :meth:`sample` and the rules step; calling the ply composes them.
    ``policy_sl`` and ``policy_rl`` map NHWC float32 planes to float32
    logits ``[B, N]``."""

    def __init__(self, cfg: GoConfig, features: tuple, policy_sl: Callable,
                 policy_rl: Callable, temperature: float):
        self.cfg = cfg
        self.features = tuple(features)
        self.policy_sl = policy_sl
        self.policy_rl = policy_rl
        self.temperature = temperature

    @staticmethod
    def record(states: GoState, rec: GoState, recorded: torch.Tensor,
               U: torch.Tensor, t: int):
        """``(rec, recorded)`` with ply ``t``'s pre-state snapshotted in
        the games where ``t == U + 1``: the position right after the
        random move U."""
        hit = (U + 1 == t) & ~states.done & ~recorded
        return where_rows(hit, states, rec), recorded | hit

    @torch.no_grad()
    def logits(self, states: GoState):
        """``(masked SL f32 [B, N], masked RL f32 [B, N], sens bool [B,
        N], gd)``: one group analysis shared by the encode, the mask and
        the step; both policies on the whole batch, logits over the
        temperature where sensible, the type's minimum elsewhere."""
        cfg = self.cfg
        gd = group_data(cfg, states.board, with_zxor=cfg.enforce_superko,
                        labels=states.labels)
        planes = encode(cfg, states, self.features, gd=gd)
        sens = sensible_mask(cfg, states, gd)
        neg = torch.finfo(torch.float32).min
        masked_sl = torch.where(sens, self.policy_sl(planes)
                                / self.temperature, neg)
        masked_rl = torch.where(sens, self.policy_rl(planes)
                                / self.temperature, neg)
        return masked_sl, masked_rl, sens, gd

    def sample(self, masked_sl: torch.Tensor, masked_rl: torch.Tensor,
               sens: torch.Tensor, U: torch.Tensor, t: int,
               generator: torch.Generator) -> torch.Tensor:
        """int32 ``[B]``: all three candidates drawn (SL, RL, uniform
        over the sensible moves, in that order), one picked per game by
        ply; a pass where no move is sensible."""
        a_sl = gumbel_argmax(masked_sl, generator)
        a_rl = gumbel_argmax(masked_rl, generator)
        a_rand = gumbel_argmax(torch.where(
            sens, 0.0, torch.finfo(torch.float32).min), generator)
        board_action = torch.where(U > t, a_sl,
                                   torch.where(U == t, a_rand, a_rl))
        return torch.where(~sens.any(dim=-1), self.cfg.num_points,
                           board_action).int()

    def __call__(self, carry, U: torch.Tensor, t: int,
                 generator: torch.Generator):
        """``(states, rec, recorded)`` after ply ``t``."""
        states, rec, recorded = carry
        rec, recorded = self.record(states, rec, recorded, U, t)
        masked_sl, masked_rl, sens, gd = self.logits(states)
        action = self.sample(masked_sl, masked_rl, sens, U, t, generator)
        with torch.no_grad():
            return step(self.cfg, states, action, gd), rec, recorded


def _value_u_cap(max_moves: int, u_max: int | None) -> int:
    return min(u_max if u_max is not None else max_moves - 2,
               max_moves - 2)


def _begin(cfg: GoConfig, batch: int, u_cap: int, generator, dev, U=None):
    """The first carry and U: drawn from ``generator`` unless given."""
    if U is None:
        U = torch.randint(0, u_cap + 1, (batch,), generator=generator,
                          device=dev)
    U = U.to(dev, torch.int32)
    states0 = new_states(cfg, batch, device=dev)
    return (states0, states0, torch.zeros(batch, dtype=torch.bool,
                                          device=dev)), U


def _value_finish(cfg: GoConfig, final: GoState, rec: GoState,
                  recorded: torch.Tensor, U: torch.Tensor) -> ValueSamples:
    """Outcomes from each snapshot's player to move; the games scored
    on the device (one labels launch)."""
    z = winner(cfg, final) * rec.turn.int()
    return ValueSamples(rec, z, recorded, U)


def play_value_games(cfg: GoConfig, features: tuple, policy_sl: Callable,
                     policy_rl: Callable, generator: torch.Generator,
                     batch: int, max_moves: int = 500,
                     temperature: float = 1.0, u_max: int | None = None,
                     U: torch.Tensor | None = None,
                     device=None) -> ValueSamples:
    """Play ``batch`` mixed-policy games for ``max_moves`` plies, one
    value sample per game.

    ``features`` is the *policy* nets' feature set (used in the game
    loop); encode the returned snapshots with the value net's own
    preprocess. ``u_max`` caps the random ply U (default ``max_moves -
    2``, so the recorded position can exist); ``U`` (int ``[B]``)
    replaces its draw when given. ``device`` defaults to the card."""
    dev = resolve_device(device)
    ply = ValuePly(cfg, features, policy_sl, policy_rl, temperature)
    carry, U = _begin(cfg, batch, _value_u_cap(max_moves, u_max),
                      generator, dev, U)
    for t in range(max_moves):
        carry = ply(carry, U, t, generator)
    return _value_finish(cfg, *carry, U)


def make_value_games_chunked(cfg: GoConfig, features: tuple,
                             policy_sl: Callable, policy_rl: Callable,
                             batch: int, max_moves: int = 500,
                             temperature: float = 1.0,
                             u_max: int | None = None, chunk: int = 100,
                             device=None):
    """``run(generator, U=None) -> ValueSamples``: the games of
    :func:`play_value_games` in segments of ``chunk`` plies through a
    :class:`ChunkPipeline`, stopping once every game has ended (the
    remaining plies change neither the snapshots nor the outcomes).
    Each segment's done flag is read from a *retired* segment, so the
    host never waits on the fresh one. The samples equal the
    monolithic run's on the same generator; the generator may be left
    at another state. ``run.ply`` is the :class:`ValuePly` the
    segments play."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    dev = resolve_device(device)
    ply = ValuePly(cfg, features, policy_sl, policy_rl, temperature)
    u_cap = _value_u_cap(max_moves, u_max)

    def run(generator: torch.Generator,
            U: torch.Tensor | None = None) -> ValueSamples:
        carry, U = _begin(cfg, batch, u_cap, generator, dev, U)
        pipe = ChunkPipeline(dev)
        for offset in range(0, max_moves, chunk):
            for t in range(offset, min(offset + chunk, max_moves)):
                carry = ply(carry, U, t, generator)
            retired = pipe.push(carry[0].done.all())
            if any(bool(handle) for _, handle in retired):
                break
        pipe.finish()
        return _value_finish(cfg, *carry, U)

    run.ply = ply
    return run


def batch_seed(seed: int, index: int) -> int:
    """The generator seed of batch ``index`` of a corpus: each batch's
    draws depend on (seed, index) only, so a runner that stops early
    changes no later batch."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


class ValueDataGenerator:
    """Host loop: batches of games on the device → sharded npz
    corpus. Runs on the nets' device."""

    def __init__(self, sl_net: NeuralNetBase, rl_net: NeuralNetBase,
                 value_features: tuple, batch: int = 64,
                 max_moves: int = 500, temperature: float = 1.0,
                 u_max: int | None = None, chunk: int = 0,
                 komi: float | None = None):
        if sl_net.feature_list != rl_net.feature_list or \
                sl_net.board != rl_net.board:
            raise ValueError("SL and RL nets must share features/board")
        if sl_net.device != rl_net.device:
            raise ValueError(f"the SL net is on {sl_net.device}, the RL "
                             f"net on {rl_net.device}")
        self.device = sl_net.device
        # scoring komi: per-board-size standard unless overridden
        # (the net spec's GoConfig always carries the 19x19 value)
        self.cfg = dataclasses.replace(
            sl_net.cfg, komi=komi if komi is not None
            else default_komi(sl_net.cfg.size))
        self.pre = Preprocess(value_features, cfg=self.cfg,
                              device=self.device)
        self.batch = batch
        args = (self.cfg, sl_net.feature_list, sl_net.module,
                rl_net.module, batch)
        kw = dict(max_moves=max_moves, temperature=temperature,
                  u_max=u_max, device=self.device)
        if chunk:
            self._run = make_value_games_chunked(*args, chunk=chunk, **kw)
        else:
            self._run = functools.partial(play_value_games, *args[:4],
                                          batch=batch, **kw)

    def generate(self, n_positions: int, out_prefix: str,
                 seed: int = 0, shard_size: int = 4096) -> dict:
        """Accumulate ≥ ``n_positions`` valid samples into
        ``{out_prefix}-NNNNN.npz`` shards + manifest (input-pipeline
        layout; z stored in the ``actions`` slot, ``targets:
        "outcome"``). Draws (a decided outcome, z 0) are dropped."""
        os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
        generator = torch.Generator(device=self.device)
        shard_counts: list[int] = []
        buf_s, buf_z, total = [], [], 0
        shard_id = 0

        def flush():
            nonlocal shard_id
            if not buf_s:
                return
            np.savez_compressed(
                f"{out_prefix}-{shard_id:05d}.npz",
                states=np.concatenate(buf_s),
                actions=np.concatenate(buf_z))
            shard_counts.append(sum(len(b) for b in buf_s))
            shard_id += 1
            buf_s.clear()
            buf_z.clear()

        dry_batches = 0
        index = 0
        while total < n_positions:
            generator.manual_seed(batch_seed(seed, index))
            index += 1
            samples = self._run(generator)
            planes = self.pre.states_to_tensor(samples.recorded)
            planes = (planes > 0.5).to(torch.uint8).cpu().numpy()
            valid = samples.valid.cpu().numpy()
            z = samples.z.cpu().numpy().astype(np.int32)
            keep = valid & (z != 0)
            if not keep.any():
                # e.g. integer komi (all draws) or max_moves too small
                # for any game to reach its sample ply — fail loudly
                # instead of spinning forever
                dry_batches += 1
                if dry_batches >= 20:
                    raise RuntimeError(
                        "20 consecutive game batches produced no valid "
                        "value samples; check komi (draws are dropped) "
                        "and max_moves (games must reach ply U+1)")
                continue
            dry_batches = 0
            buf_s.append(planes[keep])
            buf_z.append(z[keep])
            total += int(keep.sum())
            if sum(len(b) for b in buf_s) >= shard_size:
                flush()
        flush()

        manifest = {
            "board_size": self.cfg.size,
            "komi": self.cfg.komi,
            "planes": self.pre.output_dim,
            "feature_list": list(self.pre.feature_list),
            "targets": "outcome",
            "shard_counts": shard_counts,
            "num_positions": total,
        }
        with open(f"{out_prefix}-manifest.json", "w") as f:
            json.dump(manifest, f, indent=2)
        return manifest


def run_generator(argv=None) -> dict:
    """CLI: generate the value-training corpus from saved model specs."""
    ap = argparse.ArgumentParser(
        description="Self-play value dataset generator (one "
                    "de-correlated position per game)")
    ap.add_argument("sl_model_json")
    ap.add_argument("rl_model_json")
    ap.add_argument("out_prefix")
    ap.add_argument("--n-positions", type=int, required=True)
    ap.add_argument("--value-features", nargs="*", default=None,
                    help="feature names for the recorded planes "
                         "(default: the SL net's feature list + the "
                         "'color' plane — the 49-plane value input)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--max-moves", type=int, default=500)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=0,
                    help="plies per segment (0 = one run of max_moves "
                         "plies), with an early exit once every game "
                         "in the batch has ended")
    ap.add_argument("--komi", type=float, default=None,
                    help="area-scoring komi (default: the board "
                         "size's standard; engine.torchgo.default_komi)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    sl = NeuralNetBase.load_model(a.sl_model_json, device=dev)
    rl = NeuralNetBase.load_model(a.rl_model_json, device=dev)
    if a.value_features:
        features = tuple(a.value_features)
    elif "color" in sl.feature_list:
        features = sl.feature_list
    else:
        features = sl.feature_list + ("color",)
    gen = ValueDataGenerator(sl, rl, features, batch=a.batch,
                             max_moves=a.max_moves,
                             temperature=a.temperature, chunk=a.chunk,
                             komi=a.komi)
    manifest = gen.generate(a.n_positions, a.out_prefix, seed=a.seed)
    print(json.dumps({k: manifest[k] for k in
                      ("num_positions", "planes", "board_size")}))
    return manifest


if __name__ == "__main__":
    run_generator(sys.argv[1:])
