"""AlphaZero-style training over the device search, on one card.

The port of ``training/zero.py``: self-play games in which every move
comes from the batched device search (:func:`~..search.device_mcts.
make_mcts_selfplay`), then one update that trains the policy towards
the search's visit distributions and the value net towards the
outcomes:

    loss = CE(policy(s_t), π_t) + MSE(value(s_t), z_t)

with π_t the root visit distribution of ply t (π′ under Gumbel, the
pruned target under forced playouts) and z_t the final outcome from
ply t's player to move.

An iteration (:class:`ZeroIteration`) is ``learn(play(...))``:

* **play** -- search self-play (the chase kernel in every simulation's
  encode, the tree kernel in every simulation, the labels kernel in
  the terminal values), the winners scored on the card, and with the
  auxiliary heads on, the terminal ownership and score labels
  (:func:`~..ops.labels.terminal_labels`). The result is a
  :class:`~..data.replay.ZeroGames` record;
* **learn** -- the recorded actions replayed through the engine in
  segments of ``replay_chunk`` plies; each ply encodes the batch once
  (the policy reads the prefix of the value planes), computes both
  nets' losses and calls ``backward()``, so both gradients accumulate
  in ``.grad``; no graph outlives its ply and no ``[T, B, ...]`` planes
  are kept. The nets are frozen for the whole replay; then one
  ``torch.optim.SGD`` step per net (``optax.sgd``).

Policy targets: the policy head covers the N board points, while the
search's distribution includes pass, so a ply's target is the board
slice renormalised, and plies whose board mass is at most 1e-3 weigh
0. With the playout caps on, only fully searched plies carry policy
weight; the value and auxiliary terms weigh the live plies of games
that *ended* (a move-capped game's area score labels a half-played
board).

The replay makes no device→host sync. Game draws come from the run's
generator chain (:func:`next_keys`): iteration *i*'s games depend only
on the seed and *i*, never on game content or params, which is what
lets a detached actor (``training/actor.py``) walk the chain itself
and reproduce the synchronous loop's games bit for bit. The chain is
a torch generator in place of the reference's JAX key split; it cannot
reproduce JAX's streams, so the parity tests hand the reference's
draws to the port (``tests/test_torch_zero.py``).

The evaluator gate (:class:`ZeroGate`) keeps self-play on the gated
"best" pair: a candidate is promoted only after beating it in a raw
policy match by the threshold and with a Wilson lower bound ≥ 0.5.
Promoted pairs are the reference's ``pool/best.NNNNN.{policy,
value}.msgpack`` files, so either package reads the other's pool.

Instrumentation (the reference's names, in ``metrics.jsonl``): the
spans ``zero.iteration`` with ``zero.selfplay``, ``zero.replay`` and
``zero.update`` (host dispatch time: the card's remainder lands in
``zero.iteration``, closed after the metrics read), ``zero.gate``,
``zero.export`` and ``zero.save``; the fault barriers
``zero.pre_iteration``, ``zero.post_iteration``, ``zero.post_gate``,
``zero.post_export``, ``zero.pre_save``, ``zero.post_save`` and
``zero.promote`` (before each file of a promoted pair); the replay's
pipeline as runner ``zero.replay``, the ``aux_loss{head=}`` gauges, and
the registry's snapshot at the end. ``--profile-dir DIR`` wraps the run
in a ``torch.profiler`` capture and writes its Chrome trace into DIR.

Single card only: ``--num-devices`` is ``None`` or 1.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import glob
import hashlib
import json
import os
import re
import sys
import time

import numpy as np
import torch

from rocalphago_tpu_torch.data.replay import ZeroGames
from rocalphago_tpu_torch.device import resolve_device
from rocalphago_tpu_torch.engine.torchgo import (
    GoConfig,
    default_komi,
    group_data,
    new_states,
    step,
    winner,
)
from rocalphago_tpu_torch.features.planes import encode
from rocalphago_tpu_torch.features.pyfeatures import (
    LADDER_FEATURES,
    output_planes,
)
from rocalphago_tpu_torch.obs import registry as obs_registry
from rocalphago_tpu_torch.obs import trace
from rocalphago_tpu_torch.ops.labels import terminal_labels
from rocalphago_tpu_torch.runtime import faults
from rocalphago_tpu_torch.runtime.pipeline import ChunkPipeline
from rocalphago_tpu_torch.search.device_mcts import make_mcts_selfplay
from rocalphago_tpu_torch.search.selfplay import (
    make_selfplay_chunked,
    sensible_mask,
)

#: the eight metrics of an update, in the reference's order
METRICS = ("policy_loss", "value_loss", "value_mse", "value_acc",
           "black_win_rate", "draw_rate", "mean_moves", "finished_rate")
AUX_METRICS = ("aux_loss_ownership", "aux_loss_score")


# ----------------------------------------------------------- the chain


def next_keys(rng: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Step the run's generator chain one iteration: ``rng`` (a CPU
    ``torch.Generator`` state) → ``(next state, game seed)``. The game
    seed depends only on the chain's start and the number of steps."""
    g = torch.Generator()
    g.set_state(rng)
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=g))
    return g.get_state(), seed


def fold_in(rng: torch.Tensor, *data: int) -> torch.Tensor:
    """A generator state derived from ``rng`` and the integers
    ``data`` (a free-running actor's own branch of the chain)."""
    digest = int.from_bytes(
        hashlib.sha256(rng.numpy().tobytes()).digest()[:8], "big")
    return torch.Generator().manual_seed(_seed_of(digest, *data)).get_state()


def _seed_of(*data: int) -> int:
    """A 63-bit seed from non-negative integers."""
    words = np.random.SeedSequence(
        [int(d) & 0xFFFFFFFFFFFFFFFF for d in data]).generate_state(
            2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def game_generators(game_seed: int, device):
    """The draws of one iteration's games: ``(torch.Generator on
    device, numpy Generator for the Dirichlet gamma draws)``, both
    seeded from ``game_seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(game_seed)
    return gen, np.random.default_rng(game_seed)


def match_generator(seed: int, iteration: int, which: int,
                    device) -> torch.Generator:
    """The draws of a gate (``which`` 0) or ladder (1) match after
    iteration ``iteration``: stateless in (seed, iteration), so a
    resumed run plays the same matches."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed_of(seed ^ 0x9A7E, iteration, which))
    return gen


# ----------------------------------------------------------- the state


class ZeroState:
    """What a checkpoint holds: both nets, both optimizers, the
    iterations taken and the generator chain's state."""

    def __init__(self, policy: torch.nn.Module, value: torch.nn.Module,
                 opt_policy: torch.optim.Optimizer,
                 opt_value: torch.optim.Optimizer, rng: torch.Tensor,
                 iteration: int = 0):
        self.policy = policy
        self.value = value
        self.opt_policy = opt_policy
        self.opt_value = opt_value
        self.rng = rng
        self.iteration = iteration

    def state_dict(self) -> dict:
        return {"policy": self.policy.state_dict(),
                "value": self.value.state_dict(),
                "opt_policy": self.opt_policy.state_dict(),
                "opt_value": self.opt_value.state_dict(),
                "iteration": self.iteration, "rng": self.rng.clone()}

    def load_state_dict(self, sd: dict) -> None:
        self.policy.load_state_dict(sd["policy"])
        self.value.load_state_dict(sd["value"])
        self.opt_policy.load_state_dict(sd["opt_policy"])
        self.opt_value.load_state_dict(sd["opt_value"])
        self.iteration = int(sd["iteration"])
        self.rng = sd["rng"].clone()


def init_zero_state(policy: torch.nn.Module, value: torch.nn.Module,
                    learning_rate: float = 0.001,
                    seed: int = 0) -> ZeroState:
    """A fresh state over the two modules: plain SGD for each, the
    chain seeded from ``seed``."""
    return ZeroState(policy, value,
                     torch.optim.SGD(policy.parameters(), lr=learning_rate),
                     torch.optim.SGD(value.parameters(), lr=learning_rate),
                     torch.Generator().manual_seed(seed).get_state())


def snapshot(module: torch.nn.Module) -> torch.nn.Module:
    """A frozen copy of ``module`` (a published or promoted pair: the
    learner updates the original in place)."""
    return copy.deepcopy(module).requires_grad_(False)


# ------------------------------------------------------- the iteration


class ZeroIteration:
    """``(ZeroState) -> (ZeroState, metrics)``: one iteration, updating
    the state in place; :meth:`play` and :meth:`learn` are its halves
    (the actor's and the learner's). ``metrics`` are float32 scalars on
    the device.

    Self-play economics (KataGo; all off by default, and off is the
    plain runner bit for bit): ``cap_p``/``cap_cheap``/``cap_per_row``
    and ``forced_k`` pass to :func:`make_mcts_selfplay`; with the caps
    live, only fully searched plies carry policy weight.
    ``aux_weight > 0`` adds the auxiliary ownership and score
    regressions, weighted into the value net's loss; the value net needs
    ``aux_heads=("ownership", "score")``.

    A call is safe to repeat after a failure: the gradients are zeroed
    at the start of a replay, and the state changes only at its end."""

    def __init__(self, cfg: GoConfig, policy_features: tuple,
                 value_features: tuple, batch: int, move_limit: int,
                 n_sim: int, max_nodes: int | None = None,
                 temperature: float = 1.0, sim_chunk: int = 8,
                 replay_chunk: int = 10, gumbel: bool = False,
                 m_root: int = 16, gumbel_sample: bool = False,
                 dirichlet_alpha: float = 0.0, noise_frac: float = 0.25,
                 cap_p: float = 0.0, cap_cheap: int | None = None,
                 cap_per_row: bool = False, forced_k: float = 0.0,
                 aux_weight: float = 0.0, device=None):
        if replay_chunk < 1:
            raise ValueError(f"replay_chunk must be >= 1, got "
                             f"{replay_chunk}")
        self.cfg = cfg
        self.policy_features = tuple(policy_features)
        self.value_features = tuple(value_features)
        self.batch = batch
        self.move_limit = move_limit
        self.n_sim = n_sim
        self.replay_chunk = replay_chunk
        self.device = resolve_device(device)
        if cap_cheap is None:
            cap_cheap = max(1, n_sim // 4)
        self.cheap = max(1, min(int(cap_cheap), n_sim))
        self.econ = cap_p > 0 and self.cheap < n_sim
        self.aux_weight = float(aux_weight)
        self.aux = self.aux_weight > 0
        self.dirichlet_alpha = dirichlet_alpha
        self._selfplay_kw = dict(
            batch=batch, max_moves=move_limit, n_sim=n_sim,
            max_nodes=max_nodes, temperature=temperature,
            sim_chunk=sim_chunk, record_visits=True, gumbel=gumbel,
            m_root=m_root, gumbel_sample=gumbel_sample,
            dirichlet_alpha=dirichlet_alpha, noise_frac=noise_frac,
            forced_k=forced_k, cap_p=cap_p, cap_cheap=self.cheap,
            cap_per_row=cap_per_row, device=self.device)
        self.n_policy_planes = output_planes(self.policy_features)
        self.last_selfplay = None

    # ------------------------------------------------------ the actor

    def selfplay(self, policy, value):
        """The search self-play runner over these nets."""
        return make_mcts_selfplay(self.cfg, self.policy_features,
                                  self.value_features, policy, value,
                                  **self._selfplay_kw)

    @torch.no_grad()
    def play(self, policy, value, game_seed: int) -> ZeroGames:
        """The actor's half: search self-play only, no optimizer and no
        gradient. Any pair of nets can play (the gated best pair, a
        published snapshot). Returns the record on the device."""
        run = self.selfplay(policy, value)
        self.last_selfplay = run
        generator, noise_rng = game_generators(game_seed, self.device)
        with trace.span("zero.selfplay", plies=self.move_limit):
            out = run(generator, noise_rng)
            full = None
            if self.econ:
                final, actions, live, visits, full = out
            else:
                final, actions, live, visits = out
            ownership = score = None
            if self.aux:
                # labels of every final position; the loss masks them
                # to finished games
                ownership, score = terminal_labels(self.cfg, final)
            winners = winner(self.cfg, final)
        return ZeroGames(actions, live, visits, winners, final.done, full,
                         ownership, score)

    # ---------------------------------------------------- the learner

    def replay_ply(self, state: ZeroState, states, winners, finished,
                   aux_labels, actions_t, live_t, visits_t, full_t):
        """One replay ply: both nets' losses on the ply's encode,
        back-propagated into ``.grad``; returns ``(stepped states,
        stats f32 [5] or [7])``."""
        cfg, n, batch = self.cfg, self.cfg.num_points, self.batch
        with torch.no_grad():
            gd = group_data(cfg, states.board, with_zxor=cfg.enforce_superko,
                            labels=states.labels)
            planes = encode(cfg, states, self.value_features, gd=gd)
            sens = sensible_mask(cfg, states, gd)
            board_counts = visits_t[:, :n].float()
            mass = board_counts.sum(dim=-1)
            pi = board_counts / torch.clamp(mass, min=1e-6)[:, None]
            wf = live_t * (mass > 1e-3)
            if full_t is not None:
                wf = wf * full_t
            # the outcome from the player to move's view
            z = (winners * states.turn).float()
            turn_f = states.turn.float()
            livef = live_t * finished
            decided = livef * (z != 0)
        logits = state.policy(planes[..., :self.n_policy_planes])
        neg = torch.finfo(logits.dtype).min
        logp = torch.log_softmax(torch.where(sens, logits, neg), dim=-1)
        ce = -(pi * logp).sum(dim=-1)
        if aux_labels is None:
            v = state.value(planes)
        else:
            v, aux_out = state.value(planes, with_aux=True)
        mse = (v - z) ** 2
        lp = (wf * ce).sum() / batch
        lv = (livef * mse).sum() / batch
        total = lp + lv
        parts = [lp, lv]
        if aux_labels is not None:
            own_l, score_l = aux_labels
            own_t = own_l.float() * turn_f[:, None]
            l_own = (livef * ((aux_out["ownership"] - own_t) ** 2).mean(
                dim=-1)).sum() / batch
            sc_t = score_l * turn_f
            l_sc = (livef * (aux_out["score"] - sc_t) ** 2).sum() / batch
            total = total + self.aux_weight * (l_own + l_sc)
        total.backward()
        with torch.no_grad():
            correct = (decided * ((v > 0) == (z > 0))).sum()
            parts += [correct, decided.sum(), livef.sum()]
            if aux_labels is not None:
                parts += [l_own, l_sc]
            stats = torch.stack([p.detach() for p in parts])
            return step(cfg, states, actions_t, gd), stats

    def _record(self, games: ZeroGames):
        """The record's tensors on the device, cast as the loss wants."""
        dev = self.device

        def t(x):
            return torch.as_tensor(x).to(dev)

        actions, live, visits = t(games.actions), t(games.live), \
            t(games.visits)
        winners = t(games.winners)
        full_f = None
        if self.econ:
            # a record without the mask (schema v1, caps off) was
            # searched in full on every ply
            full_f = (torch.ones_like(live, dtype=torch.float32)
                      if games.full is None else t(games.full).float())
        aux_labels = None
        if self.aux:
            if games.ownership is None or games.score is None:
                raise ValueError(
                    "aux_weight > 0 but the game record carries no "
                    "ownership/score labels: the actor must play with "
                    "the aux labels on (schema v2)")
            aux_labels = (t(games.ownership), t(games.score))
        return (actions, live.float(), visits, winners,
                t(games.finished).float(), full_f, aux_labels,
                live.sum(dim=0, dtype=torch.int32))

    def learn(self, state: ZeroState, games: ZeroGames):
        """The learner's half: the replay's gradient and one SGD step
        per net from a recorded batch (on the device or host numpy:
        the record keeps the recorder's dtypes, so the round trip is
        exact). Steps the state's chain as :meth:`__call__` does, so
        ``learn(state, play(..., next_keys(state.rng)[1]))`` is
        ``iteration(state)`` bit for bit. Returns ``(state,
        metrics)``."""
        (actions, live_f, visits, winners, finished, full_f, aux_labels,
         num_moves) = self._record(games)
        wf = winners.float()
        states = new_states(self.cfg, self.batch, device=self.device)
        state.opt_policy.zero_grad(set_to_none=True)
        state.opt_value.zero_grad(set_to_none=True)
        stats = torch.zeros((7 if self.aux else 5,), dtype=torch.float32,
                            device=self.device)
        plies = actions.shape[0]
        pipe = ChunkPipeline(self.device, runner="zero.replay")
        with trace.span("zero.replay", plies=plies), torch.enable_grad():
            for offset in range(0, plies, self.replay_chunk):
                for t in range(offset, min(offset + self.replay_chunk,
                                           plies)):
                    states, st = self.replay_ply(
                        state, states, wf, finished, aux_labels, actions[t],
                        live_f[t], visits[t],
                        None if full_f is None else full_f[t])
                    stats = stats + st
                pipe.push()
            pipe.finish()
        with trace.span("zero.update"):
            return self.apply_updates(state, stats, winners, finished,
                                      num_moves)

    def apply_updates(self, state: ZeroState, stats, winners, finished,
                      num_moves):
        """One SGD step per net, the metrics, and the chain stepped."""
        state.opt_policy.step()
        state.opt_value.step()
        metrics = {
            "policy_loss": stats[0],
            "value_loss": stats[1],
            # the MSE per live ply of a finished game, and the sign
            # accuracy over the decided ones (0.5 = uninformative)
            "value_mse": stats[1] * self.batch / torch.clamp(stats[4],
                                                             min=1.0),
            "value_acc": stats[2] / torch.clamp(stats[3], min=1.0),
            "black_win_rate": (winners > 0).float().mean(),
            "draw_rate": (winners == 0).float().mean(),
            "mean_moves": num_moves.float().mean(),
            "finished_rate": finished.mean(),
        }
        if self.aux:
            metrics["aux_loss_ownership"] = stats[5]
            metrics["aux_loss_score"] = stats[6]
        state.iteration += 1
        state.rng = next_keys(state.rng)[0]
        return state, metrics

    def __call__(self, state: ZeroState, sp_policy=None, sp_value=None):
        """One iteration. ``sp_policy``/``sp_value`` override which nets
        play (the gated best pair); the gradients always update the
        state's nets."""
        _, game_seed = next_keys(state.rng)
        games = self.play(state.policy if sp_policy is None else sp_policy,
                          state.value if sp_value is None else sp_value,
                          game_seed)
        return self.learn(state, games)


def metrics_to_host(m: dict) -> dict:
    """The metrics as Python floats, with one read of the card."""
    keys = list(m)
    vals = torch.stack([m[k].float() for k in keys]).tolist() if keys else []
    return dict(zip(keys, vals))


# ------------------------------------------------------------ the gate


class ZeroGate:
    """The evaluator gate and its pool of promoted best pairs.

    Self-play data comes from the gated best pair; a training candidate
    is promoted after beating it in an N-game raw-policy match
    (:meth:`match`: no search, colours split) by ``threshold`` and with
    a Wilson 95% lower bound ≥ 0.5 on its decided-game win rate
    (:meth:`decide`). Promoted pairs are written to ``pool_dir`` as the
    reference's ``best.NNNNN.{policy,value}.msgpack`` (Flax msgpack),
    policy first and each file atomically, then the ``rollout.json``
    pointer, so a resumed run keeps its incumbent and either package
    reads the other's pool."""

    def __init__(self, cfg: GoConfig, features: tuple, pool_dir: str,
                 games: int, threshold: float, temperature: float,
                 move_limit: int, chunk: int = 20, write: bool = True,
                 device=None):
        if games % 2:
            raise ValueError(f"gate games must be even, got {games}")
        self.cfg = cfg
        self.features = tuple(features)
        self.pool_dir = pool_dir
        self.games = games
        self.threshold = threshold
        self.temperature = temperature
        self.move_limit = move_limit
        self.chunk = chunk
        self.write = write
        self.device = resolve_device(device)

    def match(self, policy_a, policy_b, generator: torch.Generator) -> dict:
        """N games of A against B (A is Black in the first half); A's
        win rate over decided games and the tally."""
        run = make_selfplay_chunked(
            self.cfg, self.features, policy_a, policy_b, self.games,
            max_moves=self.move_limit, chunk=self.chunk,
            temperature=self.temperature, device=self.device)
        w = run(generator, stop_when_done=True).winners.cpu().numpy()
        half = self.games // 2
        wins_a = int((w[:half] > 0).sum() + (w[half:] < 0).sum())
        draws = int((w == 0).sum())
        decided = self.games - draws
        return {"wins_a": wins_a, "wins_b": decided - wins_a,
                "draws": draws, "win_rate_a": wins_a / max(decided, 1)}

    def decide(self, result: dict) -> tuple:
        """``(promoted, wilson_lb)``: the candidate needs the threshold
        and a Wilson 95% lower bound ≥ 0.5 on its decided games."""
        from rocalphago_tpu_torch.interface.elo import wilson_lower_bound

        decided = result["wins_a"] + result["wins_b"]
        lb = wilson_lower_bound(result["wins_a"], decided)
        return (result["win_rate_a"] >= self.threshold and lb >= 0.5), lb

    def _paths(self, iteration: int) -> tuple:
        return tuple(os.path.join(
            self.pool_dir, f"best.{iteration:05d}.{kind}.msgpack")
            for kind in ("policy", "value"))

    def snapshots(self) -> list:
        """Sorted ``(iteration, policy_path, value_path)`` triples; a
        policy file without its value sibling is left out."""
        out = []
        for p in sorted(glob.glob(os.path.join(self.pool_dir,
                                               "best.*.policy.msgpack"))):
            m = re.search(r"best\.(\d+)\.policy\.msgpack$", p)
            v = p.replace(".policy.", ".value.")
            if m and os.path.exists(v):
                out.append((int(m.group(1)), p, v))
        return out

    def promote(self, policy, value, iteration: int) -> None:
        """Write the pair as snapshot ``iteration``, then the spill
        pointer."""
        if not self.write:
            return
        from rocalphago_tpu_torch.models.weights import (
            params_to_flax,
            write_flax_msgpack,
        )
        from rocalphago_tpu_torch.runtime import retries
        from rocalphago_tpu_torch.training.actor import write_spill

        paths = self._paths(iteration)
        os.makedirs(self.pool_dir, exist_ok=True)

        # policy before value, each file atomic: a crash between them
        # leaves a policy file that snapshots() does not list
        @retries.retry(max_attempts=3, base_delay=0.2)
        def write_pair():
            for path, module in zip(paths, (policy, value)):
                faults.barrier("zero.promote", iteration)
                write_flax_msgpack(path, params_to_flax(module.state_dict()))

        write_pair()
        write_spill(self.pool_dir, version=iteration, policy_path=paths[0],
                    value_path=paths[1])

    def load(self, entry, policy_template, value_template) -> tuple:
        """The snapshot ``entry`` (a :meth:`snapshots` triple) as frozen
        copies of the template modules."""
        from rocalphago_tpu_torch.models.weights import (
            params_from_flax,
            read_flax_msgpack,
        )

        _, ppath, vpath = entry
        out = []
        for path, template in ((ppath, policy_template),
                               (vpath, value_template)):
            module = snapshot(template)
            module.load_state_dict(params_from_flax(read_flax_msgpack(path)))
            out.append(module)
        return tuple(out)

    def sample(self, seed: int, iteration: int):
        """A uniform draw over the pool but its latest entry (the
        incumbent), stateless in (seed, iteration): the ladder probe's
        past best; None until the pool has one."""
        snaps = self.snapshots()[:-1]
        if not snaps:
            return None
        rng = np.random.default_rng(np.random.SeedSequence([seed,
                                                            iteration]))
        return snaps[rng.integers(len(snaps))]


# ------------------------------------------------------------- the CLI


def _to_cpu(obj):
    """A deep copy of a state dict with every tensor on the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return copy.deepcopy(obj)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="AlphaZero-style training: device-search self-play "
                    "with visit-distribution policy targets")
    ap.add_argument("policy_json")
    ap.add_argument("value_json")
    ap.add_argument("out_dir")
    ap.add_argument("--learning-rate", type=float, default=0.001)
    ap.add_argument("--game-batch", type=int, default=8)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--save-every", type=int, default=5)
    ap.add_argument("--move-limit", type=int, default=500)
    ap.add_argument("--sims", type=int, default=64)
    ap.add_argument("--max-nodes", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--sim-chunk", type=int, default=8)
    ap.add_argument("--replay-chunk", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gumbel", action="store_true",
                    help="Gumbel root search self-play with improved-"
                         "policy (π') targets; plays each ply's halving "
                         "winner (--temperature does not apply)")
    ap.add_argument("--m-root", type=int, default=16,
                    help="Gumbel root candidates")
    ap.add_argument("--gumbel-sample-moves", action="store_true",
                    help="with --gumbel: sample each move from π' "
                         "(temperature applies) instead of playing the "
                         "halving winner")
    ap.add_argument("--dirichlet-alpha", type=float, default=0.0,
                    help="root-noise Dir(α) for PUCT self-play (0 = off;"
                         " incompatible with --gumbel)")
    ap.add_argument("--noise-frac", type=float, default=0.25,
                    help="root-noise mix fraction ε")
    ap.add_argument("--cap-p", type=float, default=0.0,
                    help="playout-cap randomisation: probability a ply "
                         "gets the full --sims search (only full plies "
                         "carry policy targets; 0 = off)")
    ap.add_argument("--cap-cheap", type=int, default=None,
                    help="cheap-search cap (default --sims // 4)")
    ap.add_argument("--cap-per-row", action="store_true",
                    help="draw the cap per game instead of per ply batch")
    ap.add_argument("--forced-k", type=float, default=0.0,
                    help="forced playouts at the PUCT root, their visits "
                         "pruned from the targets (0 = off; not with "
                         "--gumbel)")
    ap.add_argument("--aux-weight", type=float, default=0.0,
                    help="weight of the auxiliary ownership/score losses "
                         "(the value net needs aux_heads; 0 = off)")
    ap.add_argument("--num-devices", type=int, default=None,
                    help="cards to train on: one (multi-card training "
                         "is not ported)")
    ap.add_argument("--komi", type=float, default=None,
                    help="area-scoring komi (default: the board size's "
                         "standard; engine.torchgo.default_komi)")
    ap.add_argument("--no-gating", action="store_true",
                    help="train without the evaluator gate")
    ap.add_argument("--gate-every", type=int, default=0,
                    help="iterations between gate matches (0 = "
                         "--save-every)")
    ap.add_argument("--gate-games", type=int, default=64,
                    help="games per gate match (raw policy, colours "
                         "split)")
    ap.add_argument("--gate-threshold", type=float, default=0.55,
                    help="decided-game win rate a candidate needs to be "
                         "promoted (and a Wilson 95%% lower bound >= 0.5)")
    ap.add_argument("--gate-temperature", type=float, default=1.0,
                    help="sampling temperature of gate and ladder matches")
    ap.add_argument("--actor-learner", action="store_true",
                    help="self-play in actor threads feeding a bounded "
                         "replay buffer, the learner consuming it; with "
                         "--actors 1 the run is bit-identical to the "
                         "synchronous loop")
    ap.add_argument("--actors", type=int, default=1,
                    help="self-play actor threads (--actor-learner)")
    ap.add_argument("--replay-capacity", type=int, default=None,
                    help="replay buffer capacity in game batches "
                         "(default 8)")
    ap.add_argument("--replay-sample", action="store_true",
                    help="the learner draws prioritised-recency samples "
                         "instead of FIFO batches (not bit-exact; actors "
                         "evict instead of pacing)")
    ap.add_argument("--iteration-deadline", type=float, default=0.0,
                    help="watchdog: seconds one iteration may take before "
                         "a 'stall' event is logged and the run aborts "
                         "with the last completed checkpoint (0 = off)")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of the run (host "
                         "ops, and the card's kernels on CUDA) into this "
                         "directory as a Chrome trace (default off)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


#: the Chrome trace ``--profile-dir`` writes
PROFILE_TRACE = "zero.trace.json"


def start_profile(out_dir: str, device: torch.device):
    """Start the ``--profile-dir`` capture (host operations, and the
    card's kernels when ``device`` is CUDA); emits the reference's
    ``profiler`` start event. Returns the running profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    trace.emit("profiler", action="start", out_dir=out_dir)
    print(f"zero: profiler capture -> {out_dir}", file=sys.stderr)
    return prof


def stop_profile(prof, out_dir: str) -> str:
    """Stop the capture, write its Chrome trace into ``out_dir`` and emit
    the ``profiler`` stop event; returns the trace's path."""
    prof.stop()
    path = os.path.join(out_dir, PROFILE_TRACE)
    prof.export_chrome_trace(path)
    trace.emit("profiler", action="stop", out_dir=out_dir)
    return path


def run_training(argv=None) -> dict:
    """CLI: ``python -m rocalphago_tpu_torch.training.zero policy.json
    value.json out_dir [...]`` -- the reference's flags and artifacts:
    checkpoints with exact resume, ``metrics.jsonl`` and
    ``metadata.json``, exports ``{policy,value}.json`` with
    ``{policy,value}.NNNNN.flax.msgpack`` (loadable by either package's
    GTP), the gate's pool in ``out_dir/pool``."""
    from rocalphago_tpu_torch.io.checkpoint import (
        MetadataWriter,
        TrainCheckpointer,
    )
    from rocalphago_tpu_torch.io.metrics import MetricsLogger
    from rocalphago_tpu_torch.models.nn_util import NeuralNetBase
    from rocalphago_tpu_torch.runtime import retries
    from rocalphago_tpu_torch.runtime.watchdog import Watchdog

    a = _parser().parse_args(argv)
    if a.gumbel and a.dirichlet_alpha > 0:
        raise SystemExit("--dirichlet-alpha is PUCT-mode root noise; "
                         "--gumbel explores via the gumbel draw")
    if a.gumbel_sample_moves and not a.gumbel:
        raise SystemExit("--gumbel-sample-moves requires --gumbel")
    if a.gumbel and a.forced_k:
        raise SystemExit("--forced-k is a PUCT-root knob; gumbel search "
                         "visits candidates by schedule")
    if a.num_devices not in (None, 1):
        raise SystemExit(f"--num-devices {a.num_devices}: this trainer "
                         "runs on one card (multi-card training is not "
                         "ported)")
    if a.gumbel and a.temperature != 1.0 and not a.gumbel_sample_moves:
        print("zero: --temperature is ignored with --gumbel (the per-ply "
              "gumbel draw is the exploration; with --gumbel-sample-moves "
              "it applies to the pi' draw)", file=sys.stderr)
    dev = resolve_device(a.device)
    policy = NeuralNetBase.load_model(a.policy_json, device=dev)
    value = NeuralNetBase.load_model(a.value_json, device=dev)
    if policy.board != value.board:
        raise SystemExit(
            f"policy is {policy.board}x{policy.board} but value is "
            f"{value.board}x{value.board}: the nets must share a board "
            "size")
    ladder_free = not any(f in LADDER_FEATURES for f in
                          policy.feature_list + value.feature_list)
    game_cfg = dataclasses.replace(
        policy.cfg, komi=a.komi if a.komi is not None
        else default_komi(policy.board))
    a.komi = game_cfg.komi      # metadata records the resolved value
    if dev.type == "cuda":
        # exact resume and the actor/learner A/B need the same bits from
        # every backward (process-wide settings)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    if a.aux_weight > 0 and not getattr(value.module, "aux_heads", ()):
        raise SystemExit(
            "--aux-weight needs a value net built with aux_heads="
            "('ownership', 'score'): rebuild the value spec or graft the "
            "heads on with models.value.with_aux_heads")

    iteration = ZeroIteration(
        game_cfg, policy.feature_list, value.feature_list,
        batch=a.game_batch, move_limit=a.move_limit, n_sim=a.sims,
        max_nodes=a.max_nodes or None, temperature=a.temperature,
        sim_chunk=a.sim_chunk, replay_chunk=a.replay_chunk,
        gumbel=a.gumbel, m_root=a.m_root,
        gumbel_sample=a.gumbel_sample_moves,
        dirichlet_alpha=a.dirichlet_alpha, noise_frac=a.noise_frac,
        cap_p=a.cap_p, cap_cheap=a.cap_cheap, cap_per_row=a.cap_per_row,
        forced_k=a.forced_k, aux_weight=a.aux_weight, device=dev)
    state = init_zero_state(policy.module, value.module, a.learning_rate,
                            seed=a.seed)

    os.makedirs(a.out_dir, exist_ok=True)
    ckpt = TrainCheckpointer(os.path.join(a.out_dir, "checkpoints"))
    metrics = MetricsLogger(os.path.join(a.out_dir, "metrics.jsonl"))
    # spans share the metrics stream; the opt-in capture brackets the run
    trace.configure(metrics)
    profiler = (start_profile(a.profile_dir, dev) if a.profile_dir
                else None)
    meta = MetadataWriter(
        os.path.join(a.out_dir, "metadata.json"),
        header={"cmd": " ".join(sys.argv), "config": vars(a),
                "ladder_free": ladder_free})
    start = 0
    restored, _ = ckpt.restore()
    if restored is not None:
        state.load_state_dict(restored)
        start = state.iteration
        metrics.log("resume", iteration=start)
    final = {}

    # the evaluator gate: self-play data comes from the gated best pair
    gate = None
    best_p = best_v = None
    gate_every = a.gate_every or a.save_every
    if not a.no_gating:
        gate = ZeroGate(game_cfg, policy.feature_list,
                        os.path.join(a.out_dir, "pool"), games=a.gate_games,
                        threshold=a.gate_threshold,
                        temperature=a.gate_temperature,
                        move_limit=a.move_limit, device=dev)
        # only snapshots at or before the restored checkpoint count: a
        # crash between a promotion and its save leaves a "future" entry,
        # which the re-run iteration rewrites with identical bytes
        snaps = [s for s in gate.snapshots() if s[0] <= start]
        if restored is not None and snaps:
            best_p, best_v = gate.load(snaps[-1], state.policy, state.value)
            metrics.log("gate_resume", incumbent=snaps[-1][0])
        else:
            best_p, best_v = snapshot(state.policy), snapshot(state.value)
            if not snaps:
                gate.promote(best_p, best_v, start)

    def export(it):
        for net, name in ((policy, "policy"), (value, "value")):
            net.save_model(os.path.join(a.out_dir, f"{name}.json"),
                           os.path.join(a.out_dir,
                                        f"{name}.{it:05d}.flax.msgpack"))

    # a transient failure re-runs the whole iteration: it changes the
    # state only at its end (ZeroIteration)
    run_iteration = retries.retry(max_attempts=3, base_delay=1.0,
                                  logger=metrics)(iteration)

    # the watchdog: a wedged iteration logs a stall and the run aborts
    # with the last completed iteration checkpointed
    last_done = {"state": None, "step": -1}

    def _stall_abort():
        st = last_done["state"]
        if st is not None and last_done["step"] != ckpt.latest_step():
            ckpt.save(last_done["step"], st)

    watchdog = None
    if a.iteration_deadline > 0:
        watchdog = Watchdog(a.iteration_deadline, metrics=metrics,
                            abort_fn=_stall_abort, name="zero").start()

    rig = sup = publisher = gang = None
    lockstep = False
    if a.actor_learner:
        from rocalphago_tpu_torch.data.replay import ReplayBuffer
        from rocalphago_tpu_torch.runtime import supervisor as superv
        from rocalphago_tpu_torch.training.actor import (
            DispatchGang,
            ParamsPublisher,
            SelfplayActor,
        )
        from rocalphago_tpu_torch.training.learner import ZeroLearner

        lockstep = a.actors == 1 and not a.replay_sample
        buffer = ReplayBuffer(capacity=a.replay_capacity,
                              spill_dir=os.path.join(a.out_dir, "replay"))
        # a drained or killed predecessor's spill: the lockstep actor
        # replays its games from the checkpointed chain, so leftovers
        # would be inserted twice -- discard; free-run restores them
        n_spill = buffer.discard_spill() if lockstep else buffer.restore()
        if n_spill:
            metrics.log("replay_spill_discarded" if lockstep
                        else "replay_restored", entries=n_spill)
        publisher = ParamsPublisher()
        # one gang for every device section of both threads
        gang = DispatchGang()
        sup = superv.Supervisor(metrics=metrics)
        base_rng = state.rng.clone()

        def _actor_factory(i):
            def make(attempt, beat):
                # free-run restarts branch a fresh chain per attempt (the
                # game in flight is dropped); lockstep never restarts
                rng = base_rng if lockstep else fold_in(base_rng, i + 1,
                                                        attempt)
                return SelfplayActor(
                    iteration.play, publisher, buffer, rng, name=f"a{i}",
                    lockstep=lockstep, start_index=start,
                    games=(a.iterations - start) if lockstep else None,
                    pace=not a.replay_sample, gang=gang, metrics=metrics,
                    on_progress=beat)
            return make

        for i in range(a.actors):
            sup.add(_actor_factory(i), name=f"actor:{i}",
                    restartable=not lockstep)
        learner = ZeroLearner(iteration.learn, buffer, gang=gang,
                              sample=a.replay_sample, metrics=metrics)
        publisher.publish(best_p if best_p is not None
                          else snapshot(state.policy),
                          best_v if best_v is not None
                          else snapshot(state.value), version=start)
        # SIGTERM (the preemption notice) drains at the next iteration
        # boundary with a committed checkpoint
        sup.install_sigterm()
        sup.start()
        rig = (buffer, publisher, sup, learner)
        metrics.log("actor_learner", actors=a.actors, lockstep=lockstep,
                    capacity=buffer.capacity, sample=a.replay_sample,
                    supervised=True)

    def section(fn, *args):
        """A device section: under the gang when actors share the card."""
        return gang.run(fn, *args) if gang is not None else fn(*args)

    def _learner_iteration(state, it):
        # finite waits, so a dead fleet surfaces as an error; a learner
        # failure in free run restores the last checkpoint and steps
        # again until iteration it + 1 is learned; lockstep cannot (its
        # FIFO entries are gone once taken)
        fell_back = False
        while True:
            try:
                out = learner.step(state, timeout=5.0)
            except Exception as e:
                if lockstep:
                    raise
                restored2, _ = ckpt.restore()
                if restored2 is not None:
                    state.load_state_dict(restored2)
                metrics.log("learner_failover",
                            error=f"{type(e).__name__}: {e}",
                            restored_step=state.iteration, target=it + 1)
                obs_registry.counter(
                    "supervisor_restarts_total", worker="learner",
                    reason=("transient" if retries.is_transient(e)
                            else "error")).inc()
                fell_back = True
                continue
            if out is None:
                parked = sup.parked()
                if parked:
                    raise RuntimeError(
                        f"self-play worker {parked[0].name} parked; "
                        "learner starved") from parked[0].error
                if buffer.closed:
                    raise RuntimeError("replay buffer closed mid-run")
                continue
            state, m, _ = out
            if not fell_back or state.iteration >= it + 1:
                return state, m

    drained = False
    try:
        for it in range(start, a.iterations):
            if sup is not None and sup.draining:
                metrics.log("drain", phase="loop_exit", iteration=it,
                            reason=sup.drain_reason)
                drained = True
                break
            with trace.span("zero.iteration", iteration=it):
                faults.barrier("zero.pre_iteration", it)
                t0 = time.time()
                if rig is None:
                    state, m = run_iteration(state, best_p, best_v)
                    # the read syncs the iteration's work: the time below
                    # and zero.iteration are its wall time
                    m = metrics_to_host(m)
                else:
                    state, m = _learner_iteration(state, it)
                if watchdog is not None:
                    watchdog.beat()
                    last_done["state"] = _to_cpu(state.state_dict())
                    last_done["step"] = it + 1
                faults.barrier("zero.post_iteration", it)
                if "aux_loss_ownership" in m:
                    # host floats already read above
                    obs_registry.gauge("aux_loss", head="ownership").set(
                        m["aux_loss_ownership"])
                    obs_registry.gauge("aux_loss", head="score").set(
                        m["aux_loss_score"])
                entry = {"iteration": it, **m,
                         "games_per_min": a.game_batch * 60.0
                         / max(time.time() - t0, 1e-9)}
                metrics.log("iteration", **entry)
                meta.record_epoch(entry)
                final = entry
                if gate and ((it + 1) % gate_every == 0
                             or it + 1 == a.iterations):
                    with trace.span("zero.gate", iteration=it):
                        r = section(gate.match, state.policy, best_p,
                                    match_generator(a.seed, it, 0, dev))
                        promoted, wilson_lb = gate.decide(r)
                        if promoted:
                            best_p, best_v = (snapshot(state.policy),
                                              snapshot(state.value))
                            gate.promote(best_p, best_v, it + 1)
                        metrics.log("gate", iteration=it,
                                    promoted=promoted,
                                    wilson_lb=round(wilson_lb, 4), **r)
                        # the ladder probe: the incumbent against a
                        # sampled past best
                        snap = gate.sample(a.seed, it)
                        if snap is not None:
                            lp, _ = gate.load(snap, state.policy,
                                              state.value)
                            lr = section(gate.match, best_p, lp,
                                         match_generator(a.seed, it, 1,
                                                         dev))
                            metrics.log("ladder", iteration=it,
                                        opponent=snap[0], **lr)
                        faults.barrier("zero.post_gate", it)
                if publisher is not None:
                    # version it + 1: the pair the synchronous loop hands
                    # iteration it + 1
                    publisher.publish(
                        best_p if best_p is not None
                        else snapshot(state.policy),
                        best_v if best_v is not None
                        else snapshot(state.value),
                        version=it + 1)
                if (it + 1) % a.save_every == 0 or it + 1 == a.iterations:
                    # exports before the checkpoint save (the commit
                    # point): a resume from the previous checkpoint
                    # rewrites them identically, so a crash anywhere
                    # leaves what the straight run leaves
                    with trace.span("zero.export", iteration=it):
                        section(export, it + 1)
                        faults.barrier("zero.post_export", it)
                    with trace.span("zero.save", iteration=it):
                        faults.barrier("zero.pre_save", it)
                        ckpt.save(it + 1, state.state_dict())
                        faults.barrier("zero.post_save", it)
    finally:
        if rig is not None:
            buffer.close()          # wakes paced or waiting actors
            sup.stop()
            metrics.log(
                "actor_learner_done",
                learner_idle_frac=round(learner.idle_frac, 4),
                learner_steps=learner.steps,
                restarts=sum(h.restarts for h in sup.handles()),
                games_played=sum(h.worker.games_played for h in
                                 sup.handles() if h.worker is not None))
        if profiler is not None:
            stop_profile(profiler, a.profile_dir)
    if drained:
        # commit the drain point (no export: exports happen at save
        # boundaries, which the resumed run reproduces); a drain exits 0
        if state.iteration != ckpt.latest_step():
            ckpt.save(state.iteration, state.state_dict())
        metrics.log("drain", phase="checkpoint", step=state.iteration,
                    reason=sup.drain_reason)
    if watchdog is not None:
        watchdog.stop()
    # the run's counter and histogram state, for obs_report
    obs_registry.log_to(metrics)
    metrics.close()
    print(json.dumps(final))
    return final


if __name__ == "__main__":
    run_training(sys.argv[1:])
