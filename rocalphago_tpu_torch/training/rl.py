"""REINFORCE policy training over self-play, on one card or
data-parallel ranks.

The port of ``training/rl.py`` (the reference's
``reinforcement_policy_trainer``: lockstep game batches of the learner
against a past self drawn from an opponent pool, the gradient of the
log-likelihood of the learner's moves scaled by the ±1 outcome, plain
SGD, ``--game-batch 20 --policy-temp 0.67 --move-limit 500
--save-every 10``, ``metadata.json`` resume).

An iteration:

* **plays** the game batch with :func:`..search.selfplay.play_games`
  (or :func:`~..search.selfplay.make_selfplay_chunked` with
  ``chunk``): the learner is net A, Black in games ``[0:B/2]`` and
  White in the rest; the opponent net B. Every ply's encode runs the
  chase kernel, and the games are scored on the device (one labels
  launch);
* **replays** the recorded actions ply by ply through the engine,
  re-encoding only the learner's half of the batch (games ``[0:B/2]``
  on even plies, ``[B/2:B]`` on odd ones; the ply index is a host
  integer, so the choice is a host branch). Each replay ply computes
  the z-weighted log-likelihood loss of the learner's moves and calls
  ``backward()``, so the gradient accumulates in ``.grad``; no autograd
  graph outlives its ply, and no ``[T, B, ...]`` planes are kept. The
  learner's params are frozen for the whole iteration. Rows of games
  already over, and pass moves, weigh 0 and add exactly zero;
* **updates** with one ``torch.optim.SGD`` step (``optax.sgd``).

The replay makes no device→host sync; the iteration's one sync is the
caller's read of the metrics. The phases run in the reference's spans
``rl.play``, ``rl.replay`` (tagged with the host's ply count) and
``rl.update``; they time the host's dispatch, and the card's remainder
lands in the trainer's ``rl.iteration`` span, which the metrics read
closes. The trainer adds ``rl.data`` (the opponent draw) and
``rl.save``, the barriers ``rl.pre_iteration``, ``rl.post_iteration``,
``rl.pre_save`` and ``rl.post_save``, and the chunked replay's
pipeline records as runner ``rl.replay``. Both phases always run ``move_limit``
plies, so the monolithic and chunked iterations take the same draws
and end on the same bits. The game draws come from a
``torch.Generator`` carried in :class:`RLState` (checkpointed, so a
resumed run is bit-identical to a straight one); it cannot reproduce
the reference's JAX streams, so the parity tests replay the
reference's games (``tests/test_torch_rl.py``).

Data parallelism (``num_devices``, default every rank of the process
group; :mod:`..parallel.mesh`): the games are sharded by global game
index (self-play's ``halves`` layout, so each rank holds an equal share
of the learner's Black and White games) with the one-rank run's draws;
each rank replays its games with the loss over the *global* batch, the
gradients are summed over the ranks before the update, and the win,
draw and move statistics are computed on the gathered outcomes. Every
rank reads the same opponent snapshot; only the coordinator writes the
pool, the exports, ``metrics.jsonl``, ``metadata.json`` and the
checkpoint files.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import glob
import os
import sys
import time

import numpy as np
import torch

from rocalphago_tpu_torch.device import resolve_device
from rocalphago_tpu_torch.engine.torchgo import (
    GoConfig,
    GoState,
    GroupData,
    default_komi,
    group_data,
    new_states,
    step,
)
from rocalphago_tpu_torch.features.planes import encode
from rocalphago_tpu_torch.io.checkpoint import MetadataWriter, TrainCheckpointer
from rocalphago_tpu_torch.io.metrics import MetricsLogger
from rocalphago_tpu_torch.models.nn_util import NeuralNetBase
from rocalphago_tpu_torch.models.weights import (
    params_from_flax,
    params_to_flax,
    read_flax_msgpack,
    write_flax_msgpack,
)
from rocalphago_tpu_torch.obs import registry as obs_registry
from rocalphago_tpu_torch.obs import trace
from rocalphago_tpu_torch.obs.torchobs import flush_untracked, track
from rocalphago_tpu_torch.parallel import mesh as meshlib
from rocalphago_tpu_torch.runtime import faults, retries
from rocalphago_tpu_torch.runtime.pipeline import ChunkPipeline
from rocalphago_tpu_torch.search.selfplay import (
    SelfplayResult,
    gather_result,
    make_selfplay_chunked,
    play_games,
    sensible_mask,
)


@dataclasses.dataclass
class RLConfig:
    """Flat, JSON-serializable stage config (the reference's, and the
    device)."""

    model_json: str = ""
    out_dir: str = ""
    learning_rate: float = 0.001
    game_batch: int = 20          # reference default
    iterations: int = 100
    save_every: int = 10
    policy_temp: float = 0.67
    move_limit: int = 500
    seed: int = 0
    num_devices: int | None = None   # data width; None: every rank
    chunk: int = 0    # >0: plies per segment; 0 = one run
    komi: float | None = None   # None = board size's standard
    device: str | None = None   # None: the CUDA card


class RLState:
    """What a checkpoint holds: the learner's params, the optimizer's
    state, the number of iterations taken and the game generator."""

    def __init__(self, module: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 generator: torch.Generator):
        self.module = module
        self.optimizer = optimizer
        self.generator = generator
        self.iteration = 0

    def state_dict(self) -> dict:
        return {"params": self.module.state_dict(),
                "opt": self.optimizer.state_dict(),
                "iteration": self.iteration,
                "rng": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        self.module.load_state_dict(sd["params"])
        self.optimizer.load_state_dict(sd["opt"])
        self.iteration = int(sd["iteration"])
        self.generator.set_state(sd["rng"])


class ReplayPly:
    """One ply of the REINFORCE replay (the reference's
    ``_make_replay_ply``): the learner's half of the batch re-encoded,
    its z-weighted log-likelihood loss back-propagated into the
    module's ``.grad``, and the whole batch stepped by the recorded
    actions. ``module`` maps NHWC float32 planes to float32 logits.
    ``batch`` is the games replayed here and ``divisor`` the loss's
    divisor, the global batch (default ``batch``)."""

    def __init__(self, cfg: GoConfig, features: tuple,
                 module: torch.nn.Module, batch: int, temperature: float,
                 divisor: int | None = None):
        self.cfg = cfg
        self.features = tuple(features)
        self.module = module
        self.batch = batch
        self.divisor = batch if divisor is None else divisor
        self.temperature = temperature

    def __call__(self, states: GoState, z: torch.Tensor,
                 actions_t: torch.Tensor, live_t: torch.Tensor,
                 t: int) -> GoState:
        cfg, n, half = self.cfg, self.cfg.num_points, self.batch // 2
        # the learner moves games [0:half] on even plies and games
        # [half:batch] on odd plies (self-play's colour split)
        rows = slice(0, half) if t % 2 == 0 else slice(half, self.batch)
        with torch.no_grad():
            gd = group_data(cfg, states.board, with_zxor=cfg.enforce_superko,
                            labels=states.labels)
            half_states = GoState(*(x[rows] for x in states))
            half_gd = GroupData(*(None if x is None else x[rows]
                                  for x in gd))
            planes = encode(cfg, half_states, self.features, gd=half_gd)
            sens = sensible_mask(cfg, half_states, half_gd)
        acts = actions_t[rows]
        w = z[rows] * live_t[rows] * (acts < n).float()
        logits = self.module(planes)
        masked = torch.where(sens, logits / self.temperature,
                             torch.finfo(logits.dtype).min)
        logp = torch.log_softmax(masked, dim=-1)
        lp = logp.gather(1, acts.clamp(max=n - 1).long()[:, None])[:, 0]
        (-(w * lp).sum() / self.divisor).backward()
        with torch.no_grad():
            return step(cfg, states, actions_t, gd)


def _learner_z(winners: torch.Tensor, half: int) -> torch.Tensor:
    """Outcome from the LEARNER's perspective: the learner (net A) is
    Black in games [0:half], White in the rest."""
    w = winners.float()
    return torch.cat([w[:half], -w[half:]])


def _metrics(z: torch.Tensor, num_moves: torch.Tensor) -> dict:
    """Win rate over DECIDED games (draws excluded and reported
    separately: counting them as losses biases the learner's win rate
    low on integer komi), the draw rate and the mean game length; on
    the device."""
    wins = (z > 0).sum()
    decided = (z != 0).sum()
    return {
        "win_rate": torch.where(decided > 0,
                                wins / decided.clamp(min=1), 0.5),
        "draw_rate": (z == 0).float().mean(),
        "mean_moves": num_moves.float().mean(),
    }


class RLIteration:
    """``(RLState, opponent module) -> metrics``: one REINFORCE
    iteration, updating the state in place. Its parts, called in turn:
    :meth:`play`, :meth:`replay`, :meth:`update`. ``chunk`` > 0 plays
    and replays in segments of ``chunk`` plies through a
    :class:`ChunkPipeline` (the host at most one segment ahead of the
    card); the result is the same bits as ``chunk`` 0's.

    A call is safe to repeat after a failure: the game generator is
    copied from the state and written back only after the update, and
    the replay starts from zeroed gradients.

    ``mesh``: this rank plays and replays its ``halves`` share of the
    global ``batch`` (a multiple of twice the width); the update is the
    one-rank update (module docstring)."""

    def __init__(self, cfg: GoConfig, features: tuple,
                 module: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 batch: int, move_limit: int, temperature: float,
                 chunk: int = 0, device=None, mesh=None):
        if batch % 2:
            raise ValueError(f"game_batch must be even, got {batch}")
        if chunk < 0:
            raise ValueError(f"chunk must be >= 0, got {chunk}")
        self.mesh = mesh if mesh is not None and mesh.sharded else None
        self.local = (batch if self.mesh is None
                      else self.mesh.local_batch(batch, "halves"))
        self.cfg = cfg
        self.features = tuple(features)
        self.module = module
        self.optimizer = optimizer
        self.batch = batch
        self.move_limit = move_limit
        self.temperature = temperature
        self.chunk = chunk
        self.device = resolve_device(device)
        self.replay_ply = ReplayPly(cfg, features, module, self.local,
                                    temperature, divisor=batch)

    def play(self, generator: torch.Generator,
             opponent: torch.nn.Module) -> SelfplayResult:
        """The game batch, learner against ``opponent``, drawn from
        ``generator``."""
        args = (self.cfg, self.features, self.module, opponent)
        with trace.span("rl.play"):
            if self.chunk:
                return make_selfplay_chunked(
                    *args, self.batch, self.move_limit, chunk=self.chunk,
                    temperature=self.temperature, device=self.device,
                    mesh=self.mesh)(generator)
            return play_games(*args, generator, self.batch,
                              self.move_limit, self.temperature,
                              device=self.device, mesh=self.mesh)

    @track("rl.replay_segment")
    def replay_segment(self, states: GoState, z: torch.Tensor,
                       result: SelfplayResult, live: torch.Tensor,
                       offset: int, end: int) -> GoState:
        """Replay plies ``offset .. end - 1``, accumulating into
        ``.grad``; returns the stepped states."""
        for t in range(offset, end):
            states = self.replay_ply(states, z, result.actions[t], live[t],
                                     t)
        return states

    def replay(self, result: SelfplayResult) -> torch.Tensor:
        """Accumulate the iteration's gradient in the module's
        ``.grad`` (summed over the ranks); returns the learner's outcomes
        z (float32 ``[B]``, this rank's games)."""
        z = _learner_z(result.winners, self.local // 2)
        live = result.live.float()
        states = new_states(self.cfg, self.local, device=self.device)
        self.optimizer.zero_grad(set_to_none=True)
        plies = result.actions.shape[0]
        span = self.chunk or max(plies, 1)
        pipe = (ChunkPipeline(self.device, runner="rl.replay") if self.chunk
                else None)
        with trace.span("rl.replay", plies=plies):
            for offset in range(0, plies, span):
                states = self.replay_segment(states, z, result, live, offset,
                                             min(offset + span, plies))
                if pipe is not None:
                    pipe.push()
            if pipe is not None:
                pipe.finish()
        if self.mesh is not None:
            self.mesh.all_reduce_grads([self.module])
        return z

    def update(self) -> None:
        """One SGD step on the accumulated gradient."""
        with trace.span("rl.update"):
            self.optimizer.step()

    def __call__(self, state: RLState, opponent: torch.nn.Module) -> dict:
        generator = torch.Generator(device=self.device)
        generator.set_state(state.generator.get_state())
        result = self.play(generator, opponent)
        z = self.replay(result)
        self.update()
        state.generator.set_state(generator.get_state())
        state.iteration += 1
        if self.mesh is not None:
            # the statistics of the whole batch, as the one-rank run's
            z = self.mesh.gather(z, 0, "halves")
            result = gather_result(self.mesh, result)
        return _metrics(z, result.num_moves)


def make_rl_iteration(cfg: GoConfig, features: tuple, module, optimizer,
                      batch: int, move_limit: int, temperature: float,
                      device=None) -> RLIteration:
    """One REINFORCE iteration: play a game batch, accumulate the
    z-weighted policy gradient by replay, apply one SGD update."""
    return RLIteration(cfg, features, module, optimizer, batch, move_limit,
                       temperature, device=device)


def make_rl_iteration_chunked(cfg: GoConfig, features: tuple, module,
                              optimizer, batch: int, move_limit: int,
                              temperature: float, chunk: int,
                              device=None) -> RLIteration:
    """:func:`make_rl_iteration` in segments of ``chunk`` plies, both
    the games and the replay; the same bits."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return RLIteration(cfg, features, module, optimizer, batch, move_limit,
                       temperature, chunk=chunk, device=device)


class OpponentPool:
    """Directory of past learner snapshots
    (``opponent.NNNNN.flax.msgpack``, the reference's Flax msgpack, so
    either package reads the other's pool), sampled uniformly each
    iteration."""

    def __init__(self, directory: str, net: NeuralNetBase,
                 write: bool = True):
        self.directory = directory
        #: False on ranks that are not the coordinator: they only read
        self.write = write
        os.makedirs(directory, exist_ok=True)
        if not self.snapshots():
            self.add(net.module.state_dict(), 0)

    def snapshots(self) -> list:
        return sorted(glob.glob(
            os.path.join(self.directory, "opponent.*.flax.msgpack")))

    def add(self, params: dict, iteration: int) -> None:
        """Write the state dict ``params`` as snapshot ``iteration``."""
        if not self.write:
            return
        write_flax_msgpack(
            os.path.join(self.directory,
                         f"opponent.{iteration:05d}.flax.msgpack"),
            params_to_flax(params))

    def sample(self, seed, iteration: int, save_every: int | None = None):
        """``(state dict, file name)``: a uniform draw over the pool,
        seeded by (seed, iteration) — stateless, so a resumed run makes
        the same choices as an uninterrupted one.

        With ``save_every`` the candidate set is reconstructed from the
        save schedule (snapshots land at iterations 0, save_every,
        2·save_every, …) instead of listing the directory, as the
        reference does; a resumed run must then use the ``save_every``
        the directory was written with. Without it the directory
        listing is the candidate set."""
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, iteration]))
        if save_every:
            iters = [0] + [k * save_every for k in
                           range(1, iteration // save_every + 1)]
            pick = iters[rng.integers(len(iters))]
            path = os.path.join(
                self.directory, f"opponent.{pick:05d}.flax.msgpack")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"opponent snapshot {path} is missing. A resumed run "
                    "needs the --save-every the out_dir was populated "
                    "with (the candidate set is reconstructed from the "
                    "save schedule, not the directory listing)")
        else:
            paths = self.snapshots()
            if not paths:
                raise FileNotFoundError(
                    f"no opponent snapshots in {self.directory}")
            path = paths[rng.integers(len(paths))]
        return params_from_flax(read_flax_msgpack(path)), \
            os.path.basename(path)


class RLTrainer:
    """Wires the learner, the opponent pool and the iteration into the
    training loop on one device (CUDA unless ``cfg.device`` names
    another) or over data-parallel ranks (module docstring)."""

    def __init__(self, cfg: RLConfig, net: NeuralNetBase | None = None):
        self.cfg = cfg
        self.mesh = meshlib.make_mesh(cfg.num_devices, cfg.device)
        self.device = self.mesh.device
        self.mesh.local_batch(cfg.game_batch, "halves")   # raises unless
        self.net = net or NeuralNetBase.load_model(cfg.model_json,
                                                   device=self.device)
        if self.net.device.type != self.device.type:
            raise ValueError(f"the net is on {self.net.device}, the "
                             f"trainer runs on {self.device}")
        os.makedirs(cfg.out_dir, exist_ok=True)
        if self.device.type == "cuda":
            # exact resume needs the same bits from every backward:
            # deterministic convolution algorithms, none picked by timing
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False

        # scoring komi: per-board-size default unless overridden (the
        # net spec's GoConfig always carries the 19x19 value)
        game_cfg = dataclasses.replace(
            self.net.cfg, komi=cfg.komi if cfg.komi is not None
            else default_komi(self.net.cfg.size))
        cfg.komi = game_cfg.komi    # metadata records the resolved value
        module = self.net.module
        self.mesh.replicate(module)
        optimizer = torch.optim.SGD(module.parameters(),
                                    lr=cfg.learning_rate)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(cfg.seed)
        self.state = RLState(module, optimizer, generator)
        self.opponent = copy.deepcopy(module).requires_grad_(False)
        self.iteration = RLIteration(
            game_cfg, self.net.feature_list, module, optimizer,
            cfg.game_batch, cfg.move_limit, cfg.policy_temp,
            chunk=cfg.chunk, device=self.device, mesh=self.mesh)
        # artifact files are the coordinator's; the other ranks read the
        # pool it writes (a barrier after each write) and restore its
        # checkpoints
        self.coord = meshlib.is_coordinator()
        self.pool = OpponentPool(os.path.join(cfg.out_dir, "opponents"),
                                 self.net, write=self.coord)
        self.mesh.barrier()
        self.ckpt = TrainCheckpointer(
            os.path.join(cfg.out_dir, "checkpoints"), write=self.coord,
            mesh=self.mesh)
        self.metrics = MetricsLogger(
            os.path.join(cfg.out_dir, "metrics.jsonl")
            if self.coord else None, echo=self.coord)
        # spans share the metrics stream (obs.trace)
        trace.configure(self.metrics)
        self.start_iteration = 0
        self._maybe_resume()

    def _maybe_resume(self):
        restored, _ = self.ckpt.restore()
        if restored is None:
            return
        self.state.load_state_dict(restored)
        self.start_iteration = self.state.iteration
        self.metrics.log("resume", iteration=self.start_iteration)

    def run(self) -> dict:
        cfg = self.cfg
        meta = MetadataWriter(
            os.path.join(cfg.out_dir, "metadata.json"),
            header={"cmd": " ".join(sys.argv),
                    "config": dataclasses.asdict(cfg)},
            enabled=self.coord)
        final = {}
        # transient-failure re-dispatch of the segmented iteration: a
        # repeated call recomputes the identical result (RLIteration)
        step_fn = self.iteration
        if cfg.chunk:
            step_fn = retries.retry(max_attempts=3, base_delay=1.0)(step_fn)
        for it in range(self.start_iteration, cfg.iterations):
            with trace.span("rl.iteration", iteration=it):
                faults.barrier("rl.pre_iteration", it)
                with trace.span("rl.data"):    # the opponent draw (I/O)
                    opp_params, opp_name = self.pool.sample(
                        cfg.seed, it, save_every=cfg.save_every)
                    self.opponent.load_state_dict(opp_params)
                t0 = time.time()
                m = step_fn(self.state, self.opponent)
                # the win-rate read syncs the iteration's work, so the
                # time below and rl.iteration are its wall time
                win = float(m["win_rate"])
                faults.barrier("rl.post_iteration", it)
                entry = {
                    "iteration": it, "opponent": opp_name,
                    "win_rate": win,
                    "mean_moves": float(m["mean_moves"]),
                    "games_per_min": cfg.game_batch * 60.0
                    / max(time.time() - t0, 1e-9),
                }
                self.metrics.log("iteration", **entry)
                meta.record_epoch(entry)
                final = entry
                if ((it + 1) % cfg.save_every == 0
                        or it + 1 == cfg.iterations):
                    with trace.span("rl.save"):
                        # pool snapshot and exports BEFORE the checkpoint
                        # save (the commit point): a crash anywhere in
                        # here is healed by resume re-running the
                        # iteration and rewriting identical artifacts
                        # atomically
                        self.pool.add(self.state.module.state_dict(),
                                      it + 1)
                        self._export_weights(it + 1)
                        faults.barrier("rl.pre_save", it)
                        self.ckpt.save(it + 1, self.state.state_dict())
                        faults.barrier("rl.post_save", it)
        # the run's counter and histogram state, for obs_report
        flush_untracked()
        obs_registry.log_to(self.metrics)
        self.metrics.close()
        return final

    def _export_weights(self, iteration: int) -> None:
        """``weights.NNNNN.flax.msgpack`` plus ``model.json``, a spec
        always pointing at the latest weights (GTP-loadable by either
        package). The coordinator's alone."""
        if not self.coord:
            return
        weights = os.path.join(
            self.cfg.out_dir, f"weights.{iteration:05d}.flax.msgpack")
        self.net.save_model(
            os.path.join(self.cfg.out_dir, "model.json"), weights)


def run_training(argv=None) -> dict:
    """CLI parity with the reference RL trainer."""
    ap = argparse.ArgumentParser(
        description="REINFORCE policy training via self-play")
    ap.add_argument("model_json")
    ap.add_argument("out_dir")
    ap.add_argument("--learning-rate", type=float, default=0.001)
    ap.add_argument("--game-batch", type=int, default=20)
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--policy-temp", type=float, default=0.67)
    ap.add_argument("--move-limit", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-devices", type=int, default=None,
                    help="data-parallel width (default: every rank; "
                         "launch ranks with torch.distributed.run)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="plies per segment (0 = one run of the games "
                         "and one of the replay)")
    ap.add_argument("--komi", type=float, default=None,
                    help="area-scoring komi (default: the board "
                         "size's standard; engine.torchgo.default_komi)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args(argv)
    meshlib.distributed_init(device=a.device)
    cfg = RLConfig(
        model_json=a.model_json, out_dir=a.out_dir,
        learning_rate=a.learning_rate, game_batch=a.game_batch,
        iterations=a.iterations, save_every=a.save_every,
        policy_temp=a.policy_temp, move_limit=a.move_limit,
        seed=a.seed, num_devices=a.num_devices, chunk=a.chunk,
        komi=a.komi, device=a.device)
    return RLTrainer(cfg).run()


if __name__ == "__main__":
    run_training(sys.argv[1:])
