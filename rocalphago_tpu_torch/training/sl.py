"""Supervised policy training on one card or data-parallel ranks.

The port of ``training/sl.py`` (the reference's
``supervised_policy_trainer``: SGD + categorical cross-entropy on
(state → expert move), minibatch 16, lr 0.003 with Keras-style decay,
.93/.05/.02 split, 8-symmetry augmentation, per-epoch weight exports +
``metadata.json``, a persisted shuffle for resume).

* The train step is eager PyTorch: the symmetry gather on the device
  (:mod:`.symmetries`), the net's forward and autograd's backward
  (``conv2d`` -- the reference leaves its convolutions to XLA, outside
  any Pallas kernel), then ``torch.optim.SGD``.
* Batches come from :func:`..data.pipeline.device_prefetch`.
* A checkpoint holds params, optimizer state, step and the symmetry
  generator's state; the batch order is a pure function of (seed,
  epoch), and the data cursor is derived from the step. A run killed
  and resumed ends on the same bits as one that was not: on the card
  that needs deterministic convolution algorithms, so the trainer
  sets ``torch.backends.cudnn.deterministic`` (and turns off
  ``benchmark``).

:class:`SLTrainer`'s loop is also the value trainer's (:mod:`.value`),
which supplies its own step, loss and metrics, and its own ``PHASE``:
the prefix of the reference's spans (``sl.epoch`` with ``sl.train``,
``sl.eval``, ``sl.export`` and ``sl.save`` inside), fault barriers
(``sl.pre_epoch``, ``sl.step_save``, ``sl.pre_save``, ``sl.post_save``)
and the ``trainer`` label of ``train_data_wait_seconds`` (each batch's
host wait, :func:`..obs.registry.timed`). Spans and the registry
snapshot go to ``metrics.jsonl``.

Data parallelism (``num_devices``, default every rank of the process
group; :mod:`..parallel.mesh`): every rank draws the same global
minibatch from the same ``SeedSequence([seed, epoch])`` iterator and
the same per-row symmetry draws, then takes its contiguous rows. The
loss sums its rows over the *global* valid count (one ``all_reduce``
of the count before the backward), and the gradients are summed over
the ranks, so a step is the one-rank step. Only the coordinator (rank
0) writes ``metadata.json``, ``metrics.jsonl``, ``shuffle.npz``, the
exports and the checkpoint files; every rank computes the split and
takes part in each save (a barrier) and restore (the same files).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from rocalphago_tpu_torch.data.pipeline import (
    ShardedDataset,
    batch_iterator,
    device_prefetch,
    split_indices,
)
from rocalphago_tpu_torch.io.checkpoint import MetadataWriter, TrainCheckpointer
from rocalphago_tpu_torch.io.metrics import MetricsLogger
from rocalphago_tpu_torch.models.nn_util import NeuralNetBase
from rocalphago_tpu_torch.obs import registry as obs_registry
from rocalphago_tpu_torch.obs import trace
from rocalphago_tpu_torch.obs.torchobs import flush_untracked, track
from rocalphago_tpu_torch.parallel import mesh as meshlib
from rocalphago_tpu_torch.runtime import faults
from rocalphago_tpu_torch.training.symmetries import (
    draw_elements,
    random_transform_batch,
)


@dataclasses.dataclass
class SLConfig:
    """Flat, JSON-serializable stage config (the reference's, and the
    device)."""

    model_json: str = ""
    train_data: str = ""          # shard prefix (npz pipeline)
    out_dir: str = ""
    minibatch: int = 16
    epochs: int = 10
    learning_rate: float = 0.003
    decay: float = 0.0            # Keras-style lr/(1+decay*step)
    momentum: float = 0.0
    train_val_test: tuple = (0.93, 0.05, 0.02)
    symmetries: bool = True
    seed: int = 0
    num_devices: int | None = None   # data width; None: every rank
    max_validation_batches: int = 200
    epoch_length: int | None = None   # steps per epoch; None = full pass
    save_every: int | None = None     # also checkpoint every N steps
    device: str | None = None         # None: the CUDA card


class TrainState:
    """What a checkpoint holds: the module's params, the optimizer's
    state, the number of updates taken and the symmetry generator."""

    def __init__(self, module: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 generator: torch.Generator):
        self.module = module
        self.optimizer = optimizer
        self.generator = generator
        self.step = 0

    def state_dict(self) -> dict:
        return {"params": self.module.state_dict(),
                "opt": self.optimizer.state_dict(),
                "step": self.step, "rng": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        self.module.load_state_dict(sd["params"])
        self.optimizer.load_state_dict(sd["opt"])
        self.step = int(sd["step"])
        self.generator.set_state(sd["rng"])


def make_optimizer(cfg, params):
    """``(SGD, lr_at)``: SGD with ``cfg.momentum`` (0: plain SGD; else
    the heavy-ball buffer, ``dampening`` 0, which is optax's
    ``trace``), and the reference's Keras-style inverse-time decay,
    ``lr_at(step)`` being the rate of update ``step`` counted from 0
    (optax evaluates its schedule at the count before the update)."""
    opt = torch.optim.SGD(params, lr=cfg.learning_rate,
                          momentum=cfg.momentum)

    def lr_at(step: int) -> float:
        return cfg.learning_rate / (1.0 + cfg.decay * step)

    return opt, lr_at


def apply_update(optimizer, lr: float) -> None:
    """One optimizer step at rate ``lr`` on the gradients in place."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()


def policy_loss_fn(module, planes, actions, weights=None, mesh=None):
    """(mean cross-entropy, top-1 accuracy) over the rows whose action
    is a board point; pass actions (``== N``, present when a corpus was
    converted with passes) are masked out of both. On a sharded
    ``mesh`` both are this rank's share -- its rows summed over the
    global count -- which the caller sums over the ranks."""
    logits = module(planes)
    n = logits.shape[-1]
    valid = (actions < n).float()
    if weights is not None:
        valid = valid * weights
    count = valid.sum()
    if mesh is not None and mesh.sharded:
        count = mesh.all_reduce(count.reshape(1))[0]
    denom = count.clamp(min=1.0)
    xent = F.cross_entropy(logits, actions.clamp(max=n - 1).long(),
                           reduction="none")
    loss = (xent * valid).sum() / denom
    acc = ((logits.argmax(dim=-1) == actions).float() * valid).sum() / denom
    return loss, acc


def draw_local_elements(generator, planes, mesh=None):
    """The symmetry elements of this rank's rows: drawn for the global
    batch on every rank, then sliced (a rank is never reseeded)."""
    width = 1 if mesh is None else mesh.width
    t = draw_elements(generator, planes.shape[0] * width, planes.device)
    return t if mesh is None else mesh.take(t)


def make_train_step(module, optimizer, lr_at, size: int, symmetries: bool,
                    mesh=None):
    """``(state, planes, actions, t=None) → (state, metrics)``, updating
    ``state`` in place. ``t`` (one group element per local sample)
    replaces the generator's draw when given. On a sharded ``mesh`` the
    planes are this rank's rows of the global minibatch, and the
    gradients and metrics are summed over the ranks."""

    def train_step(state: TrainState, planes, actions, t=None):
        planes = planes.float()
        if symmetries:
            if t is None:
                t = draw_local_elements(state.generator, planes, mesh)
            planes, actions = random_transform_batch(
                state.generator, planes, actions, size, t=t)
        optimizer.zero_grad(set_to_none=True)
        loss, acc = policy_loss_fn(module, planes, actions, mesh=mesh)
        loss.backward()
        if mesh is not None:
            loss, acc = mesh.all_reduce_grads([module], (loss, acc))
        apply_update(optimizer, lr_at(state.step))
        state.step += 1
        return state, {"loss": loss.detach(), "accuracy": acc.detach()}

    return train_step


def make_eval_step(module, num_points: int, mesh=None):
    @torch.no_grad()
    def eval_step(planes, actions, weights):
        loss, acc = policy_loss_fn(module, planes.float(), actions, weights,
                                   mesh=mesh)
        # effective sample count = the loss denominator (real rows
        # whose action is a board point)
        count = ((actions < num_points).float() * weights).sum()
        if mesh is not None and mesh.sharded:
            loss, acc, count = mesh.all_reduce(torch.stack([loss, acc,
                                                            count]))
        return {"loss": loss, "accuracy": acc, "count": count}
    return eval_step


def pad_batch(planes, targets, batch_size: int):
    """Pad a short final batch up to ``batch_size`` (repeating row 0)
    with a 0/1 weight vector marking the real rows, so small
    validation splits still contribute instead of being dropped."""
    k = len(targets)
    weights = np.ones(batch_size, np.float32)
    if k < batch_size:
        pad = batch_size - k
        planes = np.concatenate(
            [planes, np.repeat(planes[:1], pad, axis=0)])
        targets = np.concatenate(
            [targets, np.repeat(targets[:1], pad, axis=0)])
        weights[k:] = 0.0
    return planes, targets, weights


def evaluate_batches(eval_step, dataset, indices, minibatch: int, device,
                     max_batches: int | None = None,
                     mesh=None) -> tuple[dict, float]:
    """``(means, count)``: the eval step's metrics averaged over
    ``indices`` weighted by each batch's count (``means`` empty when
    the count is 0); short batches padded with zero weights. With a
    ``mesh`` each rank evaluates its rows of every padded global batch,
    and the eval step sums over the ranks."""
    sums: dict[str, float] = {}
    count = 0.0
    rng = np.random.default_rng(0)
    it = batch_iterator(dataset, indices, minibatch, rng, epochs=1,
                        drop_remainder=False)
    for i, batch in enumerate(it):
        if max_batches is not None and i >= max_batches:
            break
        planes, targets, weights = (
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in meshlib.shard_batch(mesh, pad_batch(*batch,
                                                         minibatch)))
        m = eval_step(planes, targets, weights)
        c = float(m.pop("count"))
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v) * c
        count += c
    if not count:
        return {}, 0.0
    return {k: v / count for k, v in sums.items()}, count


class SLTrainer:
    """Supervised policy trainer: net + data + checkpointing on one
    device (CUDA unless ``cfg.device`` names another). The value
    trainer subclasses it with its own ``METRICS`` and steps. Usable
    programmatically (tests drive small configs through it) or through
    each module's ``run_training`` CLI."""

    METRICS = ("loss", "accuracy")
    #: the prefix of the spans and barriers, the ``trainer`` label
    PHASE = "sl"

    def __init__(self, cfg, net: NeuralNetBase | None = None):
        self.cfg = cfg
        self.mesh = meshlib.make_mesh(cfg.num_devices, cfg.device)
        self.device = self.mesh.device
        self.mesh.local_batch(cfg.minibatch)   # raises unless it divides
        self.net = net or NeuralNetBase.load_model(cfg.model_json,
                                                   device=self.device)
        if self.net.device.type != self.device.type:
            raise ValueError(f"the net is on {self.net.device}, the "
                             f"trainer runs on {self.device}")
        self.dataset = ShardedDataset(cfg.train_data)
        self._check_dataset()
        os.makedirs(cfg.out_dir, exist_ok=True)
        if self.device.type == "cuda":
            # exact resume needs the same bits from every backward:
            # deterministic convolution algorithms, none picked by timing
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False

        module = self.net.module
        self.mesh.replicate(module)
        optimizer, lr_at = make_optimizer(cfg, module.parameters())
        generator = torch.Generator(device=self.device)
        generator.manual_seed(cfg.seed)
        self.state = TrainState(module, optimizer, generator)
        self._train_step, self._eval_step = self.make_steps(
            module, optimizer, lr_at)

        # artifact files are the coordinator's; every rank takes part in
        # a checkpoint save (a barrier) and restore
        self.coord = meshlib.is_coordinator()
        self.ckpt = TrainCheckpointer(
            os.path.join(cfg.out_dir, "checkpoints"), write=self.coord,
            mesh=self.mesh)
        self.metrics = MetricsLogger(
            os.path.join(cfg.out_dir, "metrics.jsonl")
            if self.coord else None, echo=self.coord)
        # spans share the metrics stream (obs.trace)
        trace.configure(self.metrics)
        self.train_idx, self.val_idx, self.test_idx = split_indices(
            len(self.dataset), cfg.train_val_test, seed=cfg.seed,
            path=os.path.join(cfg.out_dir, "shuffle.npz"),
            write=self.coord)
        self.start_epoch = 0
        self._resume_skip = 0
        self._maybe_resume()

    def _check_dataset(self) -> None:
        if self.dataset.planes != self.net.preprocess.output_dim:
            raise ValueError(
                f"dataset has {self.dataset.planes} planes but the model's "
                f"feature list needs {self.net.preprocess.output_dim}")

    def make_steps(self, module, optimizer, lr_at):
        size = self.net.board
        mesh = self.mesh if self.mesh.sharded else None
        return (track("sl.train_step", make_train_step(
                    module, optimizer, lr_at, size, self.cfg.symmetries,
                    mesh=mesh)),
                track("sl.eval_step", make_eval_step(module, size * size,
                                                     mesh=mesh)))

    # ----------------------------------------------------------- resume

    def _maybe_resume(self):
        restored, step = self.ckpt.restore()
        if restored is None:
            return
        self.state.load_state_dict(restored)
        # the data cursor is derived, not stored: batch order within an
        # epoch is a pure function of (seed, epoch) -- see run() -- so
        # step % steps_per_epoch IS the number of consumed batches
        self.start_epoch, self._resume_skip = divmod(
            self.state.step, max(self._steps_per_epoch(), 1))
        self.metrics.log("resume", step=self.state.step,
                         epoch=self.start_epoch, skip=self._resume_skip)

    def _steps_per_epoch(self) -> int:
        if self.cfg.epoch_length:
            return self.cfg.epoch_length
        return max(len(self.train_idx) // self.cfg.minibatch, 1)

    # ------------------------------------------------------------- train

    def run(self) -> dict:
        cfg = self.cfg
        meta = MetadataWriter(
            os.path.join(cfg.out_dir, "metadata.json"),
            header={"cmd": " ".join(sys.argv),
                    "config": dataclasses.asdict(cfg),
                    "dataset_positions": len(self.dataset)},
            enabled=self.coord)
        steps_per_epoch = self._steps_per_epoch()
        phase = self.PHASE
        # host wait per prefetched batch: the data-starvation probe
        data_wait = obs_registry.histogram("train_data_wait_seconds",
                                           trainer=phase)
        final = {}
        for epoch in range(self.start_epoch, cfg.epochs):
            with trace.span(f"{phase}.epoch", epoch=epoch):
                faults.barrier(f"{phase}.pre_epoch", epoch)
                skip = self._resume_skip if epoch == self.start_epoch else 0
                # host RNG seeded per epoch → identical batch order on a
                # re-run of the same epoch after resume
                host_rng = np.random.default_rng(
                    np.random.SeedSequence([cfg.seed, epoch]))
                it = batch_iterator(self.dataset, self.train_idx,
                                    cfg.minibatch, host_rng, epochs=1,
                                    skip=skip)
                if self.mesh.sharded:
                    # the global batch on every rank; each takes its rows
                    it = (meshlib.shard_batch(self.mesh, b) for b in it)
                t0 = time.time()
                steps = []
                with trace.span(f"{phase}.train"), contextlib.closing(
                        device_prefetch(it, self.device, size=2)) as batches:
                    for i, (planes, targets) in enumerate(
                            obs_registry.timed(batches, data_wait)):
                        if i >= steps_per_epoch - skip:
                            break
                        self.state, m = self._train_step(
                            self.state, planes, targets)
                        steps.append(m)
                        if cfg.save_every:
                            gstep = epoch * steps_per_epoch + skip + len(steps)
                            if gstep % cfg.save_every == 0:
                                self.ckpt.save(gstep, self.state.state_dict())
                                faults.barrier(f"{phase}.step_save", gstep)
                if not steps:
                    raise ValueError(
                        f"train split ({len(self.train_idx)} positions) "
                        f"yields no full minibatch of {cfg.minibatch}; "
                        "add data or shrink the minibatch")
                entry = {"epoch": epoch, "step": self.state.step}
                for k in self.METRICS:
                    entry[f"train_{k}"] = float(
                        torch.stack([m[k] for m in steps]).mean())
                dt = time.time() - t0
                with trace.span(f"{phase}.eval"):
                    val = self.evaluate(self.val_idx)
                entry.update({f"val_{k}": v for k, v in val.items()})
                entry["positions_per_s"] = (len(steps) * cfg.minibatch
                                            / max(dt, 1e-9))
                self.metrics.log("epoch", **entry)
                meta.record_epoch(entry)
                # exports BEFORE the checkpoint save (the commit point): a
                # crash in between is healed by resume re-running the
                # epoch and rewriting identical artifacts atomically
                with trace.span(f"{phase}.export"):
                    self._export_weights(epoch)
                with trace.span(f"{phase}.save"):
                    faults.barrier(f"{phase}.pre_save", epoch)
                    self.ckpt.save(self.state.step, self.state.state_dict())
                    faults.barrier(f"{phase}.post_save", epoch)
                final = entry
        # held-out test-split metric (BASELINE.md metric 1 for the
        # policy: top-1 move accuracy), also reportable standalone
        # through training.evaluate
        if len(self.test_idx):
            test = self.evaluate(self.test_idx)
            fields = {f"test_{k}": v for k, v in test.items()}
            final = dict(final, **fields)
            meta.update(**fields)
            self.metrics.log("test", **test)
        # the run's counter and histogram state, for obs_report
        flush_untracked()
        obs_registry.log_to(self.metrics)
        self.metrics.close()
        return final

    def evaluate(self, indices, max_batches: int | None = None) -> dict:
        means, _ = evaluate_batches(
            self._eval_step, self.dataset, indices, self.cfg.minibatch,
            self.device, max_batches or self.cfg.max_validation_batches,
            mesh=self.mesh if self.mesh.sharded else None)
        return {k: means.get(k, float("nan")) for k in self.METRICS}

    def _export_weights(self, epoch: int) -> None:
        """Per-epoch weight export (``weights.NNNNN.flax.msgpack``, the
        reference's format) plus ``model.json`` -- a loadable spec
        always pointing at the latest weights, so downstream stages
        (GTP, the evaluator, either package) can consume
        ``out_dir/model.json`` directly. The coordinator's alone."""
        if not self.coord:
            return
        weights = os.path.join(
            self.cfg.out_dir, f"weights.{epoch:05d}.flax.msgpack")
        self.net.save_model(
            os.path.join(self.cfg.out_dir, "model.json"), weights)


def training_parser(description: str, minibatch: int, data_help: str):
    """The trainers' shared command line (the reference's flags and
    ``--device``)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("model_json")
    ap.add_argument("train_data", help=data_help)
    ap.add_argument("out_dir")
    ap.add_argument("--minibatch", "-B", type=int, default=minibatch)
    ap.add_argument("--epochs", "-E", type=int, default=10)
    ap.add_argument("--learning-rate", "-l", type=float, default=0.003)
    ap.add_argument("--decay", "-d", type=float, default=0.0)
    ap.add_argument("--momentum", type=float, default=0.0)
    ap.add_argument("--train-val-test", nargs=3, type=float,
                    default=[0.93, 0.05, 0.02])
    ap.add_argument("--no-symmetries", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-devices", type=int, default=None,
                    help="data-parallel width (default: every rank; "
                         "launch ranks with torch.distributed.run)")
    ap.add_argument("--epoch-length", type=int, default=None)
    ap.add_argument("--save-every", type=int, default=None,
                    help="extra checkpoint every N steps (mid-epoch "
                         "preemption recovery)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def config_from_args(cls, a):
    return cls(
        model_json=a.model_json, train_data=a.train_data, out_dir=a.out_dir,
        minibatch=a.minibatch, epochs=a.epochs,
        learning_rate=a.learning_rate, decay=a.decay, momentum=a.momentum,
        train_val_test=tuple(a.train_val_test),
        symmetries=not a.no_symmetries, seed=a.seed,
        num_devices=a.num_devices, epoch_length=a.epoch_length,
        save_every=a.save_every, device=a.device)


def run_training(argv=None) -> dict:
    """CLI parity with the reference trainer."""
    a = training_parser("Supervised policy training on expert games", 16,
                        "npz shard prefix").parse_args(argv)
    # the process group before any device work; a no-op for one process
    meshlib.distributed_init(device=a.device)
    return SLTrainer(config_from_args(SLConfig, a)).run()


if __name__ == "__main__":
    run_training(sys.argv[1:])
