"""Value-network regression training on one card or data-parallel
ranks.

The port of ``training/value.py`` (the reference's
``reinforcement_value_trainer``: MSE + SGD over (state, outcome z)
pairs, the SL trainer's command line, per-epoch exports +
``metadata.json`` + persisted split). The corpus is an outcome-labelled
shard set (``"targets": "outcome"`` in the manifest, z in the
``actions`` slot), the layout ``training/selfplay_data.py`` writes.

The loop, checkpoints, resume, exports and instrumentation are the SL
trainer's (:class:`.sl.SLTrainer`), under the prefix ``value``
(``value.epoch`` spans, ``value.step_save`` barriers,
``train_data_wait_seconds{trainer="value"}``); the augmentation
transforms the planes only -- the scalar target is
rotation-invariant. Data parallelism is the SL trainer's: the loss sums
this rank's rows over the global batch (or the global weight sum), and
the gradients are summed over the ranks.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from rocalphago_tpu_torch.obs.torchobs import track
from rocalphago_tpu_torch.parallel import mesh as meshlib
from rocalphago_tpu_torch.training.sl import (
    SLConfig,
    SLTrainer,
    TrainState,
    apply_update,
    config_from_args,
    draw_local_elements,
    training_parser,
)
from rocalphago_tpu_torch.training.symmetries import transform_planes


@dataclasses.dataclass
class ValueConfig(SLConfig):
    """The SL stage's config with the reference's value minibatch."""

    minibatch: int = 32


def value_loss_fn(module, planes, outcomes, weights=None, mesh=None):
    """The mean squared error; on a sharded ``mesh`` this rank's share
    (its rows over the global batch or weight sum), which the caller
    sums over the ranks."""
    pred = module(planes)
    sq = (pred - outcomes.float()) ** 2
    sharded = mesh is not None and mesh.sharded
    if weights is None:
        if sharded:
            return sq.sum() / (sq.shape[0] * mesh.width)
        return sq.mean()
    total = weights.sum()
    if sharded:
        total = mesh.all_reduce(total.reshape(1))[0]
    return (sq * weights).sum() / total.clamp(min=1.0)


def make_train_step(module, optimizer, lr_at, symmetries: bool, mesh=None):
    """``(state, planes, outcomes, t=None) → (state, metrics)``, updating
    ``state`` in place; ``t`` replaces the generator's draw (this rank's
    rows of the global draw on a sharded ``mesh``)."""

    def train_step(state: TrainState, planes, outcomes, t=None):
        planes = planes.float()
        if symmetries:
            if t is None:
                t = draw_local_elements(state.generator, planes, mesh)
            planes = transform_planes(planes, t)
        optimizer.zero_grad(set_to_none=True)
        loss = value_loss_fn(module, planes, outcomes, mesh=mesh)
        loss.backward()
        if mesh is not None:
            loss, = mesh.all_reduce_grads([module], (loss,))
        apply_update(optimizer, lr_at(state.step))
        state.step += 1
        return state, {"mse": loss.detach()}

    return train_step


def make_eval_step(module, mesh=None):
    @torch.no_grad()
    def eval_step(planes, outcomes, weights):
        mse = value_loss_fn(module, planes.float(), outcomes, weights,
                            mesh=mesh)
        count = weights.sum()
        if mesh is not None and mesh.sharded:
            mse, count = mesh.all_reduce(torch.stack([mse, count]))
        return {"mse": mse, "count": count}
    return eval_step


class ValueTrainer(SLTrainer):
    """Value-net regression on an outcome corpus."""

    METRICS = ("mse",)
    PHASE = "value"

    def _check_dataset(self) -> None:
        super()._check_dataset()
        if self.dataset.manifest.get("targets") != "outcome":
            raise ValueError(
                "value training needs an outcome-labelled corpus "
                "(the layout training.selfplay_data writes)")

    def make_steps(self, module, optimizer, lr_at):
        mesh = self.mesh if self.mesh.sharded else None
        return (track("value.train_step", make_train_step(
                    module, optimizer, lr_at, self.cfg.symmetries,
                    mesh=mesh)),
                track("value.eval_step", make_eval_step(module, mesh=mesh)))


def run_training(argv=None) -> dict:
    """CLI parity with the reference value trainer."""
    a = training_parser("Value network regression on self-play outcomes",
                        32, "npz shard prefix of an outcome corpus"
                        ).parse_args(argv)
    meshlib.distributed_init(device=a.device)
    return ValueTrainer(config_from_args(ValueConfig, a)).run()


if __name__ == "__main__":
    run_training(sys.argv[1:])
