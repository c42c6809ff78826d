"""Value-network regression training on one card.

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
rotation-invariant.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from rocalphago_tpu_torch.training.sl import (
    SLConfig,
    SLTrainer,
    TrainState,
    apply_update,
    config_from_args,
    training_parser,
)
from rocalphago_tpu_torch.training.symmetries import (
    draw_elements,
    transform_planes,
)


@dataclasses.dataclass
class ValueConfig(SLConfig):
    """The SL stage's config with the reference's value minibatch."""

    minibatch: int = 32


def value_loss_fn(module, planes, outcomes, weights=None):
    pred = module(planes)
    sq = (pred - outcomes.float()) ** 2
    if weights is None:
        return sq.mean()
    return (sq * weights).sum() / weights.sum().clamp(min=1.0)


def make_train_step(module, optimizer, lr_at, symmetries: bool):
    """``(state, planes, outcomes, t=None) → (state, metrics)``, updating
    ``state`` in place; ``t`` replaces the generator's draw."""

    def train_step(state: TrainState, planes, outcomes, t=None):
        planes = planes.float()
        if symmetries:
            if t is None:
                t = draw_elements(state.generator, planes.shape[0],
                                  planes.device)
            planes = transform_planes(planes, t)
        optimizer.zero_grad(set_to_none=True)
        loss = value_loss_fn(module, planes, outcomes)
        loss.backward()
        apply_update(optimizer, lr_at(state.step))
        state.step += 1
        return state, {"mse": loss.detach()}

    return train_step


def make_eval_step(module):
    @torch.no_grad()
    def eval_step(planes, outcomes, weights):
        return {"mse": value_loss_fn(module, planes.float(), outcomes,
                                     weights),
                "count": weights.sum()}
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
        return (make_train_step(module, optimizer, lr_at,
                                self.cfg.symmetries),
                make_eval_step(module))


def run_training(argv=None) -> dict:
    """CLI parity with the reference value trainer."""
    a = training_parser("Value network regression on self-play outcomes",
                        32, "npz shard prefix of an outcome corpus"
                        ).parse_args(argv)
    return ValueTrainer(config_from_args(ValueConfig, a)).run()


if __name__ == "__main__":
    run_training(sys.argv[1:])
