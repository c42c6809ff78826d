"""Fast rollout policy: the port of ``models/rollout.py``.

A deliberately small net for the rollouts of the MCTS λ mix: one 3×3
convolution (32 filters, ReLU) over the cheap feature subset, then the
point head. The subset has no candidate-move or ladder planes, so its
encode is a fraction of the 48-plane one (and launches no chase
kernel). The evaluation surface (``eval_state``, ``batch_eval_state``)
is the policy's, through :class:`~.nn_util.PointPolicyEval`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from rocalphago_tpu_torch.models.nn_util import (
    NeuralNetBase,
    PointHead,
    PointPolicyEval,
    neuralnet,
)

# cheap planes only: no candidate-simulation or ladder features
ROLLOUT_FEATURES = ("board", "ones", "turns_since", "liberties")


class RolloutNet(nn.Module):
    """One 3×3 conv → point head; NHWC float32 planes in, float32 logits
    ``[B, N]`` out (``head="bias"``: the legacy per-position bias)."""

    def __init__(self, board: int = 19, input_planes: int = 20,
                 filters: int = 32, head: str = "fcn",
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(input_planes, filters, 3, padding=1)
        self.head = PointHead(filters, board, head, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(F.conv2d(x, self.conv1.weight.to(self.dtype),
                            self.conv1.bias.to(self.dtype), padding=1))
        return self.head(x)


@neuralnet
class CNNRollout(PointPolicyEval, NeuralNetBase):
    """Fast policy for MCTS rollouts (the policy's evaluation API)."""

    def __init__(self, feature_list=ROLLOUT_FEATURES, **kwargs):
        kwargs.setdefault("head", "fcn")   # recorded in saved specs
        super().__init__(feature_list, **kwargs)

    @staticmethod
    def create_network(board: int = 19, input_planes: int = 20,
                       filters: int = 32, head: str = "fcn",
                       dtype=torch.bfloat16) -> RolloutNet:
        return RolloutNet(board=board, input_planes=input_planes,
                          filters=filters, head=head, dtype=dtype)

    @classmethod
    def migrate_spec(cls, spec: dict) -> dict:
        """Rollout specs written before the ``head`` kwarg carried the
        per-position bias -- load them as the legacy head."""
        spec.setdefault("kwargs", {}).setdefault("head", "bias")
        return spec

    def size_generic(self) -> bool:
        return self.module.head.head == "fcn"
