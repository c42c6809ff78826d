"""SL/RL policy network: the port of ``models/policy.py``.

Conv trunk + 1×1 point head → logits ``[B, N]`` over board points (pass
is handled at the agent layer). ``dtype`` is the working type of the
convolutions -- bfloat16 by default, as in the reference -- and the
logits are float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from rocalphago_tpu_torch.features import DEFAULT_FEATURES
from rocalphago_tpu_torch.models.nn_util import (
    ConvTrunk,
    NeuralNetBase,
    PointHead,
    PointPolicyEval,
    neuralnet,
)


class PolicyNet(nn.Module):
    """Conv trunk → point head; NHWC float32 planes in, float32 logits
    ``[B, N]`` out. ``head="fcn"`` has no size-locked parameter;
    ``head="bias"`` is the legacy per-position bias."""

    def __init__(self, board: int = 19, input_planes: int = 48,
                 layers: int = 12, filters_per_layer: int = 128,
                 filter_width_1: int = 5, filter_width_K: int = 3,
                 head: str = "fcn", trunk_pool: int = 0,
                 dtype=torch.bfloat16):
        super().__init__()
        if trunk_pool:
            raise NotImplementedError(
                "global-pooling trunks are not ported yet")
        self.dtype = dtype
        self.trunk = ConvTrunk(input_planes, layers, filters_per_layer,
                               filter_width_1, filter_width_K, dtype)
        self.head = PointHead(filters_per_layer, board, head, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(x.permute(0, 3, 1, 2)))


@neuralnet
class CNNPolicy(PointPolicyEval, NeuralNetBase):
    """Move-probability network over board points."""

    def __init__(self, feature_list=DEFAULT_FEATURES, **kwargs):
        kwargs.setdefault("head", "fcn")   # recorded in saved specs
        super().__init__(feature_list, **kwargs)

    @staticmethod
    def create_network(board: int = 19, input_planes: int = 48,
                       layers: int = 12, filters_per_layer: int = 128,
                       filter_width_1: int = 5, filter_width_K: int = 3,
                       head: str = "fcn", trunk_pool: int = 0,
                       dtype=torch.bfloat16) -> PolicyNet:
        return PolicyNet(board=board, input_planes=input_planes,
                         layers=layers, filters_per_layer=filters_per_layer,
                         filter_width_1=filter_width_1,
                         filter_width_K=filter_width_K, head=head,
                         trunk_pool=trunk_pool, dtype=dtype)

    @classmethod
    def migrate_spec(cls, spec: dict) -> dict:
        """Policy specs written before the ``head`` kwarg carried the
        per-position bias param -- load them as the legacy head."""
        spec.setdefault("kwargs", {}).setdefault("head", "bias")
        return spec
