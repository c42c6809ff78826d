"""Value network: the port of ``models/value.py``.

Conv trunk → value head → tanh scalar ``[B]`` from the player to
move's view. ``dtype`` is the working type of the trunk and the head
(bfloat16 by default, as in the reference); the value is float32.

Head variants (``head=``, recorded in saved specs):

* ``"fcn"`` (default) -- 1×1 conv to ``head_filters`` channels, ReLU,
  then the mean and the max over the board concatenated in that order,
  ``Dense(dense_units)``, ReLU, ``Dense(1)``; no parameter shape
  depends on the board size.
* ``"dense"`` -- the legacy size-locked head: a 1-channel 1×1 conv
  flattened over the board into ``Dense(dense_units)``. Specs saved
  before the ``head`` kwarg existed load as this (:meth:`CNNValue.
  migrate_spec`).

``trunk_pool=g`` puts ``g`` global-pooling bias blocks in the trunk
(:class:`~.nn_util.GlobalPoolBias`), as the reference's ladder-free
configuration does; ``symmetric=`` on the evaluation methods averages
the value over the 8 board symmetries.

Auxiliary heads (``aux_heads=("ownership", "score")``, KataGo's):
per-point terminal ownership (tanh ``[B, N]``, a 1×1 conv off the
trunk) and the final score margin (a dense layer off the penultimate
features), trained against the engine's terminal labels
(:func:`~rocalphago_tpu_torch.ops.labels.terminal_labels`). The plain
forward returns the value only and runs neither head; the training
forward ``module(x, with_aux=True)`` returns ``(value, {"ownership",
"score"})``. :func:`with_aux_heads` grafts fresh heads onto a net
without them, its value unchanged bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from rocalphago_tpu_torch.features import VALUE_FEATURES
from rocalphago_tpu_torch.models.nn_util import (
    ConvTrunk,
    NeuralNetBase,
    neuralnet,
)

AUX_HEADS = ("ownership", "score")


class ValueNet(nn.Module):
    """Conv trunk → value head; NHWC float32 planes in, float32 values
    ``[B]`` out."""

    def __init__(self, board: int = 19, input_planes: int = 49,
                 layers: int = 12, filters_per_layer: int = 128,
                 filter_width_1: int = 5, filter_width_K: int = 3,
                 dense_units: int = 256, head: str = "fcn",
                 head_filters: int = 32, aux_heads=(),
                 trunk_pool: int = 0, dtype=torch.bfloat16):
        super().__init__()
        if head not in ("fcn", "dense"):
            raise ValueError(f"unknown value head {head!r}")
        if not set(aux_heads) <= set(AUX_HEADS):
            raise ValueError(
                f"unknown aux heads {sorted(set(aux_heads) - set(AUX_HEADS))}"
                f"; supported: {sorted(AUX_HEADS)}")
        self.head = head
        self.aux_heads = tuple(aux_heads)
        self.dtype = dtype
        self.trunk = ConvTrunk(input_planes, layers, filters_per_layer,
                               filter_width_1, filter_width_K, dtype,
                               global_pool=trunk_pool)
        chans = self.trunk.out_channels
        if "ownership" in aux_heads:
            self.own_conv = nn.Conv2d(chans, 1, 1)
        if head == "dense":
            self.head_conv = nn.Conv2d(chans, 1, 1)
            self.dense1 = nn.Linear(board * board, dense_units)
        else:
            self.head_conv = nn.Conv2d(chans, head_filters, 1)
            self.dense1 = nn.Linear(2 * head_filters, dense_units)
        if "score" in aux_heads:
            self.score_dense = nn.Linear(dense_units, 1)
        self.dense2 = nn.Linear(dense_units, 1)

    def _linear(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, layer.weight.to(self.dtype),
                        layer.bias.to(self.dtype))

    def forward(self, x: torch.Tensor, with_aux: bool = False):
        """Values ``[B]``; with ``with_aux``, ``(values, {head:
        prediction})`` for the heads the net has."""
        t = self.trunk(x.permute(0, 3, 1, 2))
        aux = {}
        if with_aux and "ownership" in self.aux_heads:
            o = F.conv2d(t, self.own_conv.weight.to(self.dtype),
                         self.own_conv.bias.to(self.dtype))
            aux["ownership"] = torch.tanh(o.reshape(o.shape[0], -1).float())
        h = F.conv2d(t, self.head_conv.weight.to(self.dtype),
                     self.head_conv.bias.to(self.dtype))
        if self.head == "dense":
            h = h.reshape(h.shape[0], -1)
        else:
            h = F.relu(h)
            h = torch.cat([h.mean(dim=(2, 3)), h.amax(dim=(2, 3))], dim=-1)
        h = F.relu(self._linear(self.dense1, h))
        if with_aux and "score" in self.aux_heads:
            aux["score"] = self._linear(self.score_dense, h)[:, 0].float()
        value = torch.tanh(self._linear(self.dense2, h)[:, 0].float())
        return (value, aux) if with_aux else value


@neuralnet
class CNNValue(NeuralNetBase):
    """Scalar position evaluator over the 49-plane ``VALUE_FEATURES``
    (the 48 policy planes and the player colour)."""

    def __init__(self, feature_list=VALUE_FEATURES, **kwargs):
        kwargs.setdefault("head", "fcn")   # recorded in saved specs
        super().__init__(feature_list, **kwargs)

    @staticmethod
    def create_network(board: int = 19, input_planes: int = 49,
                       layers: int = 12, filters_per_layer: int = 128,
                       filter_width_1: int = 5, filter_width_K: int = 3,
                       dense_units: int = 256, head: str = "fcn",
                       head_filters: int = 32, aux_heads=(),
                       trunk_pool: int = 0,
                       dtype=torch.bfloat16) -> ValueNet:
        return ValueNet(board=board, input_planes=input_planes,
                        layers=layers, filters_per_layer=filters_per_layer,
                        filter_width_1=filter_width_1,
                        filter_width_K=filter_width_K,
                        dense_units=dense_units, head=head,
                        head_filters=head_filters,
                        aux_heads=tuple(aux_heads), trunk_pool=trunk_pool,
                        dtype=dtype)

    @classmethod
    def migrate_spec(cls, spec: dict) -> dict:
        """Value specs written before the ``head`` kwarg carried the
        size-locked flattened head -- load them as such."""
        spec.setdefault("kwargs", {}).setdefault("head", "dense")
        return spec

    def size_generic(self) -> bool:
        return self.module.head == "fcn"

    def _symmetric_spec(self):
        """The scalar value needs no inverse mapping: a plain mean."""
        return None, None

    def eval_state(self, state, symmetric: bool = False) -> float:
        """Expected outcome of one state from the player to move's
        view, in [-1, 1]."""
        return float(self.batch_eval_state([state], symmetric)[0])

    def batch_eval_state(self, states, symmetric: bool = False) -> np.ndarray:
        states = self._as_state_list(states)
        return self.values_from_planes(self._states_to_planes(states),
                                       symmetric=symmetric)

    def values_from_planes(self, planes: torch.Tensor,
                           symmetric: bool = False) -> np.ndarray:
        """Values of already-encoded planes, as float32 numpy ``[B]``;
        ``symmetric`` averages them over the 8 board symmetries."""
        planes, b = self._pad_bucket(planes)
        fwd = self.forward_symmetric if symmetric else self.forward
        return fwd(planes)[:b].cpu().numpy()

    @torch.no_grad()
    def forward_aux(self, planes: torch.Tensor):
        """``(values [B], {head: prediction})`` of encoded planes: the
        training-side forward of the auxiliary heads (:meth:`forward`
        keeps the value-only contract the search uses)."""
        return self.module(planes.to(self.device), with_aux=True)


def with_aux_heads(net: CNNValue, aux_heads=AUX_HEADS,
                   seed: int = 0) -> CNNValue:
    """A copy of ``net`` with auxiliary heads grafted on: the trunk and
    the value head are ``net``'s (copied, not shared), the new heads
    start from fresh weights drawn from ``seed``. The value output is
    ``net``'s bit for bit."""
    kwargs = dict(net.spec_kwargs)
    kwargs["aux_heads"] = tuple(aux_heads)
    grown = CNNValue(net.feature_list, board=net.board, seed=seed,
                     device=net.device, dtype=net.module.dtype, **kwargs)
    old = net.module.state_dict()
    merged = {k: (old[k].clone() if k in old else v)
              for k, v in grown.module.state_dict().items()}
    grown.module.load_state_dict(merged)
    return grown
