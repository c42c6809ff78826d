"""Feature-encoder API: the reference's ``Preprocess`` contract on
tensors (scratch encode only; the incremental encoder waits for a
later slice).

Planes are NHWC ``[B, size, size, F]`` float32, like the reference's.
States are the batched :class:`~..engine.torchgo.GoState` (use
``torchgo.from_pygo`` at host boundaries).
"""

from __future__ import annotations

import functools

import torch

from rocalphago_tpu_torch.device import resolve_device
from rocalphago_tpu_torch.engine.torchgo import GoConfig, GoState
from rocalphago_tpu_torch.features.planes import encode
from rocalphago_tpu_torch.features.pyfeatures import (
    DEFAULT_FEATURES,
    FEATURE_PLANES,
    output_planes,
)


class Preprocess:
    """Batched encoder over a fixed feature list and board config, on
    one device (CUDA unless ``device`` names another).

    Ladder capacity: ``ladder_depth`` rungs per read (default 40),
    ``ladder_lanes`` candidates per plane (16) and ``ladder_chase_slots``
    chases per encode, shared by both ladder planes (6); chases beyond
    the slots read the conservative False -- the reference's contract.
    """

    def __init__(self, feature_list=DEFAULT_FEATURES,
                 cfg: GoConfig = GoConfig(), ladder_depth: int = 40,
                 ladder_lanes: int = 16, ladder_chase_slots: int = 6,
                 device=None):
        unknown = [f for f in feature_list if f not in FEATURE_PLANES]
        if unknown:
            raise KeyError(f"unknown features: {unknown}")
        if not feature_list:
            raise ValueError("feature_list must name at least one feature")
        self.feature_list = tuple(feature_list)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.output_dim = output_planes(self.feature_list)
        self._encode = functools.partial(
            encode, cfg, features=self.feature_list,
            ladder_depth=ladder_depth, ladder_lanes=ladder_lanes,
            ladder_chase_slots=ladder_chase_slots)

    def _on_device(self, states: GoState) -> GoState:
        return GoState(*(x.to(self.device) for x in states))

    @torch.no_grad()
    def states_to_tensor(self, states: GoState) -> torch.Tensor:
        """Batched states → ``[B, size, size, F]`` on this device."""
        return self._encode(self._on_device(states))

    def state_to_tensor(self, state: GoState) -> torch.Tensor:
        """A batch of one state → ``[1, size, size, F]``."""
        if state.board.shape[0] != 1:
            raise ValueError("state_to_tensor takes a batch of one state")
        return self.states_to_tensor(state)
