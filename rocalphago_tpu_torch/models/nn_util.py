"""Model base: JSON spec ⇄ network, registry, save/load, evaluation.

The port of ``models/nn_util.py``. A network is a torch ``nn.Module``
that takes the reference's NHWC planes ``[B, s, s, F]`` and permutes to
NCHW inside. The JSON spec (class name, feature list, board,
architecture kwargs, weights file) is the reference's, and the weights
file is the reference's Flax msgpack, read and written by
:mod:`.weights` -- a spec saved by either package loads in the other.

The trunk stays ``torch.nn.functional.conv2d``: the reference leaves
its convolutions to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from rocalphago_tpu_torch.device import resolve_device
from rocalphago_tpu_torch.engine import pygo, torchgo
from rocalphago_tpu_torch.features import DEFAULT_FEATURES, Preprocess
from rocalphago_tpu_torch.models.weights import (
    params_from_flax,
    params_to_flax,
    read_flax_msgpack,
    write_flax_msgpack,
)

NEURALNETS: dict[str, type] = {}

# the reference's model-spec format version (param-tree layout)
SPEC_FORMAT = 2


class ConvTrunk(nn.Module):
    """The AlphaGo conv trunk: ``layers - 1`` convolutions, a
    ``filter_width_1`` first one and then ``filter_width_K``, ReLU, SAME
    padding (symmetric, ``width // 2``); at ``layers=1`` it is empty, as
    in the reference. Computes in ``dtype``; NCHW in and out, with
    ``out_channels`` channels out."""

    def __init__(self, input_planes: int, layers: int = 12,
                 filters_per_layer: int = 128, filter_width_1: int = 5,
                 filter_width_K: int = 3, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        convs = layers - 1
        widths = ([filter_width_1] + [filter_width_K] * (convs - 1)
                  if convs > 0 else [])
        chans = [input_planes] + [filters_per_layer] * (convs - 1)
        self.out_channels = filters_per_layer if convs > 0 else input_planes
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, filters_per_layer, w, padding=w // 2)
            for cin, w in zip(chans, widths))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for conv in self.convs:
            x = F.relu(F.conv2d(x, conv.weight.to(self.dtype),
                                conv.bias.to(self.dtype),
                                padding=conv.padding))
        return x


class PointHead(nn.Module):
    """1×1 conv → flatten → float32 logits ``[B, N]``. ``head="bias"``
    (legacy) adds a per-position learned bias, which locks the params
    to one board size; ``head="fcn"`` does not."""

    def __init__(self, filters: int, board: int, head: str = "fcn",
                 dtype=torch.bfloat16):
        super().__init__()
        if head not in ("fcn", "bias"):
            raise ValueError(f"unknown policy head {head!r}")
        self.head = head
        self.dtype = dtype
        self.conv = nn.Conv2d(filters, 1, 1)
        if head == "bias":
            self.position_bias = nn.Parameter(torch.zeros(board * board))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x, self.conv.weight.to(self.dtype),
                     self.conv.bias.to(self.dtype))
        logits = x.reshape(x.shape[0], -1).float()
        if self.head == "bias":
            logits = logits + self.position_bias
        return logits


def neuralnet(cls):
    """Class decorator registering a network for spec-based loading."""
    NEURALNETS[cls.__name__] = cls
    return cls


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Fresh weights from ``generator``: conv kernels normal with
    variance 2/fan_in, dense kernels with variance 1/fan_in (Flax's
    default), biases zero."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                gain = 2.0 if isinstance(m, nn.Conv2d) else 1.0
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w * math.sqrt(gain / fan_in))
                m.bias.zero_()


class NeuralNetBase:
    """Holds the module, its :class:`Preprocess` and the spec. Runs on
    CUDA unless ``device`` names another device; ``dtype`` is the
    working type of the trunk (logits are float32)."""

    def __init__(self, feature_list=DEFAULT_FEATURES, *, board: int = 19,
                 init_weights: bool = True, seed: int = 0, device=None,
                 dtype=torch.bfloat16, **kwargs):
        self.device = resolve_device(device)
        self.cfg = torchgo.GoConfig(size=board)
        self.preprocess = Preprocess(feature_list, cfg=self.cfg,
                                     device=self.device)
        self.feature_list = tuple(feature_list)
        self.board = board
        self.spec_kwargs = dict(kwargs)
        self.module = self.create_network(
            board=board, input_planes=self.preprocess.output_dim,
            dtype=dtype, **kwargs)
        if init_weights:
            init_params(self.module, torch.Generator().manual_seed(seed))
        self.module.to(self.device).eval()

    @torch.no_grad()
    def forward(self, planes: torch.Tensor) -> torch.Tensor:
        """Logits of encoded planes ``[B, s, s, F]``."""
        return self.module(planes.to(self.device))

    def _states_to_planes(self, states) -> torch.Tensor:
        """Host ``pygo.GameState`` list, or a batched ``GoState`` →
        ``[B, s, s, F]``. Host states skip the per-state BFS; one
        labels launch refills the whole batch."""
        if isinstance(states, torchgo.GoState):
            return self.preprocess.states_to_tensor(states)
        if isinstance(states, pygo.GameState):
            states = [states]
        batched = torchgo.from_pygo(self.cfg, list(states),
                                    device=self.device, with_labels=False)
        batched = torchgo.seed_labels(self.cfg, batched)
        return self.preprocess.states_to_tensor(batched)

    @staticmethod
    def _pad_bucket(planes: torch.Tensor, min_bucket: int = 8):
        """Pad the batch up to the next power-of-two bucket (at least
        ``min_bucket``); returns ``(padded, real_batch)``."""
        b = planes.shape[0]
        bucket = min_bucket
        while bucket < b:
            bucket *= 2
        if bucket == b:
            return planes, b
        pad = planes.new_zeros((bucket - b,) + tuple(planes.shape[1:]))
        return torch.cat([planes, pad]), b

    @staticmethod
    def _as_state_list(states):
        if isinstance(states, pygo.GameState):
            return [states]
        return list(states)

    # ------------------------------------------------------ spec save/load

    def save_model(self, json_file: str, weights_file: str | None = None):
        """Write the JSON spec and the weights (beside it unless
        ``weights_file`` names the file)."""
        spec = {
            "class": type(self).__name__,
            "format": SPEC_FORMAT,
            "feature_list": list(self.feature_list),
            "board": self.board,
            "kwargs": self.spec_kwargs,
        }
        if weights_file is None:
            weights_file = os.path.splitext(json_file)[0] + ".flax.msgpack"
        spec["weights_file"] = os.path.relpath(
            weights_file, os.path.dirname(json_file) or ".")
        # weights first: a crash between the two never leaves a spec
        # pointing at a missing weights file
        self.save_weights(weights_file)
        tmp = f"{json_file}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(spec, f, indent=2)
        os.replace(tmp, json_file)

    def save_weights(self, weights_file: str):
        write_flax_msgpack(weights_file,
                           params_to_flax(self.module.state_dict()))

    def load_weights(self, weights_file: str):
        try:
            sd = params_from_flax(read_flax_msgpack(weights_file))
            self.module.load_state_dict(sd)
        except (ValueError, KeyError, RuntimeError) as e:
            raise ValueError(
                f"{weights_file} does not match this architecture's "
                "parameter tree: the file may belong to a different "
                "network class/size, or be corrupt or truncated. "
                f"Underlying error: {e}") from e

    @staticmethod
    def load_model(json_file: str, device=None,
                   dtype=torch.bfloat16) -> "NeuralNetBase":
        """Rebuild a registered network from its JSON spec, on CUDA
        unless ``device`` names another device."""
        with open(json_file) as f:
            spec = json.load(f)
        fmt = spec.get("format", SPEC_FORMAT)
        if fmt != SPEC_FORMAT:
            raise ValueError(
                f"{json_file} is model-spec format {fmt}, this build "
                f"reads format {SPEC_FORMAT}")
        cls = NEURALNETS.get(spec.get("class"))
        if cls is None:
            raise ValueError(
                f"unknown network class {spec.get('class')!r}; "
                f"registered: {sorted(NEURALNETS)}")
        spec = cls.migrate_spec(spec)
        net = cls(tuple(spec["feature_list"]), board=int(spec["board"]),
                  init_weights=False, device=device, dtype=dtype,
                  **spec.get("kwargs", {}))
        weights = spec.get("weights_file")
        if weights:
            net.load_weights(os.path.join(
                os.path.dirname(json_file) or ".", weights))
        return net

    @classmethod
    def migrate_spec(cls, spec: dict) -> dict:
        """Adjust an older spec before the network is rebuilt."""
        return spec

    @staticmethod
    def create_network(**kwargs) -> nn.Module:
        raise NotImplementedError


def masked_probs(logits: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Softmax over legal board points only (``legal`` bool ``[B,
    N]``); all-illegal rows return zeros."""
    neg = torch.finfo(logits.dtype).min
    masked = torch.where(legal, logits, neg)
    p = torch.where(legal, torch.softmax(masked, dim=-1), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    return torch.where(denom > 0, p / torch.clamp(denom, min=1e-30), 0.0)


def legal_moves_mask_host(state: pygo.GameState) -> np.ndarray:
    """Bool ``[N]`` legality over board points of a host state."""
    n = state.size * state.size
    mask = np.zeros((n,), bool)
    for (x, y) in state.get_legal_moves(include_eyes=True):
        mask[x * state.size + y] = True
    return mask


class PointPolicyEval:
    """Host-facing evaluation for nets whose output is logits over
    board points (``batch_eval_state``). Mixed into a
    :class:`NeuralNetBase` subclass. Symmetry ensembling waits for a
    later slice."""

    def batch_eval_state(self, states, moves_lists=None):
        """One encode, one forward and one masked softmax for the whole
        batch; ``moves_lists[i]``, when given, is state ``i``'s support
        verbatim."""
        states = self._as_state_list(states)
        return self.dists_from_planes(
            states, self._states_to_planes(states), moves_lists)

    def dists_from_planes(self, states, planes, moves_lists=None):
        """As :meth:`batch_eval_state`, from already-encoded planes."""
        planes, b = self._pad_bucket(planes)
        logits = self.forward(planes)
        size = self.board
        legal_rows = []
        for i, state in enumerate(states):
            if moves_lists is not None and moves_lists[i] is not None:
                legal = np.zeros((size * size,), bool)
                for (x, y) in moves_lists[i]:
                    legal[x * size + y] = True
            else:
                legal = legal_moves_mask_host(state)
            legal_rows.append(legal)
        legal_b = np.zeros((logits.shape[0], size * size), bool)
        legal_b[:b] = np.stack(legal_rows)   # padded rows: all-illegal
        probs = masked_probs(
            logits, torch.as_tensor(legal_b, device=logits.device)
        ).cpu().numpy()
        return [[((int(p) // size, int(p) % size), float(probs[i, p]))
                 for p in np.flatnonzero(legal_b[i])]
                for i in range(len(states))]
