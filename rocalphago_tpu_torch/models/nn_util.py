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

import copy
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
from rocalphago_tpu_torch.training.symmetries import (
    inverse_transform_planes,
    transform_planes,
)

NEURALNETS: dict[str, type] = {}

# the reference's model-spec format version (param-tree layout)
SPEC_FORMAT = 2


class GlobalPoolBias(nn.Module):
    """KataGo-style global-pooling bias block: a 1×1 conv projects the
    trunk to ``pool_filters`` channels (ReLU), their board-wide mean and
    max are concatenated, and a dense layer maps those ``2 ·
    pool_filters`` scalars back to one bias per trunk channel, added at
    every point. No parameter shape depends on the board. NCHW in and
    out; computes in ``dtype``."""

    def __init__(self, channels: int, pool_filters: int = 32,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.pool_conv = nn.Conv2d(channels, pool_filters, 1)
        self.pool_dense = nn.Linear(2 * pool_filters, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = F.relu(F.conv2d(x, self.pool_conv.weight.to(self.dtype),
                            self.pool_conv.bias.to(self.dtype)))
        pooled = torch.cat([g.mean(dim=(2, 3)), g.amax(dim=(2, 3))], dim=-1)
        bias = F.linear(pooled, self.pool_dense.weight.to(self.dtype),
                        self.pool_dense.bias.to(self.dtype))
        return x + bias[:, :, None, None]


class ConvTrunk(nn.Module):
    """The AlphaGo conv trunk: ``layers - 1`` convolutions, a
    ``filter_width_1`` first one and then ``filter_width_K``, ReLU, SAME
    padding (symmetric, ``width // 2``); at ``layers=1`` it is empty, as
    in the reference. Computes in ``dtype``; NCHW in and out, with
    ``out_channels`` channels out.

    ``global_pool=g > 0`` puts :class:`GlobalPoolBias` blocks
    (``gpool1..gpoolG``) after the convolutions ``(j + 1) · convs // (g
    + 1)``, ``j < g``, as the reference does; ``g = 0`` adds no
    module."""

    def __init__(self, input_planes: int, layers: int = 12,
                 filters_per_layer: int = 128, filter_width_1: int = 5,
                 filter_width_K: int = 3, dtype=torch.bfloat16,
                 global_pool: int = 0):
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
        # conv index (1-based) -> pooling block ordinal after it; as in
        # the reference, a block whose index is 0 or is taken by a later
        # block is never built
        pool_after = {(j + 1) * convs // (global_pool + 1): j + 1
                      for j in range(global_pool)}
        self.pool_after = {i: j for i, j in pool_after.items() if i >= 1}
        for j in self.pool_after.values():
            self.add_module(f"gpool{j}", GlobalPoolBias(
                self.out_channels, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i, conv in enumerate(self.convs):
            x = F.relu(F.conv2d(x, conv.weight.to(self.dtype),
                                conv.bias.to(self.dtype),
                                padding=conv.padding))
            j = self.pool_after.get(i + 1)
            if j is not None:
                x = getattr(self, f"gpool{j}")(x)
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

    @torch.no_grad()
    def forward_symmetric(self, planes: torch.Tensor) -> torch.Tensor:
        """The forward ensembled over the 8 board symmetries (the AlphaGo
        paper's evaluation-time averaging): the ``B`` positions under
        every element go through the net as one batch of ``8 · B``,
        each output is mapped back (``_symmetric_spec``), and the 8 are
        averaged."""
        planes = planes.to(self.device)
        b = planes.shape[0]
        t = torch.arange(8, device=self.device).repeat_interleave(b)
        out = self.module(transform_planes(planes.repeat(8, 1, 1, 1), t))
        per_transform, finalize = self._symmetric_spec()
        if per_transform is not None:
            out = per_transform(out, t)
        mean = out.reshape((8, b) + tuple(out.shape[1:])).mean(dim=0)
        return finalize(mean) if finalize is not None else mean

    def _symmetric_spec(self):
        """``(per_transform(out, t), finalize(mean))`` for
        :meth:`forward_symmetric`; either may be None."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support symmetry ensembling")

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

    # ---------------------------------------------------- other sizes

    def size_generic(self) -> bool:
        """Whether no parameter's shape depends on the board size (an
        FCN head). Subclasses with one override; the default is
        False."""
        return False

    def at_board(self, board: int) -> "NeuralNetBase":
        """This net at another board size, sharing this net's module
        (its parameters, by reference: nothing is copied), with its own
        ``GoConfig`` and ``Preprocess``. A size-locked head (legacy
        per-position bias or dense value head) raises ``ValueError``."""
        if board == self.board:
            return self
        if not self.size_generic():
            raise ValueError(
                f"{type(self).__name__} at board {self.board} has "
                "size-locked params (legacy dense/bias head) and cannot "
                f"be re-sized to {board}; rebuild or retrain with the FCN "
                "head")
        clone = type(self)(self.feature_list, board=board,
                           init_weights=False, device=self.device,
                           dtype=self.module.dtype, **self.spec_kwargs)
        clone.module = self.module
        return clone

    @staticmethod
    def create_network(**kwargs) -> nn.Module:
        raise NotImplementedError


def working_copy(module: nn.Module, state_dict=None) -> nn.Module:
    """A copy of ``module`` (with ``state_dict`` loaded, when given)
    whose convolution and dense parameters are cast once to the
    module's working type ``module.dtype``. The forward casts exactly
    those parameters to that type on every call, so the copy computes
    the same outputs bit for bit without the per-call casts; the serve
    pool keeps each params version so."""
    work = copy.deepcopy(module)
    if state_dict is not None:
        work.load_state_dict(state_dict)
    with torch.no_grad():
        for sub in work.modules():
            if isinstance(sub, (nn.Conv2d, nn.Linear)):
                sub.to(module.dtype)
    return work.eval()


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
    board points (``eval_state``, ``batch_eval_state``), shared by the
    policy and the rollout net. Mixed into a :class:`NeuralNetBase`
    subclass."""

    def _symmetric_spec(self):
        """Each transform's point probabilities mapped back, averaged,
        and returned as ``log p̄`` -- logits under the masked softmax
        (renormalising over the legal support gives the average back)."""
        s = self.board

        def per_transform(logits, t):
            probs = torch.softmax(logits, dim=-1).reshape(-1, s, s, 1)
            return inverse_transform_planes(probs, t).reshape(-1, s * s)

        return per_transform, lambda mean: torch.log(mean + 1e-30)

    def eval_state(self, state, moves=None):
        """Distribution over the legal moves of one state, ``[((x, y),
        prob), ...]``; ``moves`` (legal moves only) restricts the
        support."""
        return self.batch_eval_state(
            [state], [moves] if moves is not None else None)[0]

    def batch_eval_state(self, states, moves_lists=None,
                         symmetric: bool = False):
        """One encode, one forward and one masked softmax for the whole
        batch; ``moves_lists[i]``, when given, is state ``i``'s support
        verbatim. ``symmetric`` ensembles the forward over the 8 board
        symmetries (8× the net's work)."""
        states = self._as_state_list(states)
        return self.dists_from_planes(
            states, self._states_to_planes(states), moves_lists,
            symmetric=symmetric)

    def dists_from_planes(self, states, planes, moves_lists=None,
                          symmetric: bool = False):
        """As :meth:`batch_eval_state`, from already-encoded planes (the
        seam that lets one encode feed two nets)."""
        planes, b = self._pad_bucket(planes)
        logits = (self.forward_symmetric(planes) if symmetric
                  else self.forward(planes))
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
