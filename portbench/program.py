"""The system under test as the benchmark builds it: the port's nets
from a configuration's constructor arguments, given the benchmark's
weights. Imported only inside a run, after the card check."""

from __future__ import annotations

import re

import torch

from portbench.reference import nets as refnets

#: the program's parameter name of each reference leaf, by pattern
_POLICY_NAMES = ((r"conv(\d+)\.w", r"trunk.convs.\1.weight"),
                 (r"conv(\d+)\.b", r"trunk.convs.\1.bias"),
                 (r"head\.w", "head.conv.weight"),
                 (r"head\.b", "head.conv.bias"),
                 (r"head\.point_bias", "head.position_bias"))


def _program_name(table, ref_name: str) -> str:
    for pattern, repl in table:
        if re.fullmatch(pattern, ref_name):
            return re.sub(pattern, repl, ref_name)
    raise KeyError(ref_name)


def _kwargs(net: dict) -> dict:
    skip = ("input_planes", "dtype")
    kw = {k: v for k, v in net.items() if k not in skip}
    kw["dtype"] = getattr(torch, net["dtype"])
    return kw


def _load(module: torch.nn.Module, weights: dict, table) -> dict:
    """Copy ``weights`` into ``module``; returns the program's name of
    every reference leaf. Every parameter must be covered."""
    params = dict(module.named_parameters())
    names = {k: _program_name(table, k) for k in weights}
    missing = set(params) - set(names.values())
    if missing:
        raise KeyError(f"program parameters the benchmark does not set: "
                       f"{sorted(missing)}")
    with torch.no_grad():
        for ref, prog in names.items():
            params[prog].copy_(weights[ref])
    return names


def policy_net(net: dict, generator: torch.Generator, device):
    """``(CNNPolicy, weights, names)``: the port's policy net with the
    reference leaves drawn from ``generator`` (``names`` maps a leaf to
    the program's parameter)."""
    from rocalphago_tpu_torch.models import CNNPolicy

    model = CNNPolicy(init_weights=False, device=device, **_kwargs(net))
    weights = refnets.make_weights(refnets.policy_leaves(net), generator)
    names = _load(model.module, weights, _POLICY_NAMES)
    return model, weights, names
