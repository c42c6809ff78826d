"""FLOPs of the nets, from a configuration's shapes alone.

A convolution costs ``2 · k² · Cin · Cout`` per board point forward. A training step's backward costs twice the
forward, less the first layer's input gradient, which no one needs
(the count the repository's chip smoke used for its MFU shares).
"""

from __future__ import annotations


def trunk_convs(net: dict) -> list[tuple[int, int, int]]:
    """``(Cin, Cout, k)`` of the trunk's ``layers - 1`` convolutions."""
    convs = net["layers"] - 1
    k = net["filters_per_layer"]
    widths = [net["filter_width_1"]] + [net["filter_width_K"]] * (convs - 1)
    chans = [net["input_planes"]] + [k] * (convs - 1)
    return [(c, k, w) for c, w in zip(chans, widths)]


def policy_layers(net: dict) -> list[float]:
    """Forward FLOPs per position of each layer of a policy net: the
    trunk, then the 1×1 point head."""
    points = net["board"] ** 2
    convs = trunk_convs(net) + [(net["filters_per_layer"], 1, 1)]
    return [2.0 * cin * cout * k * k * points for cin, cout, k in convs]


def forward_flops(layers: list[float]) -> float:
    return sum(layers)


def train_step_flops(layers: list[float]) -> float:
    """Forward and backward FLOPs per position of a training step."""
    return 3 * sum(layers) - layers[0]
