"""The frozen FLOP counts of the configuration, against the hand
reckoning: 2·k²·Cin·Cout a point forward, a step three times that less
the first layer's input gradient."""

import json
import os

from portbench.counts import nets, peaks

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name):
    return json.load(open(os.path.join(PKG, "configs", f"{name}.json")))


def _hand(cin, layers, k, points=361):
    first = 2 * 5 * 5 * cin * k * points
    rest = (layers - 2) * 2 * 3 * 3 * k * k * points
    head = 2 * k * points
    return first, first + rest + head


def test_policy_forward_and_step():
    net = _config("alphago-policy-192")["policy"]
    first, fwd = _hand(48, 13, 192)
    layers = nets.policy_layers(net)
    assert nets.forward_flops(layers) == fwd
    assert nets.train_step_flops(layers) == 3 * fwd - first
    assert round(nets.forward_flops(layers) / 1e9, 2) == 2.80
    assert round(nets.train_step_flops(layers) / 1e9, 2) == 8.24


def test_peaks():
    assert peaks.BF16_FLOPS_PER_S == 989e12
    assert peaks.HBM_BYTES_PER_S == 3.35e12
