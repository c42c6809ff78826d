"""The whole SGD step's share of the card's dense bfloat16 peak:
positions a second over the window, times the frozen FLOPs of a step
position (forward and backward), over 989 TFLOP/s."""

from portbench.counts import nets, peaks


def read(r):
    positions = r.counters.get("positions")
    if not positions:
        return None
    flops = nets.train_step_flops(nets.policy_layers(r.config["policy"]))
    rate = positions / r.counters["window_s"]
    return 100.0 * rate * flops / peaks.BF16_FLOPS_PER_S
