"""Plain float32 AlphaGo nets (Silver et al. 2016, Methods), written
from the paper: no kernels, no caches, no program code.

Policy: a 5×5 convolution and ``layers - 2`` 3×3 convolutions of ``k``
filters with ReLU, SAME padding, on NHWC planes; a 1×1 convolution to
one plane and a bias per board point; logits over the points.

Weights are a dict of named float32 leaves (convolution kernels OIHW)
made by :func:`make_weights` from one
draw on a generator, so the benchmark can give the program the same
values without the reference reading anything the program made.

``quant="fp8"`` is the control, the precision below the configuration's
bfloat16: every convolution reads its input and its
kernel rounded to float8 e4m3 with one scale per tensor, and the
gradient flowing back into each input is rounded to e5m2.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: standard deviation of every bias and of the per-point policy bias
BIAS_STD = 0.1
#: the largest magnitudes float8 e4m3 and e5m2 hold
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _trunk_leaves(net: dict) -> list[tuple[str, tuple, float]]:
    k = net["filters_per_layer"]
    convs = net["layers"] - 1
    widths = [net["filter_width_1"]] + [net["filter_width_K"]] * (convs - 1)
    chans = [net["input_planes"]] + [k] * (convs - 1)
    out = []
    for i, (cin, w) in enumerate(zip(chans, widths)):
        out.append((f"conv{i}.w", (k, cin, w, w),
                    math.sqrt(2.0 / (cin * w * w))))
        out.append((f"conv{i}.b", (k,), BIAS_STD))
    return out


def policy_leaves(net: dict) -> list[tuple[str, tuple, float]]:
    """``(name, shape, std)`` of every leaf of the policy net, in the
    order :func:`make_weights` draws them."""
    k, n = net["filters_per_layer"], net["board"] ** 2
    return _trunk_leaves(net) + [
        ("head.w", (1, k, 1, 1), math.sqrt(2.0 / k)),
        ("head.b", (1,), BIAS_STD),
        ("head.point_bias", (n,), BIAS_STD)]


def make_weights(leaves, generator: torch.Generator) -> dict:
    """Every leaf from one standard-normal draw on ``generator``'s
    device, scaled by its standard deviation."""
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    flat = torch.randn(sum(sizes), generator=generator,
                       device=generator.device, dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, std), size in zip(leaves, sizes):
        out[name] = (flat[at:at + size] * std).reshape(shape)
        at += size
    return out


def _scaled(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under one scale per tensor
    (its largest magnitude mapped to ``top``), back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Float8(torch.autograd.Function):
    """Forward: the input in e4m3. Backward: the gradient in e5m2 (the
    usual float8 training recipe), or passed unchanged for a kernel,
    whose gradient the optimizer takes."""

    @staticmethod
    def forward(ctx, x, grad_in_e5m2: bool):
        ctx.grad_in_e5m2 = grad_in_e5m2
        return _scaled(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_in_e5m2:
            g = _scaled(g, torch.float8_e5m2, E5M2_MAX)
        return g, None


def quantize(x: torch.Tensor, quant: str | None,
             activation: bool = True) -> torch.Tensor:
    """``x`` as a layer reads it: unchanged, or (``quant="fp8"``) in
    float8 e4m3 with its gradient in e5m2 (an activation) or unchanged
    (a kernel)."""
    if quant is None:
        return x
    if quant != "fp8":
        raise ValueError(f"unknown precision {quant!r}")
    return _Float8.apply(x, activation)


def _conv(x, w, b, quant):
    return F.conv2d(quantize(x, quant), quantize(w, quant, False), b,
                    padding=w.shape[-1] // 2)


def trunk(weights: dict, planes: torch.Tensor, net: dict,
          quant: str | None = None) -> torch.Tensor:
    """NHWC planes → NCHW features of the last convolution."""
    x = planes.float().permute(0, 3, 1, 2)
    for i in range(net["layers"] - 1):
        x = F.relu(_conv(x, weights[f"conv{i}.w"], weights[f"conv{i}.b"],
                         quant))
    return x


def policy_logits(weights: dict, planes: torch.Tensor, net: dict,
                  quant: str | None = None) -> torch.Tensor:
    """float32 logits ``[B, N]`` over the board points."""
    x = _conv(trunk(weights, planes, net, quant), weights["head.w"],
              weights["head.b"], quant)
    return x.reshape(x.shape[0], -1) + weights["head.point_bias"]
