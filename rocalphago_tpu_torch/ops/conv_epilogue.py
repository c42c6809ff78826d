"""The epilogue of a trunk convolution -- its bias and ReLU, and their
backward: the CUDA kernel ``csrc/conv_epilogue.cu``, its plain PyTorch
versions, and the autograd seam :func:`conv_bias_relu` that
``models/nn_util.py::ConvTrunk`` calls for each of its convolutions.

Replaces no TPU kernel: XLA folds the bias and the ReLU into the
convolution on the TPU. The port leaves the convolution to cuDNN, which
takes no bias on PyTorch's path, so the epilogue was four at::native
passes over the activation (bias add, ReLU, the ReLU's gradient, the
bias gradient's sum); the kernel does it in two, one each way. Bound on
the card: bytes (568 MB forward and 852 MB backward a layer at the SL
benchmark's 2,048 x 192 x 19 x 19 bfloat16); see the note at the top of
``csrc/conv_epilogue.cu`` for the design.

* :func:`bias_relu_` -- ``z ← max(z + b, 0)`` in place, ``b`` rounded
  to ``z``'s type first and the sum rounded once, as
  ``relu(z + b.to(z.dtype))`` computes it.
* :func:`bias_relu_backward` -- ``(gz, grad_bias)``: ``gz = gy`` where
  ``y > 0``, else 0 (``threshold_backward``), and the float32 sum of
  ``gz`` over the batch and the points, deterministic (no atomics).

Both take float32 or bfloat16 ``[N, C, H, W]`` tensors and a bias in
the tensor's type or float32. A CPU tensor takes the plain version, in
any layout. A CUDA tensor launches the kernel, which reads the
channels_last layout alone: cuDNN writes it for the NHWC planes every
net takes (its ``x.permute(0, 3, 1, 2)``); anything else raises, and
there is no fallback. The kernel takes its bias in float32, which holds
a bfloat16 bias exactly.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rocalphago_tpu_torch.ops import _build

#: launches of the CUDA kernels in this process (one a forward, two a
#: backward); plain runs are not counted
launches = 0
#: this kernel's index in the per-thread launch counts
KERNEL = _build.SOURCES.index("conv_epilogue")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bias_relu_plain(z: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`bias_relu_`: PyTorch's bias add and
    ReLU, in place."""
    z.add_(bias.to(z.dtype).reshape(1, -1, 1, 1))
    return z.clamp_min_(0)


def bias_relu_backward_plain(gy: torch.Tensor, y: torch.Tensor):
    """Plain version of :func:`bias_relu_backward`."""
    gz = torch.ops.aten.threshold_backward(gy, y, 0)
    return gz, gz.sum(dim=(0, 2, 3), dtype=torch.float32)


def _rows(t: torch.Tensor) -> int:
    """The rows of channels the kernel reads ``t`` as (``N * H * W``);
    raises unless ``t`` is channels_last."""
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"conv_epilogue: strides {t.stride()} are not "
                         "channels_last")
    n, _, h, w = t.shape
    return n * h * w


def _check(t: torch.Tensor, what: str) -> None:
    if t.dim() != 4 or t.dtype not in _DTYPES:
        raise TypeError(f"conv_epilogue: {what} must be float32 or "
                        f"bfloat16 [N, C, H, W], got {t.dtype} "
                        f"{tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_epilogue: unsupported device {t.device}")


def _launch(err: int, kernels: int, owner=None) -> None:
    global launches
    if err != 0:
        raise RuntimeError(f"conv_epilogue kernel launch failed: CUDA error "
                           f"{err}")
    launches += kernels
    for _ in range(kernels):
        _build.count_launch(KERNEL, owner)


def _library():
    """The loaded library, its functions typed once; ``partial_rows``
    is the most rows of partial sums a backward launch writes."""
    lib = _build.library("conv_epilogue")
    if not hasattr(lib, "partial_rows"):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rocalphago_bias_relu.argtypes = [ptr, ptr, i32, i64, i32, ptr]
        lib.rocalphago_bias_relu_backward.argtypes = [
            ptr, ptr, ptr, ptr, i32, ptr, i32, i64, i32, ptr]
        for fn in (lib.rocalphago_bias_relu, lib.rocalphago_bias_relu_backward,
                   lib.rocalphago_conv_epilogue_partial_rows):
            fn.restype = i32
        lib.partial_rows = lib.rocalphago_conv_epilogue_partial_rows()
    return lib


def bias_relu_(z: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``z ← max(z + bias, 0)`` in place; returns ``z``."""
    _check(z, "z")
    c = z.shape[1]
    if bias.shape != (c,) or bias.device != z.device:
        raise ValueError(f"conv_epilogue: bias must be [{c}] on {z.device}, "
                         f"got {tuple(bias.shape)} on {bias.device}")
    if bias.dtype not in (z.dtype, torch.float32):
        raise TypeError(f"conv_epilogue: a {z.dtype} tensor takes a "
                        f"{z.dtype} or float32 bias, got {bias.dtype}")
    if z.device.type == "cpu":
        return bias_relu_plain(z, bias)
    rows = _rows(z)
    if z.numel() == 0:
        return z
    bias = bias.to(torch.float32).contiguous()
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().rocalphago_bias_relu(
            z.data_ptr(), bias.data_ptr(), _DTYPES[z.dtype], rows, c, stream)
    _launch(err, 1)
    return z


def bias_relu_backward(gy: torch.Tensor, y: torch.Tensor, owner=None):
    """``(gz, grad_bias)`` of :func:`bias_relu_` from its output ``y``
    and the gradient ``gy`` of that output: ``gz`` in ``y``'s type and
    layout, ``grad_bias`` float32 ``[C]``. A ``gy`` in another layout is
    copied into channels_last first. The launches count for the thread
    whose ``_build.launch_owner()`` is ``owner`` (default: this one)."""
    _check(y, "y")
    if gy.shape != y.shape or gy.dtype != y.dtype or gy.device != y.device:
        raise ValueError(f"conv_epilogue: gy {gy.dtype} {tuple(gy.shape)} "
                         f"does not match y {y.dtype} {tuple(y.shape)}")
    if y.device.type == "cpu":
        return bias_relu_backward_plain(gy, y)
    rows = _rows(y)
    gy = gy.contiguous(memory_format=torch.channels_last)
    c = y.shape[1]
    gz = torch.empty_like(y)
    grad_bias = torch.empty(c, dtype=torch.float32, device=y.device)
    if y.numel() == 0:
        return gz, grad_bias.zero_()
    lib = _library()
    partials = torch.empty((lib.partial_rows, c), dtype=torch.float32,
                           device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rocalphago_bias_relu_backward(
            gy.data_ptr(), y.data_ptr(), gz.data_ptr(), partials.data_ptr(),
            lib.partial_rows, grad_bias.data_ptr(), _DTYPES[y.dtype], rows,
            c, stream)
    _launch(err, 2, owner)
    return gz, grad_bias


class ConvBiasReLU(torch.autograd.Function):
    """``relu(conv2d(x, w.to(dtype), b.to(dtype)))`` with stride 1: the
    convolution by cuDNN with no bias, then :func:`bias_relu_` over its
    output; the backward :func:`bias_relu_backward`, then the
    convolution's own backward (``aten.convolution_backward``, the call
    autograd makes for ``conv2d``) for the gradients of ``x`` and ``w``
    that are needed. Gradients come back in the inputs' types; the
    bias's is summed in float32. The backward's launches count for the
    thread that ran the forward (autograd runs a CUDA backward on a
    thread of its own)."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding, dtype):
        w = weight.to(dtype)
        y = bias_relu_(F.conv2d(x, w, None, padding=padding), bias)
        ctx.save_for_backward(x, w, y)
        ctx.padding = list(padding)
        ctx.dtypes = (weight.dtype, bias.dtype)
        ctx.owner = _build.launch_owner()
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, y = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        gz, grad_bias = bias_relu_backward(gy, y, ctx.owner)
        gx = gw = None
        if need_x or need_w:
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gz, x, w, None, [1, 1], ctx.padding, [1, 1], False, [0, 0],
                1, [need_x, need_w, False])
        return (gx, gw.to(ctx.dtypes[0]) if need_w else None,
                grad_bias.to(ctx.dtypes[1]) if need_b else None, None, None)


def conv_bias_relu(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, padding, dtype) -> torch.Tensor:
    """One trunk convolution with its bias and ReLU, computed in
    ``dtype``: on the CPU the plain twin ``relu(conv2d(x, w, b))``; on
    the card the kernel, through :class:`ConvBiasReLU` where a gradient
    is wanted and on its own (nothing saved) where none is."""
    if x.device.type == "cpu":
        return F.relu(F.conv2d(x, weight.to(dtype), bias.to(dtype),
                               padding=padding))
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return ConvBiasReLU.apply(x, weight, bias, padding, dtype)
    return bias_relu_(F.conv2d(x, weight.to(dtype), None, padding=padding),
                      bias)
