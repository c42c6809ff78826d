"""The trunk convolution's epilogue (``ops/conv_epilogue.py``) on the CPU.

* :func:`conv_bias_relu`, the seam ``ConvTrunk`` calls: on the CPU it
  is the plain twin ``relu(conv2d(x, w, b))``, bit for bit in the
  output and in the gradients of ``x``, ``w`` and ``b``, for float32
  and bfloat16, channels_last and contiguous NCHW, ``x`` with and
  without a gradient, and under ``no_grad``.
* :class:`ConvBiasReLU`, the autograd function the card takes, run
  here through the plain versions of the kernels: its output and the
  gradients of ``x`` and ``w`` are those of ``relu(conv2d(x, w) + b)``
  bit for bit; its bias gradient, summed in float32, lies within
  float32 reordering of the float64 sum and no further from it than
  autograd's.
* The wrappers' checks, the layout the kernel reads (channels_last
  alone; contiguous NCHW works on the CPU's plain path and raises for
  the kernel), and one call of the seam for every convolution of a
  trunk.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
"""

import pytest
import torch
import torch.nn.functional as F

from rocalphago_tpu_torch.models import CNNPolicy, nn_util
from rocalphago_tpu_torch.ops import conv_epilogue
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LAYOUTS = {"channels_last": torch.channels_last,
           "nchw": torch.contiguous_format}


def inputs(dtype, layout, x_grad, seed=0, batch=3, cin=5, cout=8, size=7,
           width=3):
    """Seeded ``x`` (in ``dtype`` and ``layout``), float32 ``w`` and
    ``b`` that require gradients, and an upstream gradient ``gy`` in the
    layout."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, cin, size, size, generator=g).to(dtype)
    x = x.contiguous(memory_format=layout).requires_grad_(x_grad)
    w = torch.randn(cout, cin, width, width, generator=g).mul_(0.3)
    b = torch.randn(cout, generator=g).mul_(0.5)
    gy = torch.randn(batch, cout, size, size, generator=g).to(dtype)
    return (x, w.requires_grad_(), b.requires_grad_(),
            gy.contiguous(memory_format=layout))


def grads(out, gy, *leaves):
    wanted = [t for t in leaves if t.requires_grad]
    got = iter(torch.autograd.grad(out, wanted, gy))
    return [next(got) if t.requires_grad else None for t in leaves]


def assert_bits(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                       else a.view(torch.int32),
                       b.view(torch.int16) if b.dtype == torch.bfloat16
                       else b.view(torch.int32)), what


@pytest.mark.parametrize("mode", ["x_grad", "x_no_grad", "no_grad"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv_bias_relu_on_the_cpu_is_the_plain_twin(dtype, layout, mode):
    dt = DTYPES[dtype]
    x, w, b, gy = inputs(dt, LAYOUTS[layout], x_grad=mode == "x_grad")
    pad = (1, 1)
    if mode == "no_grad":
        with torch.no_grad():
            got = conv_epilogue.conv_bias_relu(x, w, b, pad, dt)
            want = F.relu(F.conv2d(x, w.to(dt), b.to(dt), padding=pad))
        assert not got.requires_grad
        assert_bits(got, want, "y")
        return
    got = conv_epilogue.conv_bias_relu(x, w, b, pad, dt)
    want = F.relu(F.conv2d(x, w.to(dt), b.to(dt), padding=pad))
    assert_bits(got, want, "y")
    for name, a, c in zip("xwb", grads(got, gy, x, w, b),
                          grads(want, gy, x, w, b)):
        assert_bits(a, c, f"grad {name}")


@pytest.mark.parametrize("x_grad", [True, False])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_the_autograd_function_through_the_plain_kernels(dtype, layout,
                                                         x_grad):
    dt = DTYPES[dtype]
    x, w, b, gy = inputs(dt, LAYOUTS[layout], x_grad, seed=1, batch=4,
                         cout=16)
    pad = (1, 1)
    before = conv_epilogue.launches
    got = conv_epilogue.ConvBiasReLU.apply(x, w, b, pad, dt)
    z = F.conv2d(x, w.to(dt), None, padding=pad)
    want = F.relu(z + b.to(dt).reshape(1, -1, 1, 1))
    assert_bits(got, want, "y")
    gx, gw, gb = grads(got, gy, x, w, b)
    wx, ww, wb = grads(want, gy, x, w, b)
    assert_bits(gx, wx, "grad x")
    assert_bits(gw, ww, "grad w")
    assert conv_epilogue.launches == before      # plain runs count none
    # the bias gradient: float32 sums of the same gz, in another order
    # than autograd's; against the float64 sum of gz
    gz = torch.ops.aten.threshold_backward(gy, want.detach(), 0)
    exact = gz.double().sum(dim=(0, 2, 3))
    assert gb.dtype == torch.float32
    tol = 1e-6 * gz.double().abs().sum(dim=(0, 2, 3)) + 1e-30
    assert ((gb.double() - exact).abs() <= tol).all()
    assert ((gb.double() - exact).abs()
            <= (wb.double() - exact).abs() + tol).all()


def test_the_plain_forward_rounds_the_bias_then_the_sum():
    g = torch.Generator().manual_seed(2)
    z = torch.randn(2, 6, 5, 5, generator=g).to(torch.bfloat16)
    z[0, 0, 0, :3] = torch.tensor([float("nan"), -0.0, 0.0])
    b = torch.randn(6, generator=g) * 1e-2 + 1.0 / 3
    b[0] = 0.0
    want = torch.relu(z + b.to(torch.bfloat16).reshape(1, -1, 1, 1))
    for bias in (b, b.to(torch.bfloat16)):
        got = conv_epilogue.bias_relu_(z.clone(), bias)
        assert_bits(got, want, str(bias.dtype))
    assert torch.isnan(want[0, 0, 0, 0])


def test_the_wrappers_refuse_what_the_kernel_does_not_take():
    z = torch.zeros(2, 4, 3, 3)
    with pytest.raises(TypeError):
        conv_epilogue.bias_relu_(z.half(), torch.zeros(4))
    with pytest.raises(TypeError):
        conv_epilogue.bias_relu_(z[0], torch.zeros(4))
    with pytest.raises(ValueError):
        conv_epilogue.bias_relu_(z, torch.zeros(3))
    with pytest.raises(TypeError):
        conv_epilogue.bias_relu_(z, torch.zeros(4, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        conv_epilogue.bias_relu_(z.bfloat16(), torch.zeros(4).double())
    with pytest.raises(ValueError):
        conv_epilogue.bias_relu_(z.to("meta"), torch.zeros(4, device="meta"))
    with pytest.raises(ValueError):
        conv_epilogue.bias_relu_backward(z.bfloat16(), z)
    with pytest.raises(ValueError):
        conv_epilogue.bias_relu_backward(z[:1], z)


def test_the_layouts_the_kernel_reads():
    """The kernel reads channels_last alone, as N * H * W rows of C."""
    x = torch.zeros(2, 4, 3, 3)
    assert conv_epilogue._rows(
        x.contiguous(memory_format=torch.channels_last)) == 18
    # the trunk's input: NHWC planes seen as NCHW
    assert conv_epilogue._rows(x.permute(0, 2, 3, 1).contiguous()
                               .permute(0, 3, 1, 2)) == 18
    # one channel, or one point: both layouts are one, read as rows
    assert conv_epilogue._rows(torch.zeros(2, 1, 3, 3)) == 18
    assert conv_epilogue._rows(torch.zeros(5, 4, 1, 1)) == 5
    for other in (x, x.transpose(2, 3), x[:, :, :, :2]):
        with pytest.raises(ValueError):
            conv_epilogue._rows(other)


def test_the_trunk_calls_the_seam_for_each_convolution(monkeypatch):
    calls = []
    real = nn_util.conv_bias_relu

    def spy(x, weight, bias, padding, dtype):
        calls.append((tuple(weight.shape), tuple(padding), dtype))
        return real(x, weight, bias, padding, dtype)

    monkeypatch.setattr(nn_util, "conv_bias_relu", spy)
    net = CNNPolicy(("board", "ones"), board=7, layers=4,
                    filters_per_layer=8, device="cpu", dtype=torch.float32)
    planes = torch.zeros(2, 7, 7, net.preprocess.output_dim)
    net.forward(planes)
    assert calls == [((8, 4, 5, 5), (2, 2), torch.float32)] + [
        ((8, 8, 3, 3), (1, 1), torch.float32)] * 2
