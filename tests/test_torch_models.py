"""The port's nets and weight files against the reference's.

* ``params_from_flax`` carries fresh Flax params (both policy heads)
  onto the port's modules: float32 logits agree with the reference
  module cloned to float32 within ``FP32_ATOL`` (summation order only).
* The bfloat16 working type against the reference's own bfloat16
  module, within ``BF16_RTOL`` of the largest logit: bf16 keeps 8
  mantissa bits (a rounding is up to 2**-9 relative), and the two
  frameworks round at different points (torch adds the conv bias
  before rounding the conv output, Flax after).
* The stdlib msgpack reader returns exactly what
  ``flax.serialization.msgpack_restore`` does on both in-repo fixtures,
  and a spec the port saves loads in the reference.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rocalphago_tpu.models import CNNPolicy as RefPolicy
from rocalphago_tpu.models import NeuralNetBase as RefNet
from rocalphago_tpu.models.nn_util import masked_probs as ref_masked_probs
from rocalphago_tpu_torch.models import CNNPolicy, NeuralNetBase
from rocalphago_tpu_torch.models.nn_util import masked_probs
from rocalphago_tpu_torch.models.weights import (
    params_from_flax,
    params_to_flax,
    read_flax_msgpack,
)
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FP32_ATOL = 1e-4
BF16_RTOL = 2e-2
FIXTURES = ["results/zero_r5/target_compare/puct/policy.json",
            "benchmarks/tpu_extra_r3/p9.json"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def planes(batch, size, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((batch, size, size, 48)) < 0.3).astype(np.float32)


def ref_logits(module, params, x, dtype=jnp.float32):
    return np.asarray(module.clone(dtype=dtype).apply(params, x))


def port_net(head, dtype=torch.float32):
    return CNNPolicy(board=5, layers=3, filters_per_layer=8, head=head,
                     init_weights=False, device="cpu", dtype=dtype)


def fresh_reference(head):
    ref = RefPolicy(board=5, layers=3, filters_per_layer=8, head=head,
                    seed=3)
    params = jax.tree.map(np.asarray, ref.params)
    if head == "bias":   # a non-zero bias, so the mapping is tested
        pb = params["params"]["head"]["position_bias"]
        params["params"]["head"]["position_bias"] = np.random.default_rng(
            1).normal(size=pb.shape).astype(np.float32)
    return ref, params


@pytest.mark.parametrize("head", ["fcn", "bias"])
def test_params_from_flax_fp32(head):
    ref, params = fresh_reference(head)
    net = port_net(head)
    net.module.load_state_dict(params_from_flax(params))
    x = planes(4, 5)
    want = ref_logits(ref.module, params, x)
    got = net.forward(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)
    assert (got.argmax(1) == want.argmax(1)).all()
    # and back: the state dict maps onto the same Flax tree
    back = params_to_flax(net.module.state_dict())
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("head", ["fcn", "bias"])
def test_bf16_working_type(head):
    ref, params = fresh_reference(head)
    net = port_net(head, dtype=torch.bfloat16)
    net.module.load_state_dict(params_from_flax(params))
    x = planes(4, 5, seed=1)
    want = ref_logits(ref.module, params, x, dtype=jnp.bfloat16)
    got = net.forward(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= BF16_RTOL * scale


@pytest.mark.parametrize("spec", FIXTURES)
def test_msgpack_reader_matches_flax(spec):
    path = os.path.join(ROOT, spec)
    with open(path) as f:
        weights = os.path.join(os.path.dirname(path),
                               json.load(f)["weights_file"])
    with open(weights, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got = read_flax_msgpack(weights)
    w = jax.tree_util.tree_leaves_with_path(want)
    g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in w] == [p for p, _ in g]
    for (_, a), (_, b) in zip(w, g):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", FIXTURES)
def test_fixture_logits_match(spec):
    path = os.path.join(ROOT, spec)
    ref = RefNet.load_model(path)
    net = NeuralNetBase.load_model(path, device="cpu", dtype=torch.float32)
    assert net.module.head.head == "bias"      # migrate_spec: legacy head
    x = planes(8, 9, seed=2)
    want = ref_logits(ref.module, ref.params, x)
    got = net.forward(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)
    assert (got.argmax(1) == want.argmax(1)).all()


def test_saved_spec_loads_in_the_reference(tmp_path):
    net = CNNPolicy(board=5, layers=3, filters_per_layer=8, seed=4,
                    device="cpu", dtype=torch.float32)
    spec = str(tmp_path / "policy.json")
    net.save_model(spec)
    ref = RefNet.load_model(spec)
    again = NeuralNetBase.load_model(spec, device="cpu",
                                     dtype=torch.float32)
    x = planes(2, 5, seed=5)
    got = net.forward(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(
        again.forward(torch.as_tensor(x)).numpy(), got)
    np.testing.assert_allclose(ref_logits(ref.module, ref.params, x), got,
                               rtol=0, atol=FP32_ATOL)


def test_masked_probs_matches_reference():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(5, 81)).astype(np.float32)
    legal = rng.random((5, 81)) < 0.5
    legal[4] = False                     # all-illegal row → zeros
    want = np.asarray(ref_masked_probs(logits, legal))
    got = masked_probs(torch.as_tensor(logits),
                       torch.as_tensor(legal)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert not got[4].any()


def test_pad_bucket():
    for b, want in ((1, 8), (8, 8), (9, 16), (33, 64)):
        padded, real = NeuralNetBase._pad_bucket(torch.ones((b, 2, 2, 1)))
        assert padded.shape[0] == want and real == b
        assert padded[b:].sum() == 0
