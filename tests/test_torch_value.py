"""The port's value net (``rocalphago_tpu_torch/models/value.py``)
against the reference's.

* The committed 9×9 value net (a spec without ``head``: the legacy
  dense head through ``migrate_spec``) loads in both packages; in
  float32 its values agree within ``VALUE_ATOL`` on random planes and,
  through ``batch_eval_state``, on seeded random positions.
* A fresh reference FCN net with both aux heads, carried across as
  numpy through ``params_from_flax``, agrees within the same tolerance;
  ``params_to_flax`` gives back the same tree, and a spec the port
  saves loads in the reference.

Tolerance: 1e-5 absolute on a tanh output -- the two frameworks sum
the float32 convolutions and dense products in different orders.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.models import CNNValue as RefValue
from rocalphago_tpu.models import NeuralNetBase as RefNet
from rocalphago_tpu_torch.models import CNNValue, NeuralNetBase
from rocalphago_tpu_torch.models.weights import (
    params_from_flax,
    params_to_flax,
)
from torch_port_helpers import one_torch_thread, random_games  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

VALUE_ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(ROOT, "results/zero_r5/target_compare/puct/value.json")


def planes(batch, size, seed=0, feats=49):
    rng = np.random.default_rng(seed)
    return (rng.random((batch, size, size, feats)) < 0.3).astype(np.float32)


def ref_float32(ref):
    """The reference net with its module cloned to float32 (and its
    jitted apply rebuilt on it)."""
    ref.module = ref.module.clone(dtype=jnp.float32)
    ref._apply = jax.jit(ref.module.apply)
    return ref


def test_committed_dense_value_net():
    with jax.enable_checks(False):
        ref = ref_float32(RefNet.load_model(SPEC))
        net = NeuralNetBase.load_model(SPEC, device="cpu",
                                       dtype=torch.float32)
        assert net.module.head == "dense" and not net.size_generic()
        x = planes(8, 9, seed=1)
        want = np.asarray(ref.forward(x))
        got = net.forward(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_ATOL)
        # positions through the port's encoder (its planes are the
        # reference's bit for bit, tests/test_torch_features.py), so the
        # reference's encoder need not be compiled here
        sts = random_games(9, 6, 0, 50, seed=3)
        encoded = net._states_to_planes(sts).numpy()
        want = np.asarray(ref.forward(encoded))
    got = net.batch_eval_state(sts)
    assert got.dtype == np.float32 and got.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_ATOL)
    assert net.eval_state(sts[0]) == pytest.approx(float(got[0]), abs=1e-7)


def test_fresh_fcn_net_with_aux_heads(tmp_path):
    kw = dict(board=5, layers=3, filters_per_layer=8, dense_units=16,
              head_filters=4, aux_heads=("ownership", "score"))
    with jax.enable_checks(False):
        ref = ref_float32(RefValue(seed=5, **kw))
        params = jax.tree.map(np.asarray, ref.params)
        x = planes(4, 5, seed=2)
        want = np.asarray(ref.forward(x))
    net = CNNValue(init_weights=False, device="cpu", dtype=torch.float32,
                   **kw)
    assert net.module.head == "fcn" and net.size_generic()
    net.module.load_state_dict(params_from_flax(params))
    got = net.forward(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_ATOL)
    assert np.abs(want).max() > 1e-3     # a value that tests something

    back = params_to_flax(net.module.state_dict())
    w = jax.tree_util.tree_leaves_with_path(params)
    g = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in w] == [p for p, _ in g]
    for (_, a), (_, b) in zip(w, g):
        np.testing.assert_array_equal(a, b)

    spec = str(tmp_path / "value.json")
    net.save_model(spec)
    with jax.enable_checks(False):
        again = ref_float32(RefNet.load_model(spec))
        np.testing.assert_allclose(np.asarray(again.forward(x)), got,
                                   rtol=0, atol=VALUE_ATOL)
    assert NeuralNetBase.load_model(spec, device="cpu").module.head == "fcn"
