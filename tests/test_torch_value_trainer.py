"""The port's value trainer against the reference's.

* A float32 value step (FCN head; the reference module cloned to
  float32) with symmetries off and with the reference's own ``t``
  draws replayed, over 2 steps with momentum: MSE and every parameter
  within ``ATOL + RTOL·|x|``.
* A ``ValueTrainer`` run on a seeded outcome corpus (``"targets":
  "outcome"``, z in the ``actions`` slot, the layout
  ``training/selfplay_data.py`` writes): finite MSEs, the artifacts,
  the exported spec loadable by the reference, and ``evaluate``
  reporting the trainer's test MSE.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rocalphago_tpu.io.checkpoint import pack_rng, unpack_rng
from rocalphago_tpu.models import CNNValue as RefValue
from rocalphago_tpu.models import NeuralNetBase as RefNet
from rocalphago_tpu.training import value as ref_value
from rocalphago_tpu_torch.models import CNNValue, NeuralNetBase
from rocalphago_tpu_torch.models.weights import params_from_flax, params_to_flax
from rocalphago_tpu_torch.training import evaluate, sl, value
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 7
FEATURES = ("board", "ones", "color")
PLANES = 5
BATCH = 16
ATOL = 1e-5           # float32: summation order only
RTOL = 1e-4


def write_outcomes(prefix: str, n: int = 160, seed: int = 0) -> None:
    """A seeded outcome corpus: z = +1 when Black has more stones."""
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 2, (n, SIZE, SIZE, PLANES)).astype(np.uint8)
    z = np.where(states[..., 0].sum((1, 2)) > states[..., 1].sum((1, 2)),
                 1, -1).astype(np.int32)
    half = n // 2
    for i, part in enumerate((slice(0, half), slice(half, n))):
        np.savez_compressed(f"{prefix}-{i:05d}.npz", states=states[part],
                            actions=z[part])
    with open(f"{prefix}-manifest.json", "w") as f:
        json.dump({"board_size": SIZE, "komi": 7.5, "planes": PLANES,
                   "feature_list": list(FEATURES), "targets": "outcome",
                   "shard_counts": [half, n - half], "num_positions": n}, f)


def nets():
    ref = RefValue(FEATURES, board=SIZE, layers=3, filters_per_layer=8,
                   dense_units=16, head_filters=4, seed=5)
    port = CNNValue(FEATURES, board=SIZE, layers=3, filters_per_layer=8,
                    dense_units=16, head_filters=4, init_weights=False,
                    device="cpu", dtype=torch.float32)
    port.module.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, ref.params)))
    return ref, port


@pytest.mark.parametrize("symmetries", [False, True])
def test_value_steps_match_the_reference(symmetries):
    lr, momentum = 0.05, 0.9
    ref, port = nets()
    tx = optax.sgd(lr, momentum=momentum)
    step = jax.jit(ref_value.make_train_step(
        ref.module.clone(dtype=jnp.float32).apply, tx, symmetries))
    state = ref_value.ValueState(ref.params, tx.init(ref.params),
                                 jnp.int32(0), pack_rng(jax.random.key(4)))
    cfg = value.ValueConfig(learning_rate=lr, momentum=momentum)
    opt, lr_at = sl.make_optimizer(cfg, port.module.parameters())
    pstate = sl.TrainState(port.module, opt, torch.Generator())
    port_step = value.make_train_step(port.module, opt, lr_at, symmetries)
    rng = np.random.default_rng(1)
    for _ in range(2):
        planes = rng.integers(0, 2, (BATCH, SIZE, SIZE, PLANES)).astype(
            np.uint8)
        z = rng.choice([-1, 1], BATCH).astype(np.int32)
        _, sub = jax.random.split(unpack_rng(state.rng))
        t = np.array(jax.random.randint(sub, (BATCH,), 0, 8))
        state, m = step(state, jnp.asarray(planes), jnp.asarray(z))
        pstate, pm = port_step(pstate, torch.from_numpy(planes),
                               torch.from_numpy(z), t=torch.from_numpy(t))
        np.testing.assert_allclose(float(pm["mse"]), float(m["mse"]),
                                   rtol=RTOL, atol=ATOL)
    got = params_to_flax(port.module.state_dict())
    want = jax.tree.map(np.asarray, state.params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_value_eval_step_with_padded_weights():
    ref, port = nets()
    rng = np.random.default_rng(2)
    planes = rng.integers(0, 2, (BATCH, SIZE, SIZE, PLANES)).astype(np.uint8)
    z = rng.choice([-1, 1], BATCH).astype(np.int32)
    weights = np.r_[np.ones(10), np.zeros(6)].astype(np.float32)
    want = ref_value.make_eval_step(ref.module.clone(dtype=jnp.float32).apply)(
        ref.params, jnp.asarray(planes), jnp.asarray(z), jnp.asarray(weights))
    got = value.make_eval_step(port.module)(
        torch.from_numpy(planes), torch.from_numpy(z),
        torch.from_numpy(weights))
    np.testing.assert_allclose(float(got["mse"]), float(want["mse"]),
                               rtol=RTOL, atol=ATOL)
    assert float(got["count"]) == 10.0


def test_value_trainer_run_export_and_evaluate(tmp_path, capsys):
    prefix = str(tmp_path / "data" / "z")
    os.makedirs(tmp_path / "data")
    write_outcomes(prefix)
    out = tmp_path / "out"
    net = CNNValue(FEATURES, board=SIZE, layers=2, filters_per_layer=4,
                   dense_units=8, head_filters=2, device="cpu")
    cfg = value.ValueConfig(train_data=prefix, out_dir=str(out),
                            minibatch=16, epochs=2, learning_rate=0.05,
                            train_val_test=(0.8, 0.1, 0.1), seed=3,
                            device="cpu")
    trainer = value.ValueTrainer(cfg, net=net)
    result = trainer.run()
    assert result["step"] == 2 * (128 // 16)
    for k in ("train_mse", "val_mse", "test_mse"):
        assert np.isfinite(result[k]), k
    meta = json.loads((out / "metadata.json").read_text())
    assert [e["epoch"] for e in meta["epochs"]] == [0, 1]
    assert meta["test_mse"] == result["test_mse"]
    for name in ("weights.00001.flax.msgpack", "model.json", "shuffle.npz"):
        assert (out / name).exists(), name
    # the export loads in the reference, with the same values
    model = str(out / "model.json")
    ref = RefNet.load_model(model)
    port = NeuralNetBase.load_model(model, device="cpu", dtype=torch.float32)
    x = np.random.default_rng(0).integers(0, 2, (4, SIZE, SIZE, PLANES)
                                          ).astype(np.float32)
    np.testing.assert_allclose(
        port.forward(torch.from_numpy(x)).numpy(),
        np.asarray(ref.module.clone(dtype=jnp.float32).apply(
            ref.params, jnp.asarray(x))), rtol=0, atol=1e-4)

    capsys.readouterr()
    ev = evaluate.main([model, prefix, "--split", "test", "--shuffle-npz",
                        str(out / "shuffle.npz"), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == ev
    assert ev["mse"] == pytest.approx(result["test_mse"], abs=1e-6)
    assert ev["positions"] == 16

    # a policy corpus is refused
    with open(f"{prefix}-manifest.json") as f:
        manifest = json.load(f)
    manifest.pop("targets")
    with open(f"{prefix}-manifest.json", "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="outcome"):
        value.ValueTrainer(cfg, net=net)
