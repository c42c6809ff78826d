"""The port's SL trainer, input pipeline and evaluator against the
reference's.

* ``split_indices`` and ``batch_iterator`` (with and without ``skip``,
  over shard windows and the global permutation) give the reference's
  arrays exactly: same seed, same permutation, same cursor.
* A float32 train step (the reference module cloned to float32, the
  port's net built in float32, the same params) with symmetries off
  and with the reference's own ``t`` draws replayed: loss, accuracy and
  every parameter after the step within ``ATOL + RTOL·|x|``; the same
  over 3 steps with Keras-style ``decay`` and with ``momentum``.
* A bfloat16 step (both nets at their default working type) within
  ``BF16_RTOL`` (bf16 keeps 8 mantissa bits and the frameworks round at
  different points).
* Pass actions are masked out of the loss and the accuracy; the eval
  step on a padded batch counts only the real rows.
* The trainer's kill/resume and mid-epoch resume (the reference's
  ``tests/test_sl_trainer.py`` cases) end on bit-identical params.
* The exported ``model.json`` loads in the reference with logits
  within ``ATOL``, and a reference export loads in the port; the
  evaluator's ``top1`` equals the trainer's ``test_accuracy``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.data import pipeline as ref_pipeline
from rocalphago_tpu.io.checkpoint import pack_rng, unpack_rng
from rocalphago_tpu.models import CNNPolicy as RefPolicy
from rocalphago_tpu.models import NeuralNetBase as RefNet
from rocalphago_tpu.training import sl as ref_sl
from rocalphago_tpu_torch.data import pipeline
from rocalphago_tpu_torch.models import CNNPolicy, NeuralNetBase
from rocalphago_tpu_torch.models.weights import params_from_flax, params_to_flax
from rocalphago_tpu_torch.training import evaluate, sl
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 7
FEATURES = ("board", "ones")
PLANES = 4
N_POS = 192
BATCH = 16
ATOL = 1e-5           # float32: summation order only
RTOL = 1e-4
BF16_RTOL = 2e-2      # bf16: 2**-9 relative per rounding, a few roundings
BF16_BIAS_RTOL = 0.15  # a bf16 sum over a whole batch of one channel


def write_dataset(prefix: str, n: int = N_POS, shards: int = 2,
                  seed: int = 0) -> None:
    """A small learnable corpus (the reference trainer tests' own):
    the 'expert' move is a fixed function of the position."""
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 2, (n, SIZE, SIZE, PLANES)).astype(np.uint8)
    actions = (states[:, :, :, 0].sum((1, 2)) % (SIZE * SIZE)).astype(
        np.int32)
    cuts = np.linspace(0, n, shards + 1).astype(int)
    for i in range(shards):
        np.savez(f"{prefix}-{i:05d}.npz", states=states[cuts[i]:cuts[i + 1]],
                 actions=actions[cuts[i]:cuts[i + 1]])
    with open(f"{prefix}-manifest.json", "w") as f:
        json.dump({"board_size": SIZE, "planes": PLANES,
                   "shard_counts": np.diff(cuts).tolist(),
                   "features": list(FEATURES)}, f)


@pytest.fixture()
def corpus(tmp_path):
    prefix = str(tmp_path / "data" / "corpus")
    os.makedirs(tmp_path / "data")
    write_dataset(prefix)
    return prefix


# ------------------------------------------------------------- pipeline


def test_split_indices_is_the_references(tmp_path):
    for n, seed, fr in ((1000, 3, (0.93, 0.05, 0.02)), (97, 0, (0.8, 0.1,
                                                               0.1))):
        want = ref_pipeline.split_indices(n, fr, seed=seed)
        got = pipeline.split_indices(n, fr, seed=seed)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # the persisted file is read back by either package
    path = str(tmp_path / "shuffle.npz")
    written = pipeline.split_indices(500, seed=7, path=path)
    for a, b in zip(ref_pipeline.split_indices(500, seed=99, path=path),
                    written):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="corpus changed"):
        pipeline.split_indices(501, seed=7, path=path)


@pytest.mark.parametrize("shard_window", [4, 2, None])
@pytest.mark.parametrize("skip", [0, 3])
def test_batch_iterator_is_the_references(tmp_path, shard_window, skip):
    prefix = str(tmp_path / "c")
    write_dataset(prefix, shards=6)
    ds, ref_ds = pipeline.ShardedDataset(prefix), ref_pipeline.ShardedDataset(
        prefix)
    idx = pipeline.split_indices(len(ds), (0.9, 0.05, 0.05), seed=1)[0]
    got = list(pipeline.batch_iterator(
        ds, idx, BATCH, np.random.default_rng(5), epochs=2,
        shard_window=shard_window, skip=skip))
    want = list(ref_pipeline.batch_iterator(
        ref_ds, idx, BATCH, np.random.default_rng(5), epochs=2,
        shard_window=shard_window, skip=skip))
    assert len(got) == len(want) == 2 * (len(idx) // BATCH) - skip
    for (gs, ga), (ws, wa) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(ga, wa)


def test_device_prefetch_on_the_cpu_relays_batches_and_errors():
    batches = [(np.full((2, 3), i, np.uint8), np.arange(2, dtype=np.int32))
               for i in range(5)]
    got = list(pipeline.device_prefetch(iter(batches), "cpu"))
    assert [int(p[0, 0]) for p, _ in got] == list(range(5))
    assert all(p.device.type == "cpu" and p.dtype == torch.uint8
               for p, _ in got)

    def failing():
        yield batches[0]
        raise OSError("shard vanished")

    it = pipeline.device_prefetch(failing(), "cpu")
    next(it)
    with pytest.raises(OSError, match="vanished"):
        next(it)


# --------------------------------------------------------------- steps


def nets(dtype=torch.float32, seed=2):
    """The reference policy and the port's with the same params."""
    ref = RefPolicy(FEATURES, board=SIZE, layers=3, filters_per_layer=8,
                    seed=seed)
    port = CNNPolicy(FEATURES, board=SIZE, layers=3, filters_per_layer=8,
                     init_weights=False, device="cpu", dtype=dtype)
    port.module.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, ref.params)))
    return ref, port


def batches(k, seed=0, passes=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        planes = rng.integers(0, 2, (BATCH, SIZE, SIZE, PLANES)).astype(
            np.uint8)
        actions = rng.integers(0, SIZE * SIZE + (1 if passes else 0),
                               BATCH).astype(np.int32)
        if passes:
            actions[:3] = SIZE * SIZE
        out.append((planes, actions))
    return out


def run_both(cfg, data, dtype=torch.float32, symmetries=True):
    """Train both packages over ``data`` from the same params; the
    port replays the reference's group elements. Returns the two
    metric lists and the two param trees (numpy, Flax layout)."""
    ref, port = nets(dtype)
    module = ref.module if dtype == torch.bfloat16 else ref.module.clone(
        dtype=jnp.float32)
    tx = ref_sl.make_optimizer(cfg)
    ref_step = jax.jit(ref_sl.make_train_step(module.apply, tx, SIZE,
                                              symmetries))
    state = ref_sl.SLState(ref.params, tx.init(ref.params), jnp.int32(0),
                           pack_rng(jax.random.key(11)))
    opt, lr_at = sl.make_optimizer(cfg, port.module.parameters())
    pstate = sl.TrainState(port.module, opt, torch.Generator())
    port_step = sl.make_train_step(port.module, opt, lr_at, SIZE, symmetries)
    ref_m, port_m = [], []
    for planes, actions in data:
        # the elements the reference draws inside this step
        _, sub = jax.random.split(unpack_rng(state.rng))
        t = np.array(jax.random.randint(sub, (BATCH,), 0, 8))
        state, m = ref_step(state, jnp.asarray(planes), jnp.asarray(actions))
        ref_m.append({k: float(v) for k, v in m.items()})
        pstate, m = port_step(pstate, torch.from_numpy(planes),
                              torch.from_numpy(actions),
                              t=torch.from_numpy(t))
        port_m.append({k: float(v) for k, v in m.items()})
    assert pstate.step == int(state.step) == len(data)
    want = jax.tree.map(np.asarray, state.params)
    got = params_to_flax(port.module.state_dict())
    return ref_m, port_m, got, want, jax.tree.map(np.asarray, ref.params)


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("symmetries", [False, True])
def test_one_float32_step(symmetries):
    cfg = ref_sl.SLConfig(learning_rate=0.05)
    ref_m, port_m, got, want, before = run_both(cfg, batches(1),
                                                symmetries=symmetries)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(port_m[0][k], ref_m[0][k], rtol=RTOL,
                                   atol=ATOL)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w, b in zip(leaves(got), leaves(want), leaves(before)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    # the step moved the params
    assert max(np.abs(w - b).max() for w, b in
               zip(leaves(want), leaves(before))) > 1e-3


@pytest.mark.parametrize("decay,momentum", [(0.5, 0.0), (0.0, 0.9),
                                            (0.25, 0.5)])
def test_three_float32_steps_with_decay_and_momentum(decay, momentum):
    cfg = ref_sl.SLConfig(learning_rate=0.05, decay=decay,
                          momentum=momentum)
    ref_m, port_m, got, want, _ = run_both(cfg, batches(3, seed=4))
    for r, p in zip(ref_m, port_m):
        np.testing.assert_allclose(p["loss"], r["loss"], rtol=RTOL,
                                   atol=ATOL)
    for g, w in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    # the schedule's origin: update k runs at lr / (1 + decay * k)
    _, lr_at = sl.make_optimizer(cfg, [torch.zeros(1, requires_grad=True)])
    assert [lr_at(k) for k in range(3)] == [
        0.05 / (1 + decay * k) for k in range(3)]


def test_one_bfloat16_step():
    cfg = ref_sl.SLConfig(learning_rate=0.05)
    ref_m, port_m, got, want, before = run_both(cfg, batches(1),
                                                dtype=torch.bfloat16)
    np.testing.assert_allclose(port_m[0]["loss"], ref_m[0]["loss"],
                               rtol=BF16_RTOL)
    # each kernel's update within BF16_RTOL of the largest update; a
    # bias's gradient is one bf16 sum over all B·s·s outputs of its
    # channel, which both frameworks round differently, so biases are
    # held to BF16_BIAS_RTOL (the head bias's exact gradient is 0: the
    # softmax residuals of a row cancel)
    scale = max(np.abs(w - b).max() for w, b in
                zip(leaves(want), leaves(before)))
    for g, w, b in zip(leaves(got), leaves(want), leaves(before)):
        tol = BF16_BIAS_RTOL if w.ndim == 1 else BF16_RTOL
        np.testing.assert_allclose(g - b, w - b, rtol=0, atol=tol * scale)


def test_pass_actions_are_masked():
    cfg = ref_sl.SLConfig(learning_rate=0.05)
    data = batches(1, seed=8, passes=True)
    ref_m, port_m, got, want, _ = run_both(cfg, data, symmetries=False)
    np.testing.assert_allclose(port_m[0]["loss"], ref_m[0]["loss"],
                               rtol=RTOL, atol=ATOL)
    for g, w in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    # the loss is the board rows' loss alone
    _, port = nets()
    planes, actions = data[0]
    board = actions < SIZE * SIZE
    with torch.no_grad():
        full = sl.policy_loss_fn(port.module, torch.from_numpy(planes).float(),
                                 torch.from_numpy(actions))
        only = sl.policy_loss_fn(
            port.module, torch.from_numpy(planes[board]).float(),
            torch.from_numpy(actions[board]))
    assert float(full[0]) == pytest.approx(float(only[0]), rel=1e-6)
    assert float(full[1]) == pytest.approx(float(only[1]), rel=1e-6)


def test_eval_step_with_padded_weights():
    ref, port = nets()
    planes, actions = batches(1, seed=9, passes=True)[0]
    planes, actions = planes[:11], actions[:11]
    want_p = ref_sl.pad_batch(planes, actions, BATCH)
    got_p = sl.pad_batch(planes, actions, BATCH)
    for g, w in zip(got_p, want_p):
        np.testing.assert_array_equal(g, w)
    ref_eval = jax.jit(ref_sl.make_eval_step(
        ref.module.clone(dtype=jnp.float32).apply, SIZE * SIZE))
    want = ref_eval(ref.params, *map(jnp.asarray, want_p))
    got = sl.make_eval_step(port.module, SIZE * SIZE)(
        *map(torch.from_numpy, got_p))
    for k in ("loss", "accuracy", "count"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   atol=ATOL)
    assert float(got["count"]) == float((actions < SIZE * SIZE).sum())


# -------------------------------------------------------------- trainer


def small_cfg(corpus, out_dir, **kw):
    defaults = dict(
        train_data=corpus, out_dir=str(out_dir), minibatch=16, epochs=2,
        learning_rate=0.05, train_val_test=(0.8, 0.1, 0.1),
        symmetries=True, seed=1, max_validation_batches=2, device="cpu")
    defaults.update(kw)
    return sl.SLConfig(**defaults)


def small_net():
    return CNNPolicy(FEATURES, board=SIZE, layers=2, filters_per_layer=4,
                     device="cpu")


def params_of(trainer):
    return {k: v.clone() for k, v in trainer.net.module.state_dict().items()}


def assert_same_bits(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_trainer_artifacts_and_split(corpus, tmp_path):
    out = tmp_path / "out"
    trainer = sl.SLTrainer(small_cfg(corpus, out), net=small_net())
    result = trainer.run()
    assert np.isfinite(result["train_loss"]) and np.isfinite(
        result["val_loss"])
    assert result["step"] == 2 * trainer._steps_per_epoch()
    meta = json.loads((out / "metadata.json").read_text())
    assert [e["epoch"] for e in meta["epochs"]] == [0, 1]
    assert meta["test_accuracy"] == result["test_accuracy"]
    for name in ("weights.00000.flax.msgpack", "weights.00001.flax.msgpack",
                 "model.json", "shuffle.npz", "metrics.jsonl"):
        assert (out / name).exists(), name
    spec = json.loads((out / "model.json").read_text())
    assert spec["weights_file"] == "weights.00001.flax.msgpack"
    # the split is the reference's for the same seed
    for a, b in zip((trainer.train_idx, trainer.val_idx, trainer.test_idx),
                    ref_pipeline.split_indices(N_POS, (0.8, 0.1, 0.1),
                                               seed=1)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="planes"):
        sl.SLTrainer(small_cfg(corpus, tmp_path / "bad"), net=CNNPolicy(
            ("board",), board=SIZE, layers=2, filters_per_layer=4,
            device="cpu"))
    # a width above the world size (one process here) is refused
    with pytest.raises(ValueError, match="rank.*torch.distributed.run"):
        sl.SLTrainer(small_cfg(corpus, tmp_path / "bad", num_devices=2),
                     net=small_net())


def test_kill_and_resume_is_bit_identical(corpus, tmp_path):
    straight = sl.SLTrainer(small_cfg(corpus, tmp_path / "a", epochs=2),
                            net=small_net())
    straight.run()
    interrupted = sl.SLTrainer(small_cfg(corpus, tmp_path / "b", epochs=1),
                               net=small_net())
    interrupted.run()
    resumed = sl.SLTrainer(small_cfg(corpus, tmp_path / "b", epochs=2),
                           net=small_net())
    assert resumed.start_epoch == 1
    assert resumed.state.step == interrupted.state.step
    resumed.run()
    assert resumed.state.step == straight.state.step
    assert_same_bits(params_of(straight), params_of(resumed))
    assert torch.equal(straight.state.generator.get_state(),
                       resumed.state.generator.get_state())


def test_mid_epoch_kill_and_resume_is_bit_identical(corpus, tmp_path):
    straight = sl.SLTrainer(small_cfg(corpus, tmp_path / "a", epochs=1),
                            net=small_net())
    straight.run()
    assert straight._steps_per_epoch() >= 6

    interrupted = sl.SLTrainer(
        small_cfg(corpus, tmp_path / "b", epochs=1, save_every=2),
        net=small_net())
    orig_step = interrupted._train_step
    calls = {"n": 0}

    def killing_step(state, planes, actions):
        if calls["n"] == 5:
            raise KeyboardInterrupt("simulated preemption")
        calls["n"] += 1
        return orig_step(state, planes, actions)

    interrupted._train_step = killing_step
    with pytest.raises(KeyboardInterrupt):
        interrupted.run()
    assert interrupted.ckpt.latest_step() == 4

    resumed = sl.SLTrainer(
        small_cfg(corpus, tmp_path / "b", epochs=1, save_every=2),
        net=small_net())
    assert resumed.start_epoch == 0
    assert resumed._resume_skip == 4
    resumed.run()
    assert_same_bits(params_of(straight), params_of(resumed))


def test_damaged_newest_checkpoint_falls_back(corpus, tmp_path, capsys):
    out = tmp_path / "out"
    sl.SLTrainer(small_cfg(corpus, out, epochs=1, save_every=3),
                 net=small_net()).run()
    ckpt = sl.TrainCheckpointer(str(out / "checkpoints"))
    steps = ckpt.all_steps()
    newest = steps[-1]
    with open(out / "checkpoints" / str(newest) / "state.pt", "wb") as f:
        f.write(b"torn")
    state, step = ckpt.restore()
    assert step == steps[-2] and state["step"] == steps[-2]
    assert "falling back" in capsys.readouterr().err
    with pytest.raises(Exception):
        ckpt.restore(step=newest)
    # a save interrupted before its rename is invisible
    (out / "checkpoints" / f".tmp-{newest + 1}-1").mkdir()
    assert ckpt.latest_step() == newest


def test_export_loads_both_ways_and_the_evaluator_agrees(corpus, tmp_path,
                                                         capsys):
    out = tmp_path / "out"
    result = sl.SLTrainer(small_cfg(corpus, out, epochs=1),
                          net=small_net()).run()
    model = str(out / "model.json")
    x = np.random.default_rng(3).integers(0, 2, (5, SIZE, SIZE, PLANES)
                                          ).astype(np.float32)
    ref = RefNet.load_model(model)
    port = NeuralNetBase.load_model(model, device="cpu", dtype=torch.float32)
    want = np.asarray(ref.module.clone(dtype=jnp.float32).apply(
        ref.params, jnp.asarray(x)))
    got = port.forward(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the reverse: a reference export in the port
    ref.save_model(str(tmp_path / "ref.json"))
    back = NeuralNetBase.load_model(str(tmp_path / "ref.json"),
                                    device="cpu", dtype=torch.float32)
    np.testing.assert_allclose(back.forward(torch.from_numpy(x)).numpy(),
                               want, rtol=0, atol=1e-4)

    capsys.readouterr()
    ev = evaluate.main([model, corpus, "--split", "test", "--shuffle-npz",
                        str(out / "shuffle.npz"), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == ev
    assert ev["top1"] == pytest.approx(result["test_accuracy"], abs=1e-6)
    assert ev["loss"] == pytest.approx(result["test_loss"], abs=1e-5)
    assert ev["positions"] == len(np.load(out / "shuffle.npz")["test"])


def test_checkpoint_retries_transient_failures(tmp_path, monkeypatch):
    """The copied retry: the reference's backoff schedule, transient
    errors re-invoked, programming errors raised at once."""
    from rocalphago_tpu.runtime import retries as ref_retries
    from rocalphago_tpu_torch.runtime import retries

    for attempt in range(4):
        assert retries.backoff_delay(attempt, 0.5, 30.0, 0, "k") == \
            ref_retries.backoff_delay(attempt, 0.5, 30.0, 0, "k")
    slept = []
    monkeypatch.setattr(retries.time, "sleep", slept.append)
    ckpt = sl.TrainCheckpointer(str(tmp_path / "c"))
    real_save, calls = torch.save, []

    def flaky_save(obj, f):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("filesystem hiccough")
        real_save(obj, f)

    monkeypatch.setattr(torch, "save", flaky_save)
    ckpt.save(3, {"step": 3, "w": torch.ones(2)})
    assert len(calls) == 2 and len(slept) == 1
    assert ckpt.restore()[0]["step"] == 3
    def broken():
        calls.append(1)
        raise TypeError("bad argument")

    with pytest.raises(TypeError):
        retries.retry()(broken)()
    assert len(calls) == 3 and len(slept) == 1
