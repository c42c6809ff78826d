"""Data parallelism over ranks (``rocalphago_tpu_torch/parallel``) and the
trainers at ``num_devices=2``, against the reference's sharded runs, on
the CPU.

The port runs two gloo ranks, each a child process over a file store
(``parallel.launch.spawn_ranks``); the reference runs in this process
on the 8 virtual CPU devices ``tests/conftest.py`` provides, over its
``make_mesh(2)``. The rank functions below (``_rank_*``) import nothing
of JAX: the ranks import this module. Tolerances:

* mesh helpers, splits, counts and the integer outputs exact;
* float32 steps and trainers: ``ATOL + RTOL·|x|`` (summation order:
  the ranks' partial gradients are summed by the all-reduce), the
  two ranks bit-equal to each other;
* the SL steps replay the reference's global symmetry draws, and the
  batches hold pass rows split unevenly over the ranks (the global
  valid count is the divisor).

Also the reference's single-process multi-host tests
(``tests/test_multihost.py:31-100``) held against the port, with one
deliberate divergence: a rank that is not the coordinator writes no
checkpoint files (the state is replicated; it takes part in each save
as a barrier and restores the coordinator's files).
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rocalphago_tpu_torch import entry
from rocalphago_tpu_torch.models import CNNPolicy, CNNValue
from rocalphago_tpu_torch.models.weights import params_from_flax, params_to_flax
from rocalphago_tpu_torch.parallel import mesh as meshlib
from rocalphago_tpu_torch.parallel.launch import spawn_ranks
from rocalphago_tpu_torch.training import evaluate, sl, value

HERE = os.path.dirname(os.path.abspath(__file__))
SIZE = 7
FEATURES = ("board", "ones")
PLANES = 4
VFEATURES = ("board", "ones", "color")
VPLANES = 5
N_POS = 160
BATCH = 16
ATOL = 1e-5           # float32: summation order only
RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ranks(target: str, tmp_path, n: int = 2, **kwargs) -> list:
    """``target(**kwargs)`` in ``n`` gloo CPU ranks; their results."""
    return spawn_ranks(f"{__name__}:{target}", n,
                       str(tmp_path / f"ranks-{target}"), kwargs,
                       device="cpu", paths=(HERE,), timeout=240)


# ---------------------------------------------------------------- data


def write_policy_corpus(prefix: str, n: int = N_POS, seed: int = 0) -> None:
    """A small corpus (``test_torch_sl.py``'s), a pass action every
    fifth position."""
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 2, (n, SIZE, SIZE, PLANES)).astype(np.uint8)
    actions = (states[:, :, :, 0].sum((1, 2)) % (SIZE * SIZE)).astype(
        np.int32)
    actions[::5] = SIZE * SIZE
    half = n // 2
    for i, part in enumerate((slice(0, half), slice(half, n))):
        np.savez(f"{prefix}-{i:05d}.npz", states=states[part],
                 actions=actions[part])
    with open(f"{prefix}-manifest.json", "w") as f:
        json.dump({"board_size": SIZE, "planes": PLANES,
                   "shard_counts": [half, n - half],
                   "features": list(FEATURES)}, f)


def write_outcome_corpus(prefix: str, n: int = N_POS, seed: int = 0) -> None:
    """An outcome corpus (``test_torch_value_trainer.py``'s)."""
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 2, (n, SIZE, SIZE, VPLANES)).astype(np.uint8)
    z = np.where(states[..., 0].sum((1, 2)) > states[..., 1].sum((1, 2)),
                 1, -1).astype(np.int32)
    half = n // 2
    for i, part in enumerate((slice(0, half), slice(half, n))):
        np.savez_compressed(f"{prefix}-{i:05d}.npz", states=states[part],
                            actions=z[part])
    with open(f"{prefix}-manifest.json", "w") as f:
        json.dump({"board_size": SIZE, "komi": 7.5, "planes": VPLANES,
                   "feature_list": list(VFEATURES), "targets": "outcome",
                   "shard_counts": [half, n - half], "num_positions": n}, f)


def step_batches(k: int, seed: int = 0) -> list:
    """``k`` global minibatches; pass rows only in the first quarter of
    each, so rank 0 of 2 holds them all (an uneven split)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        planes = rng.integers(0, 2, (BATCH, SIZE, SIZE, PLANES)).astype(
            np.uint8)
        actions = rng.integers(0, SIZE * SIZE, BATCH).astype(np.int32)
        actions[:1 + i + 2] = SIZE * SIZE
        out.append((planes, actions))
    return out


def ref_policy(seed: int = 2):
    """The reference's 3 × 8 policy in float32 (fresh: the reference's
    trainer exports by assigning its params)."""
    import jax.numpy as jnp

    from rocalphago_tpu.models import CNNPolicy as RefPolicy

    ref = RefPolicy(FEATURES, board=SIZE, layers=3, filters_per_layer=8,
                    seed=seed)
    ref.module = ref.module.clone(dtype=jnp.float32)
    return ref


def ref_value_net(seed: int = 5):
    import jax.numpy as jnp

    from rocalphago_tpu.models import CNNValue as RefValue

    ref = RefValue(VFEATURES, board=SIZE, layers=2, filters_per_layer=8,
                   dense_units=16, head_filters=4, seed=seed)
    ref.module = ref.module.clone(dtype=jnp.float32)
    return ref


def state_dict_of(ref) -> dict:
    import jax

    return params_from_flax(jax.tree.map(np.asarray, ref.params))


def port_policy(params: dict):
    net = CNNPolicy(FEATURES, board=SIZE, layers=3, filters_per_layer=8,
                    init_weights=False, device="cpu", dtype=torch.float32)
    net.module.load_state_dict(params)
    return net


def port_value(params: dict):
    net = CNNValue(VFEATURES, board=SIZE, layers=2, filters_per_layer=8,
                   dense_units=16, head_filters=4, init_weights=False,
                   device="cpu", dtype=torch.float32)
    net.module.load_state_dict(params)
    return net


def flax_leaves(tree) -> list:
    import jax

    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def assert_close_params(got: dict, want_tree) -> None:
    """Port state dict ``got`` against a reference param tree."""
    import jax

    g = jax.tree.leaves(params_to_flax(got))
    w = flax_leaves(want_tree)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), b, rtol=RTOL, atol=ATOL)


def assert_same_bits(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -------------------------------------------------------- mesh helpers


def test_rows_slices_and_batch_sizes():
    meshes = [meshlib.Mesh(2, r, torch.device("cpu")) for r in range(2)]
    assert [m.rows(8).tolist() for m in meshes] == [[0, 1, 2, 3],
                                                    [4, 5, 6, 7]]
    assert [m.rows(8, "halves").tolist() for m in meshes] == [
        [0, 1, 4, 5], [2, 3, 6, 7]]
    four = [meshlib.Mesh(4, r, torch.device("cpu")) for r in range(4)]
    assert [m.rows(8, "halves").tolist() for m in four] == [
        [0, 4], [1, 5], [2, 6], [3, 7]]
    x = np.arange(24).reshape(3, 8)          # time-major [T, B]
    got = meshlib.shard_batch(meshes[1], {"a": x, "b": (
        torch.arange(16).reshape(2, 8), None)}, axis=1)
    np.testing.assert_array_equal(got["a"], x[:, 4:])
    assert got["b"][0].tolist() == [[4, 5, 6, 7], [12, 13, 14, 15]]
    assert got["b"][1] is None
    got = meshlib.shard_batch(meshes[1], (torch.arange(8),), layout="halves")
    assert got[0].tolist() == [2, 3, 6, 7]
    assert meshlib.shard_batch(None, x) is x
    assert meshlib.global_batch_size(meshes[0], 16) == 32
    assert meshes[0].shape == {meshlib.DATA_AXIS: 2, meshlib.MODEL_AXIS: 1}
    with pytest.raises(ValueError, match="not divisible by data-parallel"):
        meshes[0].local_batch(7)
    with pytest.raises(ValueError, match="multiple of 2x the data-axis"):
        meshes[0].local_batch(6, "halves")


def test_a_mesh_of_one_and_its_width_errors():
    mesh = meshlib.make_mesh(device="cpu")
    assert (mesh.width, mesh.rank, mesh.sharded) == (1, 0, False)
    t = torch.arange(4)
    assert mesh.gather(t) is t and mesh.take(t) is t
    assert mesh.all_reduce(t) is t and mesh.broadcast(t) is t
    assert mesh.all_true(torch.ones(3, dtype=torch.bool))
    assert not mesh.any_true(torch.zeros(3, dtype=torch.bool))
    mesh.barrier()
    with pytest.raises(ValueError, match="1 rank.*torch.distributed.run "
                                         "--nproc-per-node 2"):
        meshlib.make_mesh(2, "cpu")
    with pytest.raises(ValueError, match=">= 1"):
        meshlib.make_mesh(0, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        meshlib.make_mesh()     # the card by default


def test_distributed_init_noop_single_process(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert meshlib.distributed_init() is None      # no coordinator, 1 rank
    assert meshlib.distributed_init(num_processes=1) is None
    assert calls == []


def test_distributed_init_dispatches_multiprocess(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    assert meshlib.distributed_init(coordinator="host0:1234",
                                    num_processes=2, process_id=1,
                                    device="cpu") == "gloo"
    assert calls[-1] == (("gloo",), {"init_method": "tcp://host0:1234",
                                     "world_size": 2, "rank": 1})
    meshlib.distributed_init(coordinator="file:///tmp/store",
                             num_processes=2, process_id=0, device="cpu")
    assert calls[-1][1]["init_method"] == "file:///tmp/store"
    # the launcher's environment (torch.distributed.run)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    meshlib.distributed_init(device="cpu")
    assert calls[-1] == (("gloo",), {"init_method": "env://",
                                     "world_size": 4, "rank": 3})
    assert len(calls) == 3


def test_the_backend_follows_the_topology(monkeypatch):
    assert meshlib.choose_backend("cpu", 2)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert meshlib.choose_backend(None, 1)[0] == "nccl"
    backend, why = meshlib.choose_backend("cuda", 2)
    assert backend == "gloo" and "share" in why
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert meshlib.choose_backend("cuda:0", 4)[0] == "nccl"
    assert meshlib.cpu_collectives_available()


def test_coordinator_is_true_single_process():
    assert meshlib.is_coordinator()
    assert meshlib.world_size() == 1 and meshlib.process_index() == 0


@pytest.fixture()
def corpus(tmp_path):
    prefix = str(tmp_path / "data" / "corpus")
    os.makedirs(tmp_path / "data")
    write_policy_corpus(prefix)
    return prefix


def small_cfg(corpus, out_dir, **kw):
    defaults = dict(
        train_data=corpus, out_dir=str(out_dir), minibatch=BATCH, epochs=2,
        learning_rate=0.05, train_val_test=(0.8, 0.1, 0.1),
        symmetries=True, seed=1, max_validation_batches=2, device="cpu")
    defaults.update(kw)
    return sl.SLConfig(**defaults)


def small_net():
    return CNNPolicy(FEATURES, board=SIZE, layers=2, filters_per_layer=4,
                     device="cpu")


def test_non_coordinator_writes_no_artifacts(corpus, tmp_path, monkeypatch):
    """A rank that is not the coordinator trains but writes no
    metadata, metrics, weights, split -- and, unlike the reference's
    every-process Orbax saves, no checkpoint files: the coordinator's
    are every rank's (ROADMAP.md Queue 3)."""
    monkeypatch.setattr(meshlib, "is_coordinator", lambda: False)
    out = tmp_path / "out"
    trainer = sl.SLTrainer(small_cfg(corpus, out, epochs=1), net=small_net())
    result = trainer.run()
    assert result["step"] > 0
    for name in ("metadata.json", "metrics.jsonl", "shuffle.npz",
                 "model.json"):
        assert not (out / name).exists(), name
    assert (out / "checkpoints").is_dir()
    assert os.listdir(out / "checkpoints") == []


def test_non_coordinator_split_matches_coordinator(corpus, tmp_path,
                                                   monkeypatch):
    coord = sl.SLTrainer(small_cfg(corpus, tmp_path / "a", epochs=1),
                         net=small_net())
    monkeypatch.setattr(meshlib, "is_coordinator", lambda: False)
    worker = sl.SLTrainer(small_cfg(corpus, tmp_path / "b", epochs=1),
                          net=small_net())
    for a, b in zip((coord.train_idx, coord.test_idx, coord.val_idx),
                    (worker.train_idx, worker.test_idx, worker.val_idx)):
        np.testing.assert_array_equal(a, b)
    assert not (tmp_path / "b" / "shuffle.npz").exists()


# ---------------------------------------------------- collectives, 2 ranks


def _rank_collectives() -> dict:
    mesh = meshlib.make_mesh(2, "cpu")
    r = mesh.rank
    out = {"rank": r, "backend": mesh.backend}
    local = torch.tensor([[r, -r], [10 + r, 20 + r]], dtype=torch.int8)
    out["halves"] = mesh.gather(local, 0, "halves")
    out["time_major"] = mesh.gather(torch.full((3, 2), r + 0.5), 1)
    out["bool"] = mesh.gather(torch.tensor([r == 0, True]))
    b = torch.tensor([1.25 + r], dtype=torch.bfloat16)
    out["broadcast"] = mesh.broadcast(b)
    out["all_true"] = mesh.all_true(torch.tensor([True, r == 0]))
    out["any_true"] = mesh.any_true(torch.tensor([r == 1]))
    mesh.barrier()
    lin = torch.nn.Linear(2, 1)
    torch.nn.init.constant_(lin.weight, float(r))
    mesh.replicate(lin)                  # rank 0's weights everywhere
    out["replicated"] = lin.weight.detach().clone()
    lin(torch.full((1, 2), float(r + 1))).sum().backward()
    extra = (torch.tensor(r + 1.0), torch.tensor([r, 1], dtype=torch.int32))
    out["extra"] = mesh.all_reduce_grads([lin], extra)
    out["grad"] = lin.weight.grad.clone()
    return out


def test_collectives_over_two_ranks(tmp_path):
    outs = ranks("_rank_collectives", tmp_path)
    assert [o["rank"] for o in outs] == [0, 1]
    for o in outs:
        assert o["backend"] == "gloo"
        assert o["halves"].dtype == torch.int8
        assert o["halves"].tolist() == [[0, 0], [1, -1], [10, 20], [11, 21]]
        assert o["time_major"].tolist() == [[0.5, 0.5, 1.5, 1.5]] * 3
        assert o["bool"].tolist() == [True, True, False, True]
        assert o["broadcast"].dtype == torch.bfloat16
        assert float(o["broadcast"]) == 1.25
        assert (o["all_true"], o["any_true"]) == (False, True)
        assert o["replicated"].tolist() == [[0.0, 0.0]]
        # d(sum)/dw = the input: 1 on rank 0, 2 on rank 1, summed
        assert o["grad"].tolist() == [[3.0, 3.0]]
        assert float(o["extra"][0]) == 3.0
        assert o["extra"][1].dtype == torch.int32
        assert o["extra"][1].tolist() == [1, 2]


# ---------------------------------------------------------- SL, 2 ranks


def reference_sharded_steps(cfg, data):
    """The reference's train step jitted over its ``make_mesh(2)`` (the
    trainer's shardings), from :func:`ref_policy`'s params: ``(the
    global group elements of each step, metrics, final params)``."""
    import jax
    import jax.numpy as jnp

    from rocalphago_tpu.io.checkpoint import pack_rng, unpack_rng
    from rocalphago_tpu.parallel import mesh as ref_mesh
    from rocalphago_tpu.training import sl as ref_sl

    ref = ref_policy()
    mesh = ref_mesh.make_mesh(2)
    tx = ref_sl.make_optimizer(cfg)
    rep = ref_mesh.replicated(mesh)
    state = ref_mesh.replicate(mesh, ref_sl.SLState(
        ref.params, tx.init(ref.params), jnp.int32(0),
        pack_rng(jax.random.key(11))))
    state_sh = jax.tree.map(lambda _: rep, state)
    step = jax.jit(ref_sl.make_train_step(ref.module.apply, tx, SIZE, True),
                   in_shardings=(state_sh, ref_mesh.data_sharding(mesh, 4),
                                 ref_mesh.data_sharding(mesh, 1)),
                   out_shardings=(state_sh, rep))
    ts, ms = [], []
    for planes, actions in data:
        _, sub = jax.random.split(unpack_rng(state.rng))
        ts.append(np.array(jax.random.randint(sub, (BATCH,), 0, 8)))
        planes, actions = ref_mesh.shard_batch(mesh, (planes, actions))
        state, m = step(state, planes, actions)
        ms.append({k: float(v) for k, v in m.items()})
    return ts, ms, jax.device_get(state.params)


def _rank_sl_steps(params, data, ts, lr, decay, momentum) -> dict:
    mesh = meshlib.make_mesh(2, "cpu")
    net = port_policy(params)
    cfg = sl.SLConfig(learning_rate=lr, decay=decay, momentum=momentum)
    opt, lr_at = sl.make_optimizer(cfg, net.module.parameters())
    state = sl.TrainState(net.module, opt, torch.Generator())
    step = sl.make_train_step(net.module, opt, lr_at, SIZE, True, mesh=mesh)
    metrics = []
    for (planes, actions), t in zip(data, ts):
        planes, actions, t = meshlib.shard_batch(mesh, (planes, actions, t))
        state, m = step(state, torch.from_numpy(planes),
                        torch.from_numpy(actions), t=torch.from_numpy(t))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": net.module.state_dict()}


def test_sl_steps_match_the_references_sharded_steps(tmp_path):
    """Three float32 steps with decay and momentum, symmetries on with
    the reference's global draws replayed, pass rows only in rank 0's
    rows: the global valid count divides both ranks' sums."""
    from rocalphago_tpu.training import sl as ref_sl

    data = step_batches(3, seed=4)
    cfg = ref_sl.SLConfig(learning_rate=0.05, decay=0.25, momentum=0.5)
    ts, want_m, want = reference_sharded_steps(cfg, data)
    outs = ranks("_rank_sl_steps", tmp_path,
                 params=state_dict_of(ref_policy()), data=data, ts=ts,
                 lr=0.05, decay=0.25, momentum=0.5)
    assert_same_bits(outs[0]["params"], outs[1]["params"])
    assert outs[0]["metrics"] == outs[1]["metrics"]
    for got, want_step in zip(outs[0]["metrics"], want_m):
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(got[k], want_step[k], rtol=RTOL,
                                       atol=ATOL)
    assert_close_params(outs[0]["params"], want)
    # the step moved the params beyond the tolerance
    before = flax_leaves(ref_policy().params)
    assert max(np.abs(a - b).max() for a, b in
               zip(flax_leaves(want), before)) > 1e-3


def _rank_sl_trainer(corpus, out, params, symmetries) -> dict:
    cfg = small_cfg(corpus, out, num_devices=2, symmetries=symmetries)
    result = {}
    for epochs, where in ((2, "straight"), (1, "killed"), (2, "killed")):
        trainer = sl.SLTrainer(
            dataclass_replace(cfg, epochs=epochs,
                              out_dir=os.path.join(out, where)),
            net=port_policy(params))
        final = trainer.run()
        result[where] = {"final": final, "coord": trainer.coord,
                         "writes": trainer.metrics.path is not None,
                         "start_epoch": trainer.start_epoch,
                         "params": trainer.net.module.state_dict()}
    return result


def dataclass_replace(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **kw)


def test_sl_trainer_over_two_ranks_matches_the_reference_trainer(
        corpus, tmp_path):
    """The reference's ``SLTrainer(num_devices=2)`` and the port's over
    two ranks, symmetries off (the batches are then the same): params,
    losses and accuracies within tolerance, rank 0 alone writing; a run
    killed after epoch 0 and resumed over both ranks ends on the
    straight run's bits."""
    import jax

    from rocalphago_tpu.training import sl as ref_sl

    ref = ref_policy()
    params = state_dict_of(ref)
    cfg = small_cfg(corpus, tmp_path / "ref", num_devices=2,
                    symmetries=False)
    want = ref_sl.SLTrainer(ref_sl.SLConfig(**{
        k: v for k, v in vars(cfg).items() if k != "device"}), net=ref)
    want_final = want.run()
    want.ckpt.close()
    outs = ranks("_rank_sl_trainer", tmp_path, corpus=corpus,
                 out=str(tmp_path / "port"), params=params,
                 symmetries=False)
    r0, r1 = outs[0]["straight"], outs[1]["straight"]
    assert (r0["coord"], r1["coord"]) == (True, False)
    assert (r0["writes"], r1["writes"]) == (True, False)
    assert_same_bits(r0["params"], r1["params"])
    assert_close_params(r0["params"], jax.device_get(want.state.params))
    for k in ("train_loss", "train_accuracy", "val_loss", "val_accuracy",
              "test_loss", "test_accuracy"):
        np.testing.assert_allclose(r0["final"][k], want_final[k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert r0["final"]["step"] == want_final["step"]
    out = tmp_path / "port" / "straight"
    # one record an epoch: rank 1 wrote none
    events = [json.loads(line) for line in
              (out / "metrics.jsonl").read_text().splitlines()]
    assert [e["epoch"] for e in events if e["event"] == "epoch"] == [0, 1]
    assert json.loads((out / "model.json").read_text())["weights_file"] == \
        "weights.00001.flax.msgpack"
    # kill after epoch 0, resume: both ranks restore rank 0's files
    assert outs[0]["killed"]["start_epoch"] == 1
    assert outs[1]["killed"]["start_epoch"] == 1
    for o in outs:
        assert_same_bits(o["killed"]["params"], r0["params"])


# ------------------------------------------------- value, eval, 2 ranks


@pytest.fixture()
def outcomes(tmp_path):
    prefix = str(tmp_path / "vdata" / "corpus")
    os.makedirs(tmp_path / "vdata")
    write_outcome_corpus(prefix)
    return prefix


def value_cfg(corpus, out_dir, **kw):
    defaults = dict(
        train_data=corpus, out_dir=str(out_dir), minibatch=8, epochs=2,
        learning_rate=0.02, momentum=0.5, train_val_test=(0.8, 0.1, 0.1),
        symmetries=False, seed=0, max_validation_batches=2, device="cpu")
    defaults.update(kw)
    return value.ValueConfig(**defaults)


def _rank_value_trainer(corpus, out, params, symmetries) -> dict:
    trainer = value.ValueTrainer(
        value_cfg(corpus, out, num_devices=2, symmetries=symmetries),
        net=port_value(params))
    final = trainer.run()
    return {"final": final, "params": trainer.net.module.state_dict()}


def test_value_trainer_over_two_ranks(outcomes, tmp_path):
    """Symmetries off: the reference's ``ValueTrainer(num_devices=2)``
    within tolerance. Symmetries on: one rank of the port with the same
    seed within tolerance (the same global draws, sliced)."""
    import jax

    from rocalphago_tpu.training import value as ref_value

    ref = ref_value_net()
    params = state_dict_of(ref)
    cfg = value_cfg(outcomes, tmp_path / "ref", num_devices=2)
    want = ref_value.ValueTrainer(ref_value.ValueConfig(**{
        k: v for k, v in vars(cfg).items() if k != "device"}), net=ref)
    want_final = want.run()
    want.ckpt.close()
    outs = ranks("_rank_value_trainer", tmp_path, corpus=outcomes,
                 out=str(tmp_path / "port"), params=params,
                 symmetries=False)
    assert_same_bits(outs[0]["params"], outs[1]["params"])
    assert_close_params(outs[0]["params"], jax.device_get(want.state.params))
    for k in ("train_mse", "val_mse", "test_mse"):
        np.testing.assert_allclose(outs[0]["final"][k], want_final[k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    # symmetries on: two ranks against one
    outs = ranks("_rank_value_trainer", tmp_path, corpus=outcomes,
                 out=str(tmp_path / "sym2"), params=params,
                 symmetries=True)
    one = value.ValueTrainer(value_cfg(outcomes, tmp_path / "sym1",
                                       symmetries=True),
                             net=port_value(params))
    one_final = one.run()
    for k, v in one.net.module.state_dict().items():
        np.testing.assert_allclose(outs[0]["params"][k].numpy(), v.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(outs[0]["final"]["train_mse"],
                               one_final["train_mse"], rtol=RTOL, atol=ATOL)


def _rank_evaluate(prefix, params, minibatch, kind) -> dict:
    from rocalphago_tpu_torch.data.pipeline import ShardedDataset

    net = port_policy(params) if kind == "policy" else port_value(params)
    ds = ShardedDataset(prefix)
    return evaluate.evaluate_model(net, ds, np.arange(len(ds) - 3),
                                   minibatch=minibatch, num_devices=2)


@pytest.mark.parametrize("kind", ["policy", "value"])
def test_evaluator_at_width_two(corpus, outcomes, tmp_path, kind):
    """``evaluate_model(num_devices=2)``: the minibatch rounded to the
    width (7 → 6), the padded last batch, the sums reduced before they
    divide -- the reference's at width 2 within tolerance, the
    position count exact."""
    from rocalphago_tpu.data.pipeline import ShardedDataset as RefDataset
    from rocalphago_tpu.training import evaluate as ref_evaluate

    prefix, ref = ((corpus, ref_policy()) if kind == "policy"
                   else (outcomes, ref_value_net()))
    ds = RefDataset(prefix)
    want = ref_evaluate.evaluate_model(ref, ds, np.arange(len(ds) - 3),
                                       minibatch=7, num_devices=2)
    outs = ranks("_rank_evaluate", tmp_path, prefix=prefix,
                 params=state_dict_of(ref), minibatch=7, kind=kind)
    assert outs[0] == outs[1]
    assert outs[0]["positions"] == want["positions"]
    assert outs[0].keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(outs[0][k], want[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


# ------------------------------------------------------------ entry


@pytest.mark.parametrize("n", [2, 4])
def test_entry_dryrun_multichip(tmp_path, n):
    """One data-parallel SL step over ``n`` gloo ranks: every rank on
    the same bits (checked inside), and equal within tolerance to one
    rank's step on the whole global batch."""
    got = entry.dryrun_multichip(n, workdir=str(tmp_path))
    assert got["width"] == n and got["backend"] == "gloo"
    one = entry._sl_step(None, batch=2 * n)
    assert one["width"] == 1
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=RTOL,
                               atol=ATOL)
    for k, v in one["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_entry_forward_is_the_flagship():
    fn, (planes,) = entry.entry("cpu")
    assert planes.shape == (8, 19, 19, 48) and planes.device.type == "cpu"
    assert sum(p.numel() for p in fn.parameters()) > 1_000_000
    with torch.no_grad():
        out = fn(planes[:1])
    assert out.shape == (1, 361) and torch.isfinite(out).all()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
