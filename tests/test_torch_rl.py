"""The port's REINFORCE trainer (``rocalphago_tpu_torch/training/rl.py``)
against the reference's, on the CPU.

* The reference's ``make_rl_iteration`` runs in float32 on a game batch
  between two different 2 × 4 policies; its game stream (the same key
  split, replayed through its own ``play_games``) is handed to the
  port's iteration in place of the port's draws. The port's update
  ``(old − new) / lr`` equals the reference's within ``ATOL + RTOL·|x|``
  (summation order only), and the metrics are equal. The batch holds
  games that end before the move limit, so rows of finished games and
  passes take part (they weigh 0 and must add exactly zero, no NaN).
* The port's monolithic and chunked iterations end on the same bits
  over two iterations, generator included.
* ``OpponentPool.sample`` names the reference's snapshot for 10 (seed,
  iteration) pairs, with and without ``save_every``; snapshots written
  by either package read back equal in the other.
* ``RLTrainer`` through its CLI on the CPU: a run killed and resumed
  (between iterations, and inside one) ends on the straight run's bits;
  the chunked run equals the monolithic one; the export loads in the
  reference with equal params.

The nets read every default plane but the two ladder planes: XLA takes
some 25 s to compile the reference's ladder reader per program. The
ladder planes are held against the reference by
``test_torch_ladders.py`` and ``test_torch_features*``.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rocalphago_tpu.engine import jaxgo
from rocalphago_tpu.io.checkpoint import pack_rng
from rocalphago_tpu.models import CNNPolicy as RefPolicy
from rocalphago_tpu.models import NeuralNetBase as RefNet
from rocalphago_tpu.search import selfplay as ref_selfplay
from rocalphago_tpu.training import rl as ref_rl
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.features import DEFAULT_FEATURES
from rocalphago_tpu_torch.models import CNNPolicy, NeuralNetBase
from rocalphago_tpu_torch.models.weights import params_from_flax, params_to_flax
from rocalphago_tpu_torch.search import selfplay
from rocalphago_tpu_torch.training import rl
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 7
N = SIZE * SIZE
BATCH = 8
MOVES = 60
TEMP = 0.67
LR = 0.1
KOMI = jaxgo.default_komi(SIZE)
CFG = jaxgo.GoConfig(size=SIZE, komi=KOMI)
TCFG = torchgo.GoConfig(size=SIZE, komi=KOMI)
FEATS = tuple(f for f in DEFAULT_FEATURES if not f.startswith("ladder"))
ATOL = 1e-5           # float32: summation order only
RTOL = 1e-4


@pytest.fixture()
def no_persistent_compile_cache():
    """The reference's RL iteration compiled fresh: on this toolchain
    its executable can come back from the persistent XLA cache giving
    zero updates (``tests/test_rl_trainer.py`` has the same fixture)."""
    from jax._src import compilation_cache as _cc

    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    _cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", old)
    _cc.reset_cache()


@functools.lru_cache(maxsize=None)
def nets():
    """The learner and the opponent: two different 2 × 4 policies of
    the reference in float32, and the port's twins carried across."""
    out = []
    for seed in (21, 22):
        ref = RefPolicy(FEATS, board=SIZE, layers=2, filters_per_layer=4,
                        seed=seed)
        ref.module = ref.module.clone(dtype=jnp.float32)
        out.append(ref)
    return out


def port_net(ref, dtype=torch.float32):
    net = CNNPolicy(FEATS, board=SIZE, layers=2, filters_per_layer=4,
                    init_weights=False, device="cpu", dtype=dtype)
    net.module.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, ref.params)))
    return net


def flat(tree) -> dict:
    """``{"trunk/conv1/kernel": array, ...}`` of a param tree, with or
    without its ``params`` level."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree.get("params", tree))[0]:
        out["/".join(str(getattr(k, "key", k)) for k in path)] = np.asarray(
            leaf, np.float32)
    return out


def assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@functools.lru_cache(maxsize=None)
def reference_iteration():
    """The reference's float32 iteration from key 3: ``(updates per
    lr, metrics, the game result it played)``."""
    learner, opp = nets()
    tx = optax.sgd(LR)
    key = jax.random.key(3)
    state0 = ref_rl.RLState(learner.params, tx.init(learner.params),
                            jnp.int32(0), pack_rng(key))
    with jax.enable_checks(False):
        iteration = ref_rl.make_rl_iteration(
            CFG, FEATS, learner.module.apply, tx, BATCH, MOVES, TEMP)
        new, metrics = jax.jit(iteration)(state0, opp.params)
        # the games it played: the same key split, through play_games
        game_key = jax.random.split(key)[1]
        result = jax.jit(lambda: ref_selfplay.play_games(
            CFG, FEATS, learner.module.apply, learner.params,
            learner.module.apply, opp.params, game_key, BATCH, MOVES,
            TEMP))()
    old, new = flat(learner.params), flat(jax.device_get(new.params))
    grads = {k: (old[k] - new[k]) / LR for k in old}
    return (grads, {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, result))


class Replay:
    """A sampler handing out a recorded action stream, ply by ply."""

    def __init__(self, actions):
        self.actions = actions
        self.t = 0

    def __call__(self, ply, masked, sens, generator):
        a = torch.as_tensor(self.actions[self.t].copy()).int()
        self.t += 1
        return a


def port_iteration(monkeypatch, actions, chunk=0):
    """The port's iteration from the reference's learner on the
    reference's games: ``(updates per lr, metrics)``."""
    learner, opp = nets()
    net, other = port_net(learner), port_net(opp)
    replay = Replay(actions)
    monkeypatch.setattr(selfplay.Ply, "sample", lambda self, m, s, g:
                        replay(self, m, s, g))
    old = {k: v.clone() for k, v in net.module.state_dict().items()}
    opt = torch.optim.SGD(net.module.parameters(), lr=LR)
    it = rl.RLIteration(TCFG, FEATS, net.module, opt, BATCH, MOVES, TEMP,
                        chunk=chunk, device="cpu")
    state = rl.RLState(net.module, opt, torch.Generator().manual_seed(0))
    metrics = it(state, other.module)
    assert replay.t == MOVES and state.iteration == 1
    new = net.module.state_dict()
    grads = flat(params_to_flax({k: (old[k] - new[k]) / LR for k in old}))
    return grads, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("chunk", [0, 7])
def test_iteration_gradient_matches_the_reference(
        monkeypatch, no_persistent_compile_cache, chunk):
    want, want_m, res = reference_iteration()
    moves = res.num_moves
    assert moves.min() < MOVES, "no game ends before the move limit"
    assert (res.actions[res.live] == N).any(), "no pass among live moves"
    got, got_m = port_iteration(monkeypatch, res.actions, chunk)
    assert got.keys() == want.keys()
    moved = 0.0
    for k in want:
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)
        moved = max(moved, float(np.abs(want[k]).max()))
    assert moved > 1e-3
    assert got_m == want_m


def test_learner_outcome_and_metrics():
    """The learner is Black in games [0:B/2] and White after: its z is
    the winner there and minus the winner here; draws are left out of
    the win rate."""
    winners = torch.tensor([1, -1, 0, 1, 1, -1, 0, -1], dtype=torch.int32)
    z = rl._learner_z(winners, 4)
    assert z.tolist() == [1, -1, 0, 1, -1, 1, 0, 1]
    m = rl._metrics(z, torch.arange(8, dtype=torch.int32))
    assert {k: float(v) for k, v in m.items()} == pytest.approx(
        {"win_rate": 4 / 6, "draw_rate": 0.25, "mean_moves": 3.5})
    m = rl._metrics(torch.zeros(4), torch.zeros(4, dtype=torch.int32))
    assert float(m["win_rate"]) == 0.5 and float(m["draw_rate"]) == 1.0


def test_chunked_iteration_equals_monolithic():
    learner, opp = nets()
    runs = []
    for chunk in (0, 7):
        net, other = port_net(learner), port_net(opp)
        opt = torch.optim.SGD(net.module.parameters(), lr=LR)
        it = rl.RLIteration(TCFG, FEATS, net.module, opt, BATCH, MOVES,
                            TEMP, chunk=chunk, device="cpu")
        state = rl.RLState(net.module, opt, torch.Generator().manual_seed(4))
        metrics = [it(state, other.module) for _ in range(2)]
        runs.append((net.module.state_dict(), state.generator.get_state(),
                     metrics))
    (pa, ga, ma), (pb, gb, mb) = runs
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert torch.equal(ga, gb)
    assert [{k: float(v) for k, v in m.items()} for m in ma] == \
        [{k: float(v) for k, v in m.items()} for m in mb]
    with pytest.raises(ValueError, match="even"):
        rl.RLIteration(TCFG, FEATS, None, None, 3, 10, 1.0, device="cpu")


def template(src):
    ref = RefPolicy(FEATS, board=SIZE, layers=2, filters_per_layer=4)
    ref.params = src.params
    return ref


def write_pool(tmp_path, iters):
    """Snapshots at ``iters`` in both packages' pools: the port writes
    its own, the reference its own, from the same params."""
    learner, opp = nets()
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    # the reference's pool writes through its net's params slot: a
    # template of its own, so the cached nets stay as they are
    ref_pool = ref_rl.OpponentPool(ref_dir, template(learner))
    port_pool = rl.OpponentPool(port_dir, port_net(learner))
    for i, it in enumerate(iters):
        src = opp if i % 2 else learner
        ref_pool.add(src.params, it)
        port_pool.add(port_net(src).module.state_dict(), it)
    return ref_pool, port_pool


def test_opponent_pool_draws_and_snapshots_cross(tmp_path):
    ref_pool, port_pool = write_pool(tmp_path, [2, 4, 6, 8])
    assert [os.path.basename(p) for p in port_pool.snapshots()] == \
        [os.path.basename(p) for p in ref_pool.snapshots()]
    pairs = [(s, it) for s in (0, 7, 1234) for it in (0, 1, 3, 5, 9)][:10]
    names = set()
    for seed, it in pairs:
        for save_every in (None, 2):
            want = ref_pool.sample(seed, it, save_every=save_every)
            got = port_pool.sample(seed, it, save_every=save_every)
            assert got[1] == want[1], (seed, it, save_every)
            names.add(got[1])
            # the port's draw equals the reference's file's params
            assert_same(flat(params_to_flax(got[0])), flat(want[0]))
    assert len(names) > 2
    # each reads the other's files
    port_reads_ref = rl.OpponentPool(ref_pool.directory, port_net(
        nets()[0]))
    ref_reads_port = ref_rl.OpponentPool(port_pool.directory,
                                         template(nets()[0]), write=False)
    for seed, it in pairs:
        a = port_reads_ref.sample(seed, it, 2)
        b = ref_reads_port.sample(seed, it, 2)
        assert a[1] == b[1]
        assert_same(flat(params_to_flax(a[0])), flat(b[0]))
    with pytest.raises(FileNotFoundError, match="save-every"):
        port_pool.sample(0, 12, save_every=3)


# ------------------------------------------------------------- trainer


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    """The learner saved as a spec (the CLI loads it in bfloat16)."""
    path = str(tmp_path_factory.mktemp("spec") / "policy.json")
    port_net(nets()[0]).save_model(path)
    return path


def cli(spec, out, iterations, *extra):
    return rl.run_training([spec, out, "--game-batch", "4",
                            "--iterations", str(iterations),
                            "--save-every", "2", "--move-limit", "16",
                            "--seed", "5", "--learning-rate", "0.05",
                            "--device", "cpu", *extra])


def final_state(out, it=4):
    path = os.path.join(out, "checkpoints", str(it), "state.pt")
    return torch.load(path, map_location="cpu", weights_only=True)


def same_state(a, b):
    return (a["iteration"] == b["iteration"]
            and torch.equal(a["rng"], b["rng"])
            and all(torch.equal(a["params"][k], b["params"][k])
                    for k in a["params"]))


def test_trainer_resume_and_chunks_are_bit_identical(tmp_path, spec,
                                                     monkeypatch):
    straight = str(tmp_path / "straight")
    final = cli(spec, straight, 4)
    want = final_state(straight)
    assert final["iteration"] == 3 and 0.0 <= final["win_rate"] <= 1.0
    with open(os.path.join(straight, "metadata.json")) as f:
        meta = json.load(f)
    assert [e["iteration"] for e in meta["epochs"]] == [0, 1, 2, 3]
    assert meta["config"]["komi"] == KOMI
    assert sorted(os.listdir(os.path.join(straight, "opponents"))) == [
        f"opponent.{i:05d}.flax.msgpack" for i in (0, 2, 4)]
    for name in ("model.json", "weights.00002.flax.msgpack",
                 "weights.00004.flax.msgpack", "metrics.jsonl"):
        assert os.path.exists(os.path.join(straight, name)), name
    start = torch.load(os.path.join(straight, "checkpoints", "2",
                                    "state.pt"), weights_only=True)
    assert not all(torch.equal(start["params"][k], want["params"][k])
                   for k in want["params"])

    # killed between iterations (after 3, a checkpoint there) and resumed
    out = str(tmp_path / "killed")
    cli(spec, out, 3)
    cli(spec, out, 4)
    assert same_state(final_state(out), want)
    with open(os.path.join(out, "metadata.json")) as f:
        assert [e["iteration"] for e in json.load(f)["epochs"]] == \
            [0, 1, 2, 3]

    # killed inside iteration 3 (the checkpoint is at 2) and resumed
    out = str(tmp_path / "killed_inside")
    calls = [0]
    real = rl.RLIteration.update

    def killing_update(self):
        if calls[0] == 3:
            raise KeyboardInterrupt("killed")
        calls[0] += 1
        real(self)

    monkeypatch.setattr(rl.RLIteration, "update", killing_update)
    with pytest.raises(KeyboardInterrupt):
        cli(spec, out, 4)
    monkeypatch.setattr(rl.RLIteration, "update", real)
    trainer = rl.RLTrainer(rl.RLConfig(
        model_json=spec, out_dir=out, game_batch=4, iterations=4,
        save_every=2, move_limit=16, seed=5, learning_rate=0.05,
        device="cpu"))
    assert trainer.start_iteration == 2
    trainer.run()
    assert same_state(final_state(out), want)

    # segments of 5 plies: the same bits
    chunked = str(tmp_path / "chunked")
    cli(spec, chunked, 4, "--chunk", "5")
    assert same_state(final_state(chunked), want)

    # the export loads in the reference (float32 params, equal) and in
    # the port's player
    ref = RefNet.load_model(os.path.join(straight, "model.json"))
    port = NeuralNetBase.load_model(os.path.join(straight, "model.json"),
                                    device="cpu")
    assert_same(flat(ref.params),
                flat(params_to_flax(port.module.state_dict())))
    assert all(torch.equal(port.module.state_dict()[k], want["params"][k])
               for k in want["params"])
