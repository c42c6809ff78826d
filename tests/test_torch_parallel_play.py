"""Sharded self-play, search self-play, the RL iteration and the zero
loop over two ranks (``mesh=``, ``--shard``, ``--num-devices 2``),
against the reference's sharded runs and the port's one-rank runs, on
the CPU.

The port runs two gloo ranks, each a child process over a file store
(``parallel.launch.spawn_ranks``; the ``_rank_*`` functions import
nothing of JAX); the reference runs in this process on its
``make_mesh(2)`` over the 8 virtual CPU devices of
``tests/conftest.py``. Torch cannot reproduce JAX's draws, so:

* the reference's sharded policy self-play is replayed, action by
  action, through each rank's share of the port's sharded ply: final
  states, ``live`` and winners bit-equal;
* the port's sharded runs (policy self-play, search self-play with
  root noise, forced playouts and per-game playout caps, Gumbel search
  self-play, the zero actor's play, the self-play CLI's SGFs) are the
  one-rank run's bit for bit: each rank draws for the global batch and
  takes its rows;
* the RL iteration and the zero learner, given the reference's games,
  update within ``ATOL + RTOL·|x|`` of the reference's sharded update
  (summation order), with metrics equal (RL) or within
  ``METRIC_RTOL`` (zero, as the reference's own test holds them);
* the trainers' CLIs over two ranks against one rank (their specs load
  in bfloat16): the first update within ``BF16_RTOL`` of its net's
  largest update (biases ``BF16_BIAS_RTOL``), the first iteration's game
  statistics equal, rank 0 alone writing; the zero CLI's ``--actor-learner`` run (the
  rank-ordered dispatch gang) the synchronous two-rank run bit for bit.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from rocalphago_tpu_torch.data.replay import ZeroGames
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.features import DEFAULT_FEATURES
from rocalphago_tpu_torch.interface import selfplay_cli
from rocalphago_tpu_torch.io.checkpoint import TrainCheckpointer
from rocalphago_tpu_torch.models import CNNPolicy, CNNValue
from rocalphago_tpu_torch.models.weights import params_from_flax
from rocalphago_tpu_torch.parallel import mesh as meshlib
from rocalphago_tpu_torch.parallel.launch import spawn_ranks
from rocalphago_tpu_torch.search import device_mcts, selfplay
from rocalphago_tpu_torch.training import rl, zero

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PUCT = os.path.join(ROOT, "results/zero_r5/target_compare/puct")
SIZE = 5
N = SIZE * SIZE
BATCH = 8
MAX_MOVES = 64
CHUNK = 8
TEMP = 0.8
KOMI = 7.0
TCFG = torchgo.GoConfig(size=SIZE, komi=KOMI)
FEATS = tuple(f for f in DEFAULT_FEATURES if not f.startswith("ladder"))
ZFEATS = ("board", "ones", "liberties")
ZVFEATS = ZFEATS + ("color",)
RL_MOVES = 60
LR = 0.1
ATOL = 1e-5           # float32: summation order only
RTOL = 1e-4
METRIC_RTOL = 1e-5
PI_ATOL = 1e-6        # a π′ entry, one batch size against another
# the CLIs load their specs in bfloat16: an update held to this share of
# the largest update of its net, a bias (one bf16 sum over a channel's
# outputs) to the second (test_torch_sl.py's bfloat16 step)
BF16_RTOL, BF16_BIAS_RTOL = 2e-2, 0.15


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ranks(target: str, tmp_path, n: int = 2, **kwargs) -> list:
    return spawn_ranks(f"{__name__}:{target}", n,
                       str(tmp_path / f"ranks-{target}"), kwargs,
                       device="cpu", paths=(HERE,), timeout=240)


def ref_policies(feats=FEATS, seeds=(11, 12)):
    """Two different 2 × 8 float32 policies of the reference."""
    import jax.numpy as jnp

    from rocalphago_tpu.models import CNNPolicy as RefPolicy

    out = []
    for seed in seeds:
        ref = RefPolicy(feats, board=SIZE, layers=2, filters_per_layer=8,
                        seed=seed)
        ref.module = ref.module.clone(dtype=jnp.float32)
        out.append(ref)
    return out


def state_dict_of(ref) -> dict:
    import jax

    return params_from_flax(jax.tree.map(np.asarray, ref.params))


def port_policy(params: dict, feats=FEATS):
    net = CNNPolicy(feats, board=SIZE, layers=2, filters_per_layer=8,
                    init_weights=False, device="cpu", dtype=torch.float32)
    net.module.load_state_dict(params)
    return net


def seeded_nets(aux: bool = False):
    """A seeded 2 × 8 policy and value pair of the port (float32)."""
    pol = CNNPolicy(ZFEATS, board=SIZE, layers=2, filters_per_layer=8,
                    seed=31, device="cpu", dtype=torch.float32)
    val = CNNValue(ZVFEATS, board=SIZE, layers=2, filters_per_layer=8,
                   seed=32, device="cpu", dtype=torch.float32,
                   **({"aux_heads": ("ownership", "score")} if aux else {}))
    return pol, val


def as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, tuple):
        return type(x)(*(as_numpy(v) for v in x)) if hasattr(
            x, "_fields") else tuple(as_numpy(v) for v in x)
    return x


def assert_same_tree(got, want, what: str) -> None:
    """Equal arrays, field by field (named tuples) or item by item."""
    if want is None:
        assert got is None, what
        return
    if isinstance(want, tuple):
        names = getattr(want, "_fields", range(len(want)))
        for name, g, w in zip(names, got, want):
            assert_same_tree(g, w, f"{what}.{name}")
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


# ----------------------------------------------------- policy self-play


def _rank_policy_selfplay(params_a, params_b, seed, replay=None) -> dict:
    mesh = meshlib.make_mesh(2, "cpu")
    a, b = port_policy(params_a), port_policy(params_b)
    run = selfplay.make_selfplay_chunked(
        TCFG, FEATS, a.module, b.module, BATCH, MAX_MOVES, chunk=CHUNK,
        temperature=TEMP, device="cpu", mesh=mesh)
    out = {}
    if replay is not None:
        # this rank's games of the reference's action stream
        local = iter(torch.as_tensor(mesh.take(replay, 1, "halves")))
        run.ply.sample = lambda masked, sens, generator: next(local).int()
    res = run(torch.Generator().manual_seed(seed), stop_when_done=True)
    out["local"] = as_numpy(res)
    out["gathered"] = as_numpy(selfplay.gather_result(mesh, res))
    if replay is None:
        mono = selfplay.play_games(TCFG, FEATS, a.module, b.module,
                                   torch.Generator().manual_seed(seed),
                                   BATCH, MAX_MOVES, TEMP, device="cpu",
                                   mesh=mesh)
        out["mono"] = as_numpy(selfplay.gather_result(mesh, mono))
    return out


def test_sharded_policy_selfplay_is_the_one_rank_run(tmp_path):
    refs = ref_policies()
    params = [state_dict_of(r) for r in refs]
    outs = ranks("_rank_policy_selfplay", tmp_path, params_a=params[0],
                 params_b=params[1], seed=5)
    a, b = (port_policy(p) for p in params)
    want = as_numpy(selfplay.make_selfplay_chunked(
        TCFG, FEATS, a.module, b.module, BATCH, MAX_MOVES, chunk=CHUNK,
        temperature=TEMP, device="cpu")(torch.Generator().manual_seed(5),
                                        stop_when_done=True))
    mono = as_numpy(selfplay.play_games(
        TCFG, FEATS, a.module, b.module, torch.Generator().manual_seed(5),
        BATCH, MAX_MOVES, TEMP, device="cpu"))
    assert want.num_moves.min() < MAX_MOVES, "no game ends early"
    for r, o in enumerate(outs):
        assert_same_tree(o["gathered"], want, f"rank {r}")
        assert_same_tree(o["mono"], mono, f"rank {r} monolithic")
        # rank r holds global games [2r, 2r+2) and [4+2r, 4+2r+2)
        rows = [2 * r, 2 * r + 1, 4 + 2 * r, 4 + 2 * r + 1]
        np.testing.assert_array_equal(o["local"].actions,
                                      want.actions[:, rows])
        np.testing.assert_array_equal(o["local"].winners, want.winners[rows])


def test_sharded_selfplay_replays_the_references_sharded_games(tmp_path):
    import jax

    from rocalphago_tpu.parallel import mesh as ref_mesh
    from rocalphago_tpu.search import selfplay as ref_selfplay

    refs = ref_policies()
    from rocalphago_tpu.engine import jaxgo

    with jax.enable_checks(False):
        run = ref_selfplay.make_selfplay_chunked(
            jaxgo.GoConfig(size=SIZE, komi=KOMI), FEATS,
            refs[0].module.apply, refs[1].module.apply, batch=BATCH,
            max_moves=MAX_MOVES, chunk=CHUNK, temperature=TEMP,
            incremental=False, mesh=ref_mesh.make_mesh(2))
        want = jax.tree.map(np.asarray, run(
            refs[0].params, refs[1].params, jax.random.key(3),
            stop_when_done=True))
    assert want.num_moves.min() < MAX_MOVES
    outs = ranks("_rank_policy_selfplay", tmp_path,
                 params_a=state_dict_of(refs[0]),
                 params_b=state_dict_of(refs[1]), seed=0,
                 replay=want.actions)
    for r, o in enumerate(outs):
        got = o["gathered"]
        np.testing.assert_array_equal(got.live, want.live, err_msg=str(r))
        np.testing.assert_array_equal(got.winners, want.winners)
        np.testing.assert_array_equal(got.num_moves, want.num_moves)
        for name in ("board", "turn", "done", "step_count", "labels"):
            np.testing.assert_array_equal(
                getattr(got.final, name), getattr(want.final, name),
                err_msg=name)
        np.testing.assert_array_equal(got.final.hash,
                                      want.final.hash.astype(np.int64))


def test_the_batch_must_split_over_both_halves():
    import jax.numpy as jnp  # noqa: F401 -- the reference's mesh below

    from rocalphago_tpu.engine import jaxgo
    from rocalphago_tpu.parallel import mesh as ref_mesh
    from rocalphago_tpu.search import selfplay as ref_selfplay

    ref = ref_policies(seeds=(11,))[0]
    with pytest.raises(ValueError) as want:
        ref_selfplay.make_selfplay_chunked(
            jaxgo.GoConfig(size=SIZE), FEATS, ref.module.apply,
            ref.module.apply, batch=6, max_moves=4, chunk=2,
            mesh=ref_mesh.make_mesh(2))
    net = port_policy(state_dict_of(ref))
    fake = meshlib.Mesh(2, 0, torch.device("cpu"))
    with pytest.raises(ValueError) as got:
        selfplay.make_selfplay_chunked(TCFG, FEATS, net.module, net.module,
                                       batch=6, max_moves=4, chunk=2,
                                       device="cpu", mesh=fake)
    assert str(got.value) == str(want.value)
    assert "data-axis" in str(got.value)
    with pytest.raises(ValueError, match="data-axis"):
        rl.RLIteration(TCFG, FEATS, net.module, None, 6, 4, 1.0,
                       device="cpu", mesh=fake)


# ------------------------------------------------------ the CLI, --shard


def _rank_selfplay_cli(argv) -> dict:
    return selfplay_cli.main(argv)


def test_selfplay_cli_shard_writes_the_one_rank_games(tmp_path):
    argv = ["--policy", os.path.join(PUCT, "policy.json"), "--games", "4",
            "--max-moves", "30", "--chunk", "10", "--seed", "4",
            "--device", "cpu"]
    outs = ranks("_rank_selfplay_cli", tmp_path,
                 argv=argv + ["--shard", "--out", str(tmp_path / "two")])
    one = selfplay_cli.main(argv + ["--out", str(tmp_path / "one")])
    keys = ("games", "black_wins", "white_wins", "draws", "mean_moves")
    for o in outs:
        assert {k: o[k] for k in keys} == {k: one[k] for k in keys}
    assert outs[0]["sgf_files"] == 4 and "sgf_files" not in outs[1]
    names = sorted(os.listdir(tmp_path / "one"))
    assert sorted(os.listdir(tmp_path / "two")) == names
    for name in names:
        if name.endswith(".sgf"):
            assert (tmp_path / "two" / name).read_bytes() == \
                (tmp_path / "one" / name).read_bytes(), name
    summary = json.loads((tmp_path / "two" / "summary.json").read_text())
    assert {k: summary[k] for k in keys} == {k: one[k] for k in keys}
    with pytest.raises(SystemExit, match="no --opponent/--shard"):
        selfplay_cli.main(argv + ["--shard", "--search-sims", "4",
                                  "--value", os.path.join(PUCT, "value.json"),
                                  "--out", str(tmp_path / "x")])


# ------------------------------------------------------ search self-play


def _rank_search_selfplay(pol_params, val_params, aux) -> dict:
    mesh = meshlib.make_mesh(2, "cpu")
    pol, val = seeded_nets(aux)
    pol.module.load_state_dict(pol_params)
    val.module.load_state_dict(val_params)
    return search_runs(pol, val, mesh)


def search_runs(pol, val, mesh=None) -> dict:
    """PUCT with root noise, forced playouts and per-game caps through
    the zero actor's ``play``; Gumbel with sampled moves; each gathered
    (one rank: as played)."""
    out = {}
    it = zero.ZeroIteration(
        TCFG, ZFEATS, ZVFEATS, batch=4, move_limit=10, n_sim=6,
        dirichlet_alpha=0.3, forced_k=2.0, cap_p=0.5, cap_cheap=2,
        cap_per_row=True, aux_weight=0.5, device="cpu", mesh=mesh)
    games = it.play(pol.module, val.module, 77)
    if mesh is not None:
        games = ZeroGames(*(None if x is None else mesh.gather(
            x, 1 if x.dim() > 1 and k in ("actions", "live", "visits",
                                          "full") else 0)
                            for k, x in zip(ZeroGames._fields, games)))
    out["zero"] = as_numpy(tuple(games))
    run = device_mcts.make_mcts_selfplay(
        TCFG, ZFEATS, ZVFEATS, pol.module, val.module, batch=4,
        max_moves=8, n_sim=6, gumbel=True, m_root=4, gumbel_sample=True,
        record_visits=True, device="cpu", mesh=mesh)
    final, actions, live, targets = run(torch.Generator().manual_seed(9))
    if mesh is not None:
        final = torchgo.GoState(*(mesh.gather(x) for x in final))
        actions, live, targets = (mesh.gather(x, 1)
                                  for x in (actions, live, targets))
    out["gumbel"] = as_numpy((tuple(final), actions, live, targets))
    return out


def test_sharded_search_selfplay_is_the_one_rank_run(tmp_path):
    pol, val = seeded_nets(aux=True)
    outs = ranks("_rank_search_selfplay", tmp_path,
                 pol_params=pol.module.state_dict(),
                 val_params=val.module.state_dict(), aux=True)
    want = search_runs(pol, val)
    assert want["zero"][1].any(axis=0).all()      # every game was live
    for r, o in enumerate(outs):
        assert_same_tree(o["zero"], want["zero"], f"rank {r} zero play")
        # the moves and states exact; π′ within PI_ATOL (the value
        # net's dense head rounds a row by its batch size)
        assert_same_tree(o["gumbel"][:3], want["gumbel"][:3],
                         f"rank {r} gumbel")
        np.testing.assert_allclose(o["gumbel"][3], want["gumbel"][3],
                                   rtol=0, atol=PI_ATOL)


# ------------------------------------------------------------ RL, 2 ranks


def reference_rl_iteration(refs):
    """The reference's float32 iteration over its ``make_mesh(2)``:
    ``(updates per lr, metrics, the games)``."""
    import jax
    import jax.numpy as jnp
    import optax

    from rocalphago_tpu.engine import jaxgo
    from rocalphago_tpu.io.checkpoint import pack_rng
    from rocalphago_tpu.parallel import mesh as ref_mesh
    from rocalphago_tpu.search import selfplay as ref_selfplay
    from rocalphago_tpu.training import rl as ref_rl

    learner, opp = refs
    cfg = jaxgo.GoConfig(size=SIZE, komi=KOMI)
    tx = optax.sgd(LR)
    key = jax.random.key(3)
    state0 = ref_rl.RLState(learner.params, tx.init(learner.params),
                            jnp.int32(0), pack_rng(key))
    with jax.enable_checks(False):
        iteration = ref_rl.make_rl_iteration(
            cfg, FEATS, learner.module.apply, tx, BATCH, RL_MOVES, TEMP,
            mesh=ref_mesh.make_mesh(2))
        new, metrics = jax.jit(iteration)(state0, opp.params)
        game_key = jax.random.split(key)[1]
        result = jax.jit(lambda: ref_selfplay.play_games(
            cfg, FEATS, learner.module.apply, learner.params,
            learner.module.apply, opp.params, game_key, BATCH, RL_MOVES,
            TEMP))()
    old = state_dict_of(learner)
    new_sd = params_from_flax(jax.tree.map(np.asarray,
                                           jax.device_get(new.params)))
    return ({k: (old[k] - new_sd[k]) / LR for k in old},
            {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, result))


def _rank_rl_iteration(learner, opponent, actions) -> dict:
    mesh = meshlib.make_mesh(2, "cpu")
    net, other = port_policy(learner), port_policy(opponent)
    local = iter(torch.as_tensor(mesh.take(actions, 1, "halves")))
    selfplay.Ply.sample = lambda self, masked, sens, generator: \
        next(local).int()
    old = {k: v.clone() for k, v in net.module.state_dict().items()}
    opt = torch.optim.SGD(net.module.parameters(), lr=LR)
    it = rl.RLIteration(TCFG, FEATS, net.module, opt, BATCH, RL_MOVES, TEMP,
                        device="cpu", mesh=mesh)
    state = rl.RLState(net.module, opt, torch.Generator().manual_seed(0))
    metrics = it(state, other.module)
    new = net.module.state_dict()
    return {"grads": {k: (old[k] - new[k]) / LR for k in old},
            "metrics": {k: float(v) for k, v in metrics.items()}}


def test_rl_iteration_over_two_ranks_matches_the_reference(tmp_path):
    refs = ref_policies(seeds=(21, 22))
    want, want_m, games = reference_rl_iteration(refs)
    assert games.num_moves.min() < RL_MOVES, "no game ends early"
    outs = ranks("_rank_rl_iteration", tmp_path,
                 learner=state_dict_of(refs[0]),
                 opponent=state_dict_of(refs[1]), actions=games.actions)
    moved = 0.0
    for o in outs:
        assert o["metrics"] == want_m
        for k in want:
            np.testing.assert_allclose(o["grads"][k].numpy(),
                                       want[k].numpy(), atol=ATOL,
                                       rtol=RTOL, err_msg=k)
            moved = max(moved, float(want[k].abs().max()))
    assert moved > 1e-3
    for k in want:
        assert torch.equal(outs[0]["grads"][k], outs[1]["grads"][k]), k


def rl_argv(spec, out, *extra):
    return [spec, out, "--game-batch", "4", "--iterations", "2",
            "--save-every", "1", "--move-limit", "12", "--seed", "2",
            "--learning-rate", "0.1", "--device", "cpu", *extra]


def _rank_rl_cli(argv) -> dict:
    return rl.run_training(argv)


def test_rl_trainer_over_two_ranks(tmp_path):
    net = CNNPolicy(FEATS, board=SIZE, layers=2, filters_per_layer=8,
                    seed=3, device="cpu", dtype=torch.float32)
    spec = str(tmp_path / "policy.json")
    net.save_model(spec)
    two, one = str(tmp_path / "two"), str(tmp_path / "one")
    outs = ranks("_rank_rl_cli", tmp_path,
                 argv=rl_argv(spec, two, "--num-devices", "2"))
    want = rl.run_training(rl_argv(spec, one))
    for k in ("iteration", "opponent", "win_rate", "mean_moves"):
        assert outs[0][k] == outs[1][k], k
    for k in ("iteration", "opponent"):
        assert outs[0][k] == want[k]
    rows = {}
    for name, d in (("one", one), ("two", two)):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            rows[name] = [json.loads(x) for x in f]
        rows[name] = [r for r in rows[name] if r["event"] == "iteration"]
    assert len(rows["two"]) == 2        # rank 1 wrote no rows
    for k in ("win_rate", "mean_moves", "opponent"):
        assert rows["two"][0][k] == rows["one"][0][k], k
    # the first update within tolerance (the second's games may part
    # where its last bits flip a sampled move)
    got = TrainCheckpointer(os.path.join(two, "checkpoints")).restore(1)[0]
    ref = TrainCheckpointer(os.path.join(one, "checkpoints")).restore(1)[0]
    assert got["iteration"] == ref["iteration"] == 1
    assert_bf16_updates(got["params"], ref["params"], net.module.state_dict())
    assert sorted(os.listdir(os.path.join(two, "opponents"))) == \
        sorted(os.listdir(os.path.join(one, "opponents")))


# ------------------------------------------------------- zero, 2 ranks


def _shard_games(mesh, games: ZeroGames) -> ZeroGames:
    """This rank's block of a host record: axis 1 of the time-major
    fields, axis 0 of the per-game ones."""
    time_major = ("actions", "live", "visits", "full")
    return ZeroGames(*(meshlib.shard_batch(
        mesh, x, axis=1 if k in time_major else 0)
        for k, x in zip(ZeroGames._fields, games)))


def _rank_zero_learn_impl(pol_params, val_params, games, aux, kw) -> dict:
    mesh = meshlib.make_mesh(2, "cpu")
    pol = CNNPolicy(ZFEATS, board=SIZE, layers=2, filters_per_layer=8,
                    init_weights=False, device="cpu", dtype=torch.float32)
    val = CNNValue(ZVFEATS, board=SIZE, layers=2, filters_per_layer=8,
                   init_weights=False, device="cpu", dtype=torch.float32,
                   **({"aux_heads": ("ownership", "score")} if aux else {}))
    pol.module.load_state_dict(pol_params)
    val.module.load_state_dict(val_params)
    it = zero.ZeroIteration(TCFG, ZFEATS, ZVFEATS, batch=4, move_limit=14,
                            replay_chunk=14, device="cpu", mesh=mesh, **kw)
    state = zero.init_zero_state(pol.module, val.module, LR)
    old = [{k: v.clone() for k, v in m.state_dict().items()}
           for m in (pol.module, val.module)]
    state, m = it.learn(state, _shard_games(mesh, games))
    ups = [{k: (o[k] - v) / LR for k, v in mod.state_dict().items()}
           for o, mod in zip(old, (pol.module, val.module))]
    return {"updates": ups, "metrics": zero.metrics_to_host(m)}


@pytest.mark.parametrize("variant", ["puct_visits", "forced_caps_aux"])
def test_zero_learn_over_two_ranks_matches_the_reference(tmp_path, variant):
    """The reference's sharded ``learn`` (its ``make_mesh(2)``) and the
    port's over two ranks on ``test_torch_zero.py``'s record (finished
    and move-capped games, passes, forced-pass plies): both nets'
    updates within tolerance, the metrics within ``METRIC_RTOL``."""
    import functools

    import jax
    import optax

    import test_torch_zero as tz
    from rocalphago_tpu.parallel import mesh as ref_mesh
    from rocalphago_tpu.training import zero as ref_zero

    targets, caps, aux = tz.VARIANTS[variant]
    games = tz.make_record(7, targets, aux)
    pol, val = tz.ref_nets(aux)
    tx = optax.sgd(LR)
    kw = tz.econ_kw(caps, aux)
    mesh = ref_mesh.make_mesh(2)
    with jax.enable_checks(False):
        it = ref_zero.make_zero_iteration(
            tz.CFG, tz.FEATS, tz.VFEATS, pol.module.apply, val.module.apply,
            tx, tx, batch=tz.BATCH, move_limit=tz.MOVES,
            replay_chunk=tz.MOVES, mesh=mesh,
            value_apply_aux=(functools.partial(val.module.apply,
                                               with_aux=True)
                             if aux else None), **kw)
        state = ref_mesh.replicate(mesh, ref_zero.init_zero_state(
            pol.params, val.params, tx, tx))
        new, want_m = it.learn(state, ref_zero.ZeroGames(*games))
        new = jax.device_get(new)
    want = []
    for old, upd in ((pol.params, new.policy_params),
                     (val.params, new.value_params)):
        o, n = (params_from_flax(jax.tree.map(np.asarray, t))
                for t in (old, upd))
        want.append({k: (o[k] - n[k]) / LR for k in o})
    port_pol, port_val = tz.port_nets(aux)
    outs = ranks("_rank_zero_learn_impl", tmp_path,
                 pol_params=port_pol.module.state_dict(),
                 val_params=port_val.module.state_dict(), games=games,
                 aux=aux, kw=kw)
    want_m = {k: float(v) for k, v in want_m.items()}
    for o in outs:
        assert o["metrics"].keys() == want_m.keys()
        for k, v in want_m.items():
            np.testing.assert_allclose(o["metrics"][k], v,
                                       rtol=METRIC_RTOL, atol=1e-7,
                                       err_msg=k)
        for got_net, want_net in zip(o["updates"], want):
            for k in want_net:
                np.testing.assert_allclose(
                    got_net[k].numpy(), want_net[k].numpy(), atol=ATOL,
                    rtol=RTOL, err_msg=k)
    assert outs[0]["metrics"] == outs[1]["metrics"]


def zero_argv(specs, out, *extra):
    return [*specs, out, "--game-batch", "4", "--sims", "4",
            "--move-limit", "10", "--iterations", "2", "--save-every", "1",
            "--gate-every", "2", "--gate-games", "4", "--seed", "3",
            "--learning-rate", "0.05", "--cap-p", "0.5", "--cap-cheap", "2",
            "--aux-weight", "0.5", "--device", "cpu", *extra]


def _rank_zero_cli(specs, work) -> dict:
    out = {}
    for name, extra in (("sync", ()), ("al", ("--actor-learner",))):
        out[name] = zero.run_training(zero_argv(
            specs, os.path.join(work, name), "--num-devices", "2", *extra))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out["odd"] = zero.run_training(zero_argv(
            specs, os.path.join(work, "odd"), "--game-batch", "3"))
    out["odd_stderr"] = err.getvalue()
    return out


def assert_bf16_updates(got: dict, want: dict, start: dict) -> None:
    """Two bfloat16 updates from ``start`` (state dicts) agree (no
    update at all where ``want`` has none: the value net's with every
    game move-capped)."""
    scale = max(float((want[k] - start[k]).abs().max()) for k in start)
    for k in start:
        tol = (BF16_BIAS_RTOL if start[k].dim() == 1 else BF16_RTOL) * scale
        np.testing.assert_allclose((got[k] - start[k]).numpy(),
                                   (want[k] - start[k]).numpy(), rtol=0,
                                   atol=tol, err_msg=k)


def checkpoint(out: str, step: int = 2) -> dict:
    return TrainCheckpointer(os.path.join(out, "checkpoints")).restore(
        step)[0]


def test_zero_cli_over_two_ranks(tmp_path):
    """``--num-devices 2`` over two ranks against one rank (the first
    iteration's bfloat16 update within tolerance and its game
    statistics equal;
    the second's games may part where the first update's last bits
    flip a sampled move; rank 0's files alone), ``--actor-learner`` over two ranks the
    synchronous two-rank run bit for bit, and a game batch of 3 reduced
    to one rank with the reference's notice."""
    d = tmp_path / "specs"
    d.mkdir()
    pol, val = seeded_nets(aux=True)
    specs = (str(d / "policy.json"), str(d / "value.json"))
    pol.save_model(specs[0])
    val.save_model(specs[1])
    work = str(tmp_path / "two")
    outs = ranks("_rank_zero_cli", tmp_path, specs=specs, work=work)
    one = str(tmp_path / "one")
    zero.run_training(zero_argv(specs, one))
    assert "zero: using 1/2 devices (--game-batch 3" in outs[0]["odd_stderr"]
    sync, al = checkpoint(os.path.join(work, "sync")), checkpoint(
        os.path.join(work, "al"))
    first, want = checkpoint(os.path.join(work, "sync"), 1), checkpoint(
        one, 1)
    for name, net in (("policy", pol), ("value", val)):
        for k in want[name]:
            assert torch.equal(sync[name][k], al[name][k]), (name, k)
        assert_bf16_updates(first[name], want[name], net.module.state_dict())
    assert not torch.equal(first["policy"]["head.conv.weight"],
                           pol.module.state_dict()["head.conv.weight"])
    rows = {}
    for name, path in (("one", one), ("sync", os.path.join(work, "sync"))):
        with open(os.path.join(path, "metrics.jsonl")) as f:
            rows[name] = [r for r in map(json.loads, f)
                          if r["event"] == "iteration"]
    assert len(rows["sync"]) == 2       # rank 1 wrote no rows
    for k in ("black_win_rate", "draw_rate", "mean_moves", "finished_rate"):
        assert rows["sync"][0][k] == rows["one"][0][k], k
    for k in ("policy_loss", "value_loss", "value_mse", "value_acc"):
        np.testing.assert_allclose(rows["sync"][0][k], rows["one"][0][k],
                                   rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
    for k, v in outs[0]["sync"].items():
        if k != "games_per_min":
            assert outs[1]["sync"][k] == v, k
    assert outs[0]["al"]["iteration"] == outs[0]["sync"]["iteration"] == 1
