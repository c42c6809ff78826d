"""The port's AlphaZero loop (``rocalphago_tpu_torch/training/zero.py``)
against the reference's ``training/zero.py``, on the CPU.

* ``learn``: the reference's float32 ``learn`` and the port's on the
  same game record (seeded play through the port's engine, with
  hand-made search targets), both nets carried across with
  ``models/weights.py``. The updates ``(old − new) / lr`` of both nets
  agree within ``ATOL + RTOL·|x|`` (summation order only) and the
  metrics within ``METRIC_RTOL``, for int32 visit counts, π′-like
  float32 targets with the playout-cap mask, and pruned float32 targets
  with the mask and the auxiliary heads on. The record holds finished
  and move-capped games, passes, forced-pass plies (no board mass) and
  plies whose board mass is under 1e-3.
* ``play``: with the reference's budget uniforms and moves handed to the
  port (its Bernoulli is ``u < p``), the port's record -- visits,
  ``full``, winners, finished, ownership and score -- is the
  reference's bit for bit (the reference's fakes at 5×5).
* ``iteration == learn(play(...))`` on the chain's game seed, and a
  replay in segments equals one segment, bit for bit.
* The gate: ``decide`` equals the reference's over a table of tallies,
  ``sample`` names the reference's snapshot for (seed, iteration)
  pairs, a pair the port promotes loads in the reference, and the
  committed ``results/zero_r5/run/pool`` loads in the port.
* The CLI: a run killed inside an iteration and resumed ends on the
  straight run's checkpoint, exports, pool and metric rows; its exports
  load in the reference with the same forward; ``--actor-learner
  --actors 1`` is the synchronous run bit for bit.
"""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rocalphago_tpu.engine import jaxgo
from rocalphago_tpu.models import CNNPolicy as RefPolicy
from rocalphago_tpu.models import CNNValue as RefValue
from rocalphago_tpu.models import NeuralNetBase as RefNet
from rocalphago_tpu.training import zero as ref_zero
from rocalphago_tpu_torch.data.replay import ZeroGames
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.models import CNNPolicy, CNNValue, NeuralNetBase
from rocalphago_tpu_torch.models.weights import params_from_flax, params_to_flax
from rocalphago_tpu_torch.ops.labels import terminal_labels
from rocalphago_tpu_torch.search import device_mcts
from rocalphago_tpu_torch.search.selfplay import sensible_mask
from rocalphago_tpu_torch.training import zero
import torch_port_helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL = os.path.join(ROOT, "results", "zero_r5", "run")
SIZE = 5
N = SIZE * SIZE
A = N + 1
KOMI = 7.0
CFG = jaxgo.GoConfig(size=SIZE, komi=KOMI)
TCFG = torchgo.GoConfig(size=SIZE, komi=KOMI)
FEATS = ("board", "ones", "liberties")
VFEATS = FEATS + ("color",)
BATCH = 4
MOVES = 14
LR = 0.1
ATOL = 1e-5            # float32: summation order only
RTOL = 1e-4
METRIC_RTOL = 1e-5


def flat(tree) -> dict:
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


# ------------------------------------------------------------- records


def make_record(seed: int, targets: str, aux: bool) -> ZeroGames:
    """A game record from seeded random sensible play through the port's
    engine: games 0 and 2 end by two passes, game 1 at the move limit,
    game 3 passes early. ``targets``: ``visits`` (int32 counts) or
    ``probs`` (float32, normalised); both with forced-pass plies (all on
    pass) and, for ``probs``, plies whose board mass is under 1e-3."""
    rng = np.random.default_rng(seed)
    ends = [6, MOVES + 4, 9, 2]
    st = torchgo.new_states(TCFG, BATCH, device="cpu")
    actions = np.full((MOVES, BATCH), N, np.int32)
    live = np.zeros((MOVES, BATCH), bool)
    visits = np.zeros((MOVES, BATCH, A),
                      np.int32 if targets == "visits" else np.float32)
    for t in range(MOVES):
        live[t] = ~st.done.numpy()
        sens = sensible_mask(TCFG, st).numpy()
        for b in range(BATCH):
            pts = np.flatnonzero(sens[b])
            if t < ends[b] and len(pts):
                actions[t, b] = rng.choice(pts)
            support = np.append(pts, N)
            if targets == "visits":
                if t % 5 == 4 or not len(pts):
                    visits[t, b, N] = 8          # a forced pass
                else:
                    visits[t, b, support] = rng.integers(
                        0, 4, len(support))
                    visits[t, b, actions[t, b]] += 1
            else:
                p = rng.dirichlet(np.ones(len(support)))
                if t % 5 == 3:
                    p = p * 5e-4                 # under 1e-3 on the board
                    p[-1] = 1.0 - p[:-1].sum()
                visits[t, b, support] = p
        st = torchgo.step(TCFG, st, torch.as_tensor(actions[t]))
    assert st.done.numpy().tolist() == [True, False, True, True]
    games = ZeroGames(actions, live, visits,
                      torchgo.winner(TCFG, st).numpy(), st.done.numpy())
    if targets == "probs":
        games = games._replace(full=rng.random((MOVES, BATCH)) < 0.6)
    if aux:
        own, score = terminal_labels(TCFG, st)
        games = games._replace(ownership=own.numpy(), score=score.numpy())
    return games


VARIANTS = {
    # name: (targets, caps, aux)
    "puct_visits": ("visits", False, False),
    "gumbel_caps": ("probs", True, False),
    "forced_caps_aux": ("probs", True, True),
}


@functools.lru_cache(maxsize=None)
def ref_nets(aux: bool):
    pol = RefPolicy(FEATS, board=SIZE, layers=2, filters_per_layer=8,
                    seed=31)
    pol.module = pol.module.clone(dtype=jnp.float32)
    val = RefValue(VFEATS, board=SIZE, layers=2, filters_per_layer=8,
                   seed=32, **({"aux_heads": ("ownership", "score")}
                               if aux else {}))
    val.module = val.module.clone(dtype=jnp.float32)
    return pol, val


def port_nets(aux: bool):
    pol_r, val_r = ref_nets(aux)
    pol = CNNPolicy(FEATS, board=SIZE, layers=2, filters_per_layer=8,
                    init_weights=False, device="cpu", dtype=torch.float32)
    val = CNNValue(VFEATS, board=SIZE, layers=2, filters_per_layer=8,
                   init_weights=False, device="cpu", dtype=torch.float32,
                   **({"aux_heads": ("ownership", "score")} if aux else {}))
    for net, ref in ((pol, pol_r), (val, val_r)):
        net.module.load_state_dict(params_from_flax(
            jax.tree.map(np.asarray, ref.params)))
    return pol, val


def econ_kw(caps: bool, aux: bool) -> dict:
    return dict(n_sim=4, **({"cap_p": 0.5, "cap_cheap": 1} if caps else {}),
                **({"aux_weight": 0.5} if aux else {}))


@functools.lru_cache(maxsize=None)
def reference_learn(variant: str):
    targets, caps, aux = VARIANTS[variant]
    games = make_record(7, targets, aux)
    pol, val = ref_nets(aux)
    tx = optax.sgd(LR)
    kw = econ_kw(caps, aux)
    with jax.enable_checks(False):
        it = ref_zero.make_zero_iteration(
            CFG, FEATS, VFEATS, pol.module.apply, val.module.apply, tx, tx,
            batch=BATCH, move_limit=MOVES, replay_chunk=MOVES,
            value_apply_aux=(functools.partial(val.module.apply,
                                               with_aux=True)
                             if aux else None), **kw)
        state = ref_zero.init_zero_state(pol.params, val.params, tx, tx)
        new, m = it.learn(state, ref_zero.ZeroGames(*games))
        new = jax.device_get(new)
    ups = []
    for old, upd in ((pol.params, new.policy_params),
                     (val.params, new.value_params)):
        o, n = flat(old), flat(upd)
        ups.append({k: (o[k] - n[k]) / LR for k in o})
    return games, ups, {k: float(v) for k, v in m.items()}


def port_learn(variant: str, games=None, replay_chunk=MOVES):
    targets, caps, aux = VARIANTS[variant]
    pol, val = port_nets(aux)
    it = zero.ZeroIteration(TCFG, FEATS, VFEATS, BATCH, MOVES,
                            replay_chunk=replay_chunk, device="cpu",
                            **econ_kw(caps, aux))
    old = [{k: v.clone() for k, v in net.module.state_dict().items()}
           for net in (pol, val)]
    state = zero.init_zero_state(pol.module, val.module, LR)
    state, m = it.learn(state, games)
    ups = [flat(params_to_flax({k: (o[k] - net.module.state_dict()[k]) / LR
                                for k in o}))
           for o, net in zip(old, (pol, val))]
    return state, ups, zero.metrics_to_host(m)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_learn_matches_the_reference(variant):
    games, want, want_m = reference_learn(variant)
    assert games.finished.any() and not games.finished.all()
    state, got, got_m = port_learn(variant, games)
    assert state.iteration == 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        moved = 0.0
        for k in w:
            assert np.isfinite(g[k]).all(), k
            np.testing.assert_allclose(g[k], w[k], atol=ATOL, rtol=RTOL,
                                       err_msg=f"{variant}: {k}")
            moved = max(moved, float(np.abs(w[k]).max()))
        assert moved > 1e-3
    assert got_m.keys() == want_m.keys()
    assert set(zero.METRICS) <= set(got_m)
    if VARIANTS[variant][2]:
        assert set(zero.AUX_METRICS) <= set(got_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=METRIC_RTOL,
                                   atol=1e-6, err_msg=k)
    assert want_m["value_loss"] > 0 and want_m["policy_loss"] > 0


def test_replay_in_segments_equals_one_segment():
    games = make_record(8, "probs", True)
    a, _, ma = port_learn("forced_caps_aux", games)
    b, _, mb = port_learn("forced_caps_aux", games, replay_chunk=3)
    for x, y in ((a.policy, b.policy), (a.value, b.value)):
        sx, sy = x.state_dict(), y.state_dict()
        assert all(torch.equal(sx[k], sy[k]) for k in sx)
    assert ma == mb and torch.equal(a.rng, b.rng)
    # a record without the cap mask (schema v1) learns as all full
    c, _, _ = port_learn("forced_caps_aux", games._replace(
        full=np.ones_like(games.live)))
    d, _, _ = port_learn("forced_caps_aux", games._replace(full=None))
    sc, sd = c.policy.state_dict(), d.policy.state_dict()
    assert all(torch.equal(sc[k], sd[k]) for k in sc)
    with pytest.raises(ValueError, match="ownership"):
        port_learn("forced_caps_aux", games._replace(ownership=None))


# ---------------------------------------------------------------- play


def fake_policy(params, planes):
    return jnp.zeros((planes.shape[0], N))


def fake_value(params, planes):
    mine = planes[..., 0].sum(axis=(1, 2))
    theirs = planes[..., 1].sum(axis=(1, 2))
    return (mine - theirs) / N


def fake_value_aux(params, planes):
    return fake_value(params, planes), {}


def port_policy(planes):
    return torch.zeros((planes.shape[0], N))


def port_value(planes):
    mine = planes[..., 0].sum(dim=(1, 2))
    theirs = planes[..., 1].sum(dim=(1, 2))
    return (mine - theirs) / N


PLAY = dict(batch=BATCH, move_limit=12, n_sim=8, max_nodes=16, sim_chunk=4,
            cap_p=0.5, cap_cheap=2)
PFEATS = ("board", "ones")


@pytest.mark.parametrize("cap_per_row", [False, True])
def test_play_is_the_references_given_its_draws(monkeypatch, cap_per_row):
    key = jax.random.key(11)
    tx = optax.sgd(LR)
    with jax.enable_checks(False):
        it = ref_zero.make_zero_iteration(
            CFG, PFEATS, PFEATS + ("color",), fake_policy, fake_value, tx, tx,
            cap_per_row=cap_per_row, aux_weight=1.0,
            value_apply_aux=fake_value_aux, **PLAY)
        want = jax.tree.map(np.asarray, it.play(None, None, key))
    assert want.full.any() and not want.full.all()
    us, rng = [], key
    for _ in range(len(want.actions)):
        rng, sub_b = jax.random.split(rng)     # the budget's split
        us.append(np.array(jax.random.uniform(
            sub_b, (BATCH,) if cap_per_row else ())).reshape(-1))
        rng, _ = jax.random.split(rng)         # the move's split
    feed = {"u": iter(us), "a": iter(want.actions)}
    cls = device_mcts.MCTSSelfplay
    monkeypatch.setattr(cls, "draw_budget", lambda self, g: self.budget_from(
        torch.as_tensor(next(feed["u"]))))
    monkeypatch.setattr(cls, "sample_weighted", lambda self, w, g:
                        torch.as_tensor(next(feed["a"]).copy()))
    port = zero.ZeroIteration(TCFG, PFEATS, PFEATS + ("color",),
                              cap_per_row=cap_per_row, aux_weight=1.0,
                              device="cpu", **PLAY)
    got = port.play(port_policy, port_value, 0)
    for name in ZeroGames._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == torch.from_numpy(np.array(w)).dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


# ----------------------------------------------------------- iteration


def test_iteration_is_learn_of_play():
    runs = []
    for split in (False, True):
        pol, val = port_nets(False)
        it = zero.ZeroIteration(TCFG, FEATS, VFEATS, BATCH, 6, n_sim=4,
                                replay_chunk=4, device="cpu")
        state = zero.init_zero_state(pol.module, val.module, LR, seed=5)
        for _ in range(2):
            if split:
                _, seed = zero.next_keys(state.rng)
                games = it.play(state.policy, state.value, seed)
                state, m = it.learn(state, games)
            else:
                state, m = it(state)
        runs.append((state, zero.metrics_to_host(m)))
    (a, ma), (b, mb) = runs
    assert a.iteration == b.iteration == 2 and torch.equal(a.rng, b.rng)
    for x, y in ((a.policy, b.policy), (a.value, b.value)):
        sx, sy = x.state_dict(), y.state_dict()
        assert all(torch.equal(sx[k], sy[k]) for k in sx)
    assert ma == mb
    # the chain: a game seed depends only on the start and the steps
    def walk(k):
        r, seeds = torch.Generator().manual_seed(5).get_state(), []
        for _ in range(k):
            r, s = zero.next_keys(r)
            seeds.append(s)
        return r, seeds

    r, seeds = walk(3)
    assert len(set(seeds)) == 3 and walk(2)[1] == seeds[:2]
    assert torch.equal(walk(2)[0], a.rng)


# ---------------------------------------------------------------- gate


def test_gate_decide_and_sample_are_the_references(tmp_path):
    gate = zero.ZeroGate(TCFG, FEATS, str(tmp_path / "port"), games=8,
                         threshold=0.55, temperature=1.0, move_limit=20,
                         device="cpu")
    ref = object.__new__(ref_zero.ZeroGate)
    for threshold in (0.55, 0.75):
        gate.threshold = ref.threshold = threshold
        for wa, wb, d in ((38, 26, 0), (45, 19, 0), (0, 0, 8), (7, 1, 0),
                          (8, 0, 0), (5, 3, 2), (40, 24, 0), (33, 31, 0)):
            r = {"wins_a": wa, "wins_b": wb, "draws": d,
                 "win_rate_a": wa / max(wa + wb, 1)}
            assert gate.decide(r) == ref.decide(r), (threshold, wa, wb)
    # the same pools in both packages: the same ladder draws
    pol, val = port_nets(False)
    ref_gate = ref_zero.ZeroGate(CFG, FEATS, ref_nets(False)[0].module.apply,
                                 str(tmp_path / "ref"), games=8,
                                 threshold=0.55, temperature=1.0,
                                 move_limit=20)
    assert gate.sample(7, 11) is None
    for it in (0, 5, 10, 20, 35):
        gate.promote(pol.module, val.module, it)
        ref_gate.promote(ref_nets(False)[0].params,
                         ref_nets(False)[1].params, it)
    assert [s[0] for s in gate.snapshots()] == \
        [s[0] for s in ref_gate.snapshots()] == [0, 5, 10, 20, 35]
    picks = set()
    for seed in (0, 7, 1234):
        for it in (0, 3, 9, 40):
            got, want = gate.sample(seed, it), ref_gate.sample(seed, it)
            assert got[0] == want[0]
            picks.add(got[0])
    assert len(picks) > 1 and 35 not in picks
    from rocalphago_tpu_torch.training.actor import read_spill
    assert read_spill(gate.pool_dir)["version"] == 35


def test_a_promoted_pair_loads_in_the_reference(tmp_path):
    pol, val = port_nets(True)
    gate = zero.ZeroGate(TCFG, FEATS, str(tmp_path), games=2,
                         threshold=0.55, temperature=1.0, move_limit=20,
                         device="cpu")
    gate.promote(pol.module, val.module, 3)
    ref = ref_zero.ZeroGate(CFG, FEATS, None, str(tmp_path), games=2,
                            threshold=0.55, temperature=1.0, move_limit=20,
                            write=False)
    entry = ref.snapshots()[0]
    rp, rv = ref.load(entry, *(n.params for n in ref_nets(True)))
    assert_same(flat(rp), flat(params_to_flax(pol.module.state_dict())))
    assert_same(flat(rv), flat(params_to_flax(val.module.state_dict())))
    # and back through the port's own load: frozen copies, equal params
    lp, lv = gate.load(gate.snapshots()[0], pol.module, val.module)
    assert not any(p.requires_grad for p in lp.parameters())
    assert all(torch.equal(lv.state_dict()[k], val.module.state_dict()[k])
               for k in lv.state_dict())


def test_the_committed_pool_loads_and_plays(tmp_path):
    """``results/zero_r5/run/pool`` (the reference's 9×9 run): its first
    and last incumbents load in the port, equal the files' params, and
    play a raw match."""
    value_spec = str(tmp_path / "value.json")
    with open(os.path.join(POOL, "value.json")) as f:
        spec = json.load(f)
    spec["weights_file"] = os.path.join(POOL, "pool",
                                        "best.00000.value.msgpack")
    with open(value_spec, "w") as f:
        json.dump(spec, f)
    policy = NeuralNetBase.load_model(
        os.path.join(POOL, "pool", "best.00000.policy.json"), device="cpu")
    value = NeuralNetBase.load_model(value_spec, device="cpu")
    cfg = torchgo.GoConfig(size=9, komi=7.0)
    gate = zero.ZeroGate(cfg, policy.feature_list,
                         os.path.join(POOL, "pool"), games=2,
                         threshold=0.55, temperature=1.0, move_limit=12,
                         write=False, device="cpu")
    snaps = gate.snapshots()
    assert [s[0] for s in snaps][:2] == [0, 15] and snaps[-1][0] == 165
    first = gate.load(snaps[0], policy.module, value.module)
    last = gate.load(snaps[-1], policy.module, value.module)
    ref = RefNet.load_model(os.path.join(POOL, "pool",
                                         "best.00000.policy.json"))
    assert_same(flat(ref.params), flat(params_to_flax(first[0].state_dict())))
    assert not all(torch.equal(first[0].state_dict()[k],
                               last[0].state_dict()[k])
                   for k in first[0].state_dict())
    r = gate.match(last[0], first[0], torch.Generator().manual_seed(0))
    assert r["wins_a"] + r["wins_b"] + r["draws"] == 2


# ----------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    d = tmp_path_factory.mktemp("specs")
    pol, val = port_nets(True)
    pol.save_model(str(d / "policy.json"))
    val.save_model(str(d / "value.json"))
    return str(d / "policy.json"), str(d / "value.json")


def cli(specs, out, iterations, *extra):
    return zero.run_training([
        *specs, out, "--game-batch", "4", "--sims", "4", "--move-limit",
        "10", "--iterations", str(iterations), "--save-every", "1",
        "--gate-every", "2", "--gate-games", "4", "--seed", "3",
        "--learning-rate", "0.05", "--cap-p", "0.5", "--cap-cheap", "2",
        "--aux-weight", "0.5", "--device", "cpu", *extra])


def run_artifacts(out, it=3):
    state = torch.load(os.path.join(out, "checkpoints", str(it), "state.pt"),
                       map_location="cpu", weights_only=True)
    rows = []
    with open(os.path.join(out, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if r["event"] in ("iteration", "gate", "ladder"):
                rows.append({k: v for k, v in r.items() if k not in (
                    "time", "games_per_min", "replay_version",
                    "replay_staleness_s")})
    files = {}
    for sub in ("", "pool"):
        d = os.path.join(out, sub)
        for name in sorted(os.listdir(d)):
            if name.endswith((".msgpack", ".json")) and name not in (
                    "metadata.json",):
                with open(os.path.join(d, name), "rb") as f:
                    files[os.path.join(sub, name)] = f.read()
    return state, rows, files


def same_state(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_state(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_state(x, y)
                                        for x, y in zip(a, b))
    return a == b


def test_cli_resume_and_actor_learner_are_the_straight_run(
        tmp_path, specs, monkeypatch):
    straight = str(tmp_path / "straight")
    final = cli(specs, straight, 3)
    assert final["iteration"] == 2 and np.isfinite(final["policy_loss"])
    want = run_artifacts(straight)
    with open(os.path.join(straight, "metadata.json")) as f:
        meta = json.load(f)
    assert [e["iteration"] for e in meta["epochs"]] == [0, 1, 2]
    assert meta["config"]["komi"] == KOMI and meta["ladder_free"]
    for name in ("policy.00003.flax.msgpack", "value.00003.flax.msgpack",
                 "pool/best.00000.policy.msgpack", "pool/rollout.json"):
        assert name in want[2], name
    assert sum(r["event"] == "gate" for r in want[1]) == 2

    # killed inside iteration 2 (the checkpoint is at 2) and resumed
    out = str(tmp_path / "killed")
    calls = [0]
    real = zero.ZeroIteration.apply_updates

    def killing(self, *a, **kw):
        if calls[0] == 2:
            raise KeyboardInterrupt("killed")
        calls[0] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(zero.ZeroIteration, "apply_updates", killing)
    with pytest.raises(KeyboardInterrupt):
        cli(specs, out, 3)
    monkeypatch.setattr(zero.ZeroIteration, "apply_updates", real)
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["1", "2"]
    cli(specs, out, 3)
    got = run_artifacts(out)
    assert same_state(got[0], want[0])
    assert got[1] == want[1]
    assert got[2] == want[2]

    # one lockstep actor and a FIFO learner: the synchronous run's bits
    al = str(tmp_path / "actor_learner")
    cli(specs, al, 3, "--actor-learner", "--actors", "1")
    got = run_artifacts(al)
    assert same_state(got[0], want[0])
    assert got[1] == want[1]
    assert got[2] == want[2]
    with open(os.path.join(al, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    done = [e for e in events if e["event"] == "actor_learner_done"]
    assert done and done[0]["learner_steps"] == 3 \
        and done[0]["games_played"] == 3
    assert os.listdir(os.path.join(al, "replay")) == []

    # the exports load in the reference with the same forward
    planes = NeuralNetBase.load_model(
        os.path.join(straight, "value.json"),
        device="cpu")._states_to_planes(list(
            torch_port_helpers.random_games(SIZE, 3, 2, 9, seed=4)))
    for name in ("policy", "value"):
        path = os.path.join(straight, f"{name}.json")
        ref = RefNet.load_model(path)
        ref.module = ref.module.clone(dtype=jnp.float32)
        port = NeuralNetBase.load_model(path, device="cpu",
                                        dtype=torch.float32)
        assert_same(flat(ref.params),
                    flat(params_to_flax(port.module.state_dict())))
        x = planes if name == "value" else planes[..., :planes.shape[-1] - 1]
        want_f = np.asarray(ref.module.apply(ref.params,
                                             jnp.asarray(x.numpy())))
        got_f = port.module(x).detach().numpy()
        np.testing.assert_allclose(got_f, want_f, atol=ATOL, rtol=RTOL)


def test_cli_refuses_what_the_reference_refuses(tmp_path, specs):
    out = str(tmp_path / "o")
    for extra, what in ((["--gumbel", "--dirichlet-alpha", "0.1"], "PUCT"),
                        (["--gumbel-sample-moves"], "requires --gumbel"),
                        (["--gumbel", "--forced-k", "1"], "PUCT-root"),
                        # a width above the ranks launched (one here)
                        (["--num-devices", "2"], "rank.*torch.distributed")):
        with pytest.raises(SystemExit, match=what):
            cli(specs, out, 1, *extra)
    plain = str(tmp_path / "plain.json")
    v = CNNValue(VFEATS, board=SIZE, layers=2, filters_per_layer=8,
                 device="cpu")
    v.save_model(plain)
    with pytest.raises(SystemExit, match="aux_heads"):
        zero.run_training([specs[0], plain, out, "--aux-weight", "1",
                           "--device", "cpu"])
    shutil.rmtree(out, ignore_errors=True)
