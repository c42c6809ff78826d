"""The port's rollout net, pooled trunks, symmetric evaluation, spec CLI
and device rollout against the reference's, on the CPU.

* Nets (float32, weights carried by ``params_from_flax``): the
  ``CNNRollout`` forward with both heads, ``trunk_pool`` 1 and 2 policy
  and value forwards, and the 8-symmetry policy distributions and
  values agree within ``ATOL + RTOL·|x|`` with the same argmax. Specs
  written by either package load in the other and compute the same
  outputs (rollout, pooled and legacy specs; the port's spec CLI).
* Device rollout (exact): the reference's Gumbel draws, its own key
  chain (``rng, sub = split(rng)`` a ply), reach the port through
  ``noise=``; winners and executed plies are equal at batch 8, with
  done padding, with the ply limit cutting the games, and through
  ``device_rollout_fn`` at two komis. The port reads its done flag once
  every ``ROLLOUT_CHECK_PLIES`` plies; the count and the winners do not
  depend on it, and the recorded actions replay on the rules oracle.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from rocalphago_tpu.engine import jaxgo
from rocalphago_tpu.models import CNNPolicy as RefPolicy
from rocalphago_tpu.models import CNNRollout as RefRollout
from rocalphago_tpu.models import CNNValue as RefValue
from rocalphago_tpu.models import NeuralNetBase as RefNet
from rocalphago_tpu.search import mcts as ref_mcts
from rocalphago_tpu.search.selfplay import (
    make_device_rollout as ref_make_device_rollout,
)
from rocalphago_tpu_torch.engine import pygo, torchgo
from rocalphago_tpu_torch.models import (
    CNNPolicy,
    CNNRollout,
    CNNValue,
    NeuralNetBase,
)
from rocalphago_tpu_torch.models import specs
from rocalphago_tpu_torch.models.weights import params_from_flax
from rocalphago_tpu_torch.search import mcts, selfplay
from torch_port_helpers import one_torch_thread, random_games  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 7
N = SIZE * SIZE
BATCH = 8
ATOL = RTOL = 1e-5
FEATS = ("board", "ones", "turns_since", "liberties", "sensibleness")
VFEATS = FEATS + ("color",)
ROLLOUT_FEATS = ("board", "ones", "turns_since", "liberties")


def close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


def to_float32(ref):
    """The reference net computing in float32 (fresh jitted applies)."""
    ref.module = ref.module.clone(dtype=jnp.float32)
    ref._apply = jax.jit(ref.module.apply)
    ref._apply_sym = None
    return ref


def carried(ref, port_cls, feats, **kw):
    """A float32 port net holding the reference's weights."""
    net = port_cls(feats, board=ref.board, init_weights=False,
                   device="cpu", dtype=torch.float32, **kw)
    net.module.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, ref.params)))
    return net


def planes(batch, dim, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((batch, SIZE, SIZE, dim)) < 0.3).astype(np.float32)


def port_states(states):
    """The port's pygo twins of reference host states (same moves)."""
    out = []
    for st in states:
        twin = pygo.GameState(size=st.size, komi=st.komi)
        for mv in st.history:
            twin.do_move(mv)
        out.append(twin)
    return out


# ------------------------------------------------------------------- nets


@pytest.mark.parametrize("head", ["fcn", "bias"])
def test_rollout_forward_matches(head):
    ref = to_float32(RefRollout(board=SIZE, head=head, seed=1))
    if head == "bias":       # a non-zero bias, so its mapping is tested
        pb = ref.params["params"]["head"]["position_bias"]
        ref.params["params"]["head"]["position_bias"] = jnp.asarray(
            np.random.default_rng(2).normal(size=pb.shape), jnp.float32)
    port = carried(ref, CNNRollout, ROLLOUT_FEATS, head=head)
    assert port.preprocess.output_dim == 20
    x = planes(BATCH, 20)
    want = np.asarray(ref.forward(x))
    got = port.forward(torch.as_tensor(x)).numpy()
    close(got, want, f"rollout {head}")
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("pool", [1, 2])
@pytest.mark.parametrize("kind", ["policy", "value"])
def test_pooled_forwards_match(kind, pool):
    ref_cls, cls, feats = ((RefPolicy, CNNPolicy, FEATS) if kind == "policy"
                           else (RefValue, CNNValue, VFEATS))
    ref = to_float32(ref_cls(feats, board=SIZE, layers=3,
                             filters_per_layer=8, trunk_pool=pool, seed=3))
    assert any(k.startswith("gpool") for k in ref.params["params"]["trunk"])
    port = carried(ref, cls, feats, layers=3, filters_per_layer=8,
                   trunk_pool=pool)
    x = planes(BATCH, ref.preprocess.output_dim, seed=pool)
    want = np.asarray(ref.forward(x))
    got = port.forward(torch.as_tensor(x)).numpy()
    close(got, want, f"{kind} trunk_pool={pool}")
    if kind == "policy":
        assert (got.argmax(-1) == want.argmax(-1)).all()


def test_symmetric_policy_and_value_match():
    """The 8-transform ensembles over real positions: distributions on
    the sensible moves and values, as the search's backends ask."""
    games = random_games(SIZE, BATCH, 4, 30, seed=5)
    twins = port_states(games)
    sens = [g.get_legal_moves(include_eyes=False) for g in games]
    ref_p = to_float32(RefPolicy(FEATS, board=SIZE, layers=3,
                                 filters_per_layer=8, seed=4))
    ref_v = to_float32(RefValue(VFEATS, board=SIZE, layers=3,
                                filters_per_layer=8, seed=5))
    pol = carried(ref_p, CNNPolicy, FEATS, layers=3, filters_per_layer=8)
    val = carried(ref_v, CNNValue, VFEATS, layers=3, filters_per_layer=8)
    for symmetric in (False, True):
        want = ref_p.batch_eval_state(games, sens, symmetric=symmetric)
        got = pol.batch_eval_state(twins, sens, symmetric=symmetric)
        for w, g in zip(want, got):
            assert [m for m, _ in w] == [m for m, _ in g]
            close([p for _, p in g], [p for _, p in w],
                  f"policy symmetric={symmetric}")
            assert max(w, key=lambda mp: mp[1])[0] == \
                max(g, key=lambda mp: mp[1])[0]
        close(val.batch_eval_state(twins, symmetric=symmetric),
              ref_v.batch_eval_state(games, symmetric=symmetric),
              f"value symmetric={symmetric}")
    # the ensemble really averages: it differs from the plain forward
    plain = val.batch_eval_state(twins)
    assert not np.allclose(plain, val.batch_eval_state(twins,
                                                       symmetric=True))


# ------------------------------------------------------------------ specs


SPECS = {
    "rollout": (RefRollout, ROLLOUT_FEATS, {"head": "fcn"}),
    "rollout_legacy": (RefRollout, ROLLOUT_FEATS, {"head": "bias"}),
    "policy_pooled": (RefPolicy, FEATS,
                      {"layers": 3, "filters_per_layer": 8,
                       "trunk_pool": 2}),
    "value_pooled": (RefValue, VFEATS,
                     {"layers": 4, "filters_per_layer": 8,
                      "trunk_pool": 1}),
    "value_legacy": (RefValue, VFEATS,
                     {"layers": 2, "filters_per_layer": 8,
                      "head": "dense"}),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_specs_cross_both_ways(name, tmp_path):
    """A spec and its weights written by the reference load in the port,
    and the port's own save loads back in the reference, each computing
    the other's outputs. The legacy specs lack the ``head`` kwarg and
    load as the size-locked heads."""
    ref_cls, feats, kw = SPECS[name]
    ref = ref_cls(feats, board=SIZE, seed=6, **kw)
    path = str(tmp_path / "ref.json")
    ref.save_model(path)
    if name.endswith("legacy"):
        with open(path) as f:
            spec = json.load(f)
        del spec["kwargs"]["head"]
        with open(path, "w") as f:
            json.dump(spec, f)
    port = NeuralNetBase.load_model(path, device="cpu", dtype=torch.float32)
    x = planes(4, port.preprocess.output_dim, seed=7)
    want = np.asarray(to_float32(RefNet.load_model(path)).forward(x))
    close(port.forward(torch.as_tensor(x)).numpy(), want,
          f"{name} reference → port")
    back = str(tmp_path / "port.json")
    port.save_model(back)
    again = to_float32(RefNet.load_model(back))
    assert type(again).__name__ == type(port).__name__
    assert again.spec_kwargs == port.spec_kwargs
    close(np.asarray(again.forward(x)), want, f"{name} port → reference")


def test_spec_cli_writes_specs_both_packages_read(tmp_path, capsys):
    """The port's spec CLI: seeded fresh weights (the same file twice
    for one seed), a pooled policy, a rollout net; the reference loads
    each and computes the port's outputs."""
    runs = {
        "policy": ["--layers", "3", "--filters", "8", "--trunk-pool", "1",
                   "--features", *FEATS],
        "value": ["--layers", "2", "--filters", "8", "--head", "dense",
                  "--features", *VFEATS],
        "rollout": [],
    }
    for kind, extra in runs.items():
        path = str(tmp_path / f"{kind}.json")
        net = specs.main([kind, "--out", path, "--board", str(SIZE),
                          "--seed", "3", "--device", "cpu", *extra])
        assert f"wrote {path}" in capsys.readouterr().out
        port = NeuralNetBase.load_model(path, device="cpu",
                                        dtype=torch.float32)
        ref = to_float32(RefNet.load_model(path))
        assert type(ref).__name__ == type(net).__name__
        x = planes(4, ref.preprocess.output_dim, seed=8)
        close(port.forward(torch.as_tensor(x)).numpy(),
              np.asarray(ref.forward(x)), kind)
        again = str(tmp_path / f"{kind}2.json")
        specs.main([kind, "--out", again, "--board", str(SIZE), "--seed",
                    "3", "--device", "cpu", *extra])
        with open(path[:-5] + ".flax.msgpack", "rb") as a, \
                open(again[:-5] + ".flax.msgpack", "rb") as b:
            assert a.read() == b.read()
    assert RefNet.load_model(str(tmp_path / "rollout.json")
                             ).spec_kwargs == {"filters": 32, "head": "fcn"}


# --------------------------------------------------------- device rollout


def reference_chain(key, limit, batch):
    """The reference rollout's per-ply draws from ``key``: ``rng, sub =
    split(rng)`` a ply, ``gumbel(sub, (batch, N), float32)``."""
    def body(rng, _):
        rng, sub = jax.random.split(rng)
        return rng, jax.random.gumbel(sub, (batch, N), jnp.float32)

    return np.asarray(jax.jit(lambda k: lax.scan(
        body, k, None, length=limit)[1])(key))


@pytest.fixture(scope="module")
def rollout_nets():
    ref = to_float32(RefRollout(board=SIZE, seed=9))
    return ref, carried(ref, CNNRollout, ROLLOUT_FEATS)


def wave(komi=7.5, done_rows=2, seed=11):
    """8 positions of a 7×7 game at various depths; the last
    ``done_rows`` ended (two passes), as done padding looks."""
    games = random_games(SIZE, BATCH, 2, 30, seed=seed, komi=komi)
    for g in games[BATCH - done_rows:]:
        g.do_move(None)
        g.do_move(None)
    return games


def both_waves(games, komi):
    cfg = jaxgo.GoConfig(size=SIZE, komi=komi)
    ref = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jaxgo.from_pygo(cfg, g, with_history=False, with_labels=False)
        for g in games])
    tcfg = torchgo.GoConfig(size=SIZE, komi=komi)
    port = torchgo.from_pygo(tcfg, port_states(games), device="cpu",
                             with_history=False, with_labels=False)
    return (cfg, jaxgo.seed_labels(cfg, ref), tcfg,
            torchgo.seed_labels(tcfg, port))


@pytest.mark.parametrize("limit", [500, 12])
def test_device_rollout_replays_the_reference(rollout_nets, limit):
    ref_net, net = rollout_nets
    cfg, ref_states, tcfg, states = both_waves(wave(), 7.5)
    run = ref_make_device_rollout(cfg, ROLLOUT_FEATS, ref_net.module.apply,
                                  rollout_limit=limit, with_steps=True)
    key = jax.random.key(4)
    want_w, want_t = run(ref_net.params, ref_states, key)
    noise = torch.as_tensor(reference_chain(key, limit, BATCH))
    record = []
    port = selfplay.make_device_rollout(tcfg, ROLLOUT_FEATS, net.forward,
                                        rollout_limit=limit,
                                        with_steps=True)
    got_w, got_t = port(states, noise=noise, record=record)
    assert got_t == int(want_t) and len(record) == got_t
    if limit == 12:
        assert got_t == 12           # the limit cut every game
    else:
        assert 12 < got_t < limit    # every game ended by two passes
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


@pytest.mark.parametrize("check", [1, 5, 40])
def test_done_checks_change_nothing(rollout_nets, monkeypatch, check):
    """However often the done flag is read, the rollout plays the same
    plies, reports the same count, and its recorded actions replayed on
    the rules oracle give its winners."""
    _, net = rollout_nets
    games = wave(komi=6.5, done_rows=3, seed=13)
    _, _, tcfg, states = both_waves(games, 6.5)
    noise = selfplay.gumbel_noise((500, BATCH, N),
                                  torch.Generator().manual_seed(1))
    runs = []
    for k in (selfplay.ROLLOUT_CHECK_PLIES, check):
        monkeypatch.setattr(selfplay, "ROLLOUT_CHECK_PLIES", k)
        record = []
        run = selfplay.make_device_rollout(tcfg, ROLLOUT_FEATS,
                                           net.forward, with_steps=True)
        winners, plies = run(states, noise=noise, record=record)
        runs.append((winners.tolist(), plies,
                     torch.stack(record).tolist()))
    assert runs[0] == runs[1]
    winners, plies, actions = runs[0]
    replay = port_states(games)
    for row in actions:
        for st, a in zip(replay, row):
            if not st.is_end_of_game:
                st.do_move(None if a == N else divmod(a, SIZE))
    assert all(st.is_end_of_game for st in replay)
    assert [st.get_winner() for st in replay] == winners


class ReferenceDraws:
    """The port's ``noise(call)`` seam fed with the reference
    ``device_rollout_fn``'s key chain: ``key, sub = split(key)`` a wave,
    then the rollout's own chain from ``sub``."""

    def __init__(self, seed, limit):
        self.key = jax.random.key(seed)
        self.limit = limit
        self.calls = 0

    def __call__(self, call):
        assert call == self.calls
        self.calls += 1
        self.key, sub = jax.random.split(self.key)
        return torch.as_tensor(reference_chain(sub, self.limit, BATCH))


def test_device_rollout_fn_matches_at_two_komis(rollout_nets):
    """Short waves padded with done copies, scored with each wave's own
    komi, outcomes from each entry player's view -- equal to the
    reference's ``device_rollout_fn`` wave by wave."""
    ref_net, net = rollout_nets
    ref_fn = ref_mcts.device_rollout_fn(ref_net, rollout_limit=500,
                                        min_batch=BATCH, seed=21)
    draws = ReferenceDraws(21, 500)
    port_fn = mcts.device_rollout_fn(net, rollout_limit=500,
                                     min_batch=BATCH, seed=21, noise=draws)
    for komi, count, seed in ((7.5, 5, 30), (0.5, 8, 31), (7.5, 3, 32)):
        games = random_games(SIZE, count, 4, 24, seed=seed, komi=komi)
        want = ref_fn([g.copy() for g in games])
        got = port_fn(port_states(games))
        assert got == want, komi
        assert port_fn.last_plies > 0
    assert draws.calls == 3
