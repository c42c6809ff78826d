"""The port's value-corpus generator
(``rocalphago_tpu_torch/training/selfplay_data.py``) against the
reference's, on the CPU.

* The reference's own value ply (``_make_value_ply``) plays a seeded
  batch of mixed-policy games one ply at a time; its U draw and the
  actions recovered from its consecutive states (the one point that
  goes from empty to the mover's colour, or a pass when the move count
  rose and no stone appeared) are handed to the port's runners. The
  port's recorded snapshots (every field), ``z``, ``valid`` and ``u``
  are bit-identical to the reference's ``play_value_games``; per ply,
  the masked SL and RL logits agree within ``ATOL + RTOL·|x|`` (float32,
  summation order) and the sensible masks are equal. The batch holds
  games that end before the move limit.
* The port's chunked runner (early exit on a retired segment's done
  flag) equals its monolithic one on the same generator.
* ``generate`` writes shards whose uint8 planes equal the reference's
  encode of the same snapshots; each package's pipeline reads the
  other's corpus; 20 dry batches raise; the CLI runs on the CPU.

The nets read every default plane but the two ladder planes, like
``test_torch_selfplay.py`` (XLA takes some 25 s per program to compile
the reference's ladder reader).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.data.pipeline import ShardedDataset as RefDataset
from rocalphago_tpu.engine import jaxgo
from rocalphago_tpu.features import Preprocess as RefPreprocess
from rocalphago_tpu.features.planes import batched_encoder
from rocalphago_tpu.models import CNNPolicy as RefPolicy
from rocalphago_tpu.search import selfplay as ref_selfplay
from rocalphago_tpu.training import selfplay_data as ref_sd
from rocalphago_tpu_torch.data.pipeline import ShardedDataset
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.features import DEFAULT_FEATURES, output_planes
from rocalphago_tpu_torch.models import CNNPolicy
from rocalphago_tpu_torch.models.weights import params_from_flax
from rocalphago_tpu_torch.training import selfplay_data
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 7
N = SIZE * SIZE
BATCH = 8
MOVES = 60
TEMP = 0.8
KOMI = jaxgo.default_komi(SIZE)
CFG = jaxgo.GoConfig(size=SIZE, komi=KOMI)
TCFG = torchgo.GoConfig(size=SIZE, komi=KOMI)
FEATS = tuple(f for f in DEFAULT_FEATURES if not f.startswith("ladder"))
VALUE_FEATS = FEATS + ("color",)
ATOL = 1e-5
RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def nets():
    """The SL and RL policies: two different 2 × 4 nets of the
    reference in float32, and the port's twins carried across."""
    out = []
    for seed in (31, 32):
        ref = RefPolicy(FEATS, board=SIZE, layers=2, filters_per_layer=4,
                        seed=seed)
        ref.module = ref.module.clone(dtype=jnp.float32)
        port = CNNPolicy(FEATS, board=SIZE, layers=2, filters_per_layer=4,
                         init_weights=False, device="cpu",
                         dtype=torch.float32)
        port.module.load_state_dict(params_from_flax(
            jax.tree.map(np.asarray, ref.params)))
        out.append((ref, port))
    return out


def np_tree(x):
    return jax.tree.map(np.asarray, x)


@functools.lru_cache(maxsize=None)
def reference_games():
    """``(samples of play_value_games, U, per-ply states, per-ply
    masked SL/RL logits and sensible masks)`` of the reference from
    key 2 (four games end early, one before its sample ply); the
    per-ply states come from its own value ply run one ply at a
    time."""
    (rs, _), (rr, _) = nets()
    key = jax.random.key(2)
    with jax.enable_checks(False):
        samples = jax.jit(lambda k: ref_sd.play_value_games(
            CFG, FEATS, rs.module.apply, rs.params, rr.module.apply,
            rr.params, k, BATCH, MOVES, TEMP))(key)
        ply = ref_sd._make_value_ply(CFG, FEATS, rs.module.apply,
                                     rr.module.apply, TEMP)
        # play_value_games' own U draw
        rng, u_key = jax.random.split(key)
        U = jax.random.randint(u_key, (BATCH,), 0,
                               ref_sd._value_u_cap(MOVES, None) + 1)
        states0 = jaxgo.new_states(CFG, BATCH)
        carry = (states0, states0, jnp.zeros((BATCH,), bool), rng)
        one = jax.jit(lambda c, t: ply(rs.params, rr.params, U, c, t))
        vgd = jaxgo.vgroup_data(CFG)
        enc = batched_encoder(CFG, FEATS)
        vsens = jax.vmap(functools.partial(ref_selfplay.sensible_mask, CFG))

        @jax.jit
        def pieces(states):
            gd = vgd(states)
            planes = enc(states, gd)
            sens = vsens(states, gd)
            neg = jnp.finfo(jnp.float32).min
            return tuple(
                jnp.where(sens, m.module.apply(m.params, planes) / TEMP, neg)
                for m in (rs, rr)) + (sens,)

        states, logits = [np_tree(states0)], []
        for t in range(MOVES):
            logits.append(np_tree(pieces(carry[0])))
            carry = one(carry, jnp.int32(t))
            states.append(np_tree(carry[0]))
        final = np_tree(ref_sd._value_finish(CFG, carry[0], carry[1],
                                             carry[2], U))
    return np_tree(samples), np.asarray(U), states, logits, final


def recovered_actions(states) -> np.ndarray:
    """int32 ``[T, B]``: the action of each ply, from the states before
    and after it."""
    out = np.full((len(states) - 1, BATCH), N, np.int32)
    for t in range(len(states) - 1):
        a, b = states[t], states[t + 1]
        for g in range(BATCH):
            if b.step_count[g] == a.step_count[g]:
                continue                      # over: the step froze it
            new = np.flatnonzero((a.board[g] == 0)
                                 & (b.board[g] == a.turn[g]))
            assert len(new) <= 1, (t, g)
            out[t, g] = new[0] if len(new) else N
    return out


def eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got).astype(np.float64),
                                  np.asarray(want).astype(np.float64),
                                  err_msg=what)


def assert_states(got, want, what):
    for name in jaxgo.GoState._fields:
        eq(getattr(got, name).numpy(), getattr(want, name),
           f"{what}: {name}")


class Replay:
    """Stands in for :meth:`ValuePly.sample`: hands out the recorded
    actions and checks each ply's masked logits and sensible mask
    against the reference's on the same state."""

    def __init__(self, actions, logits):
        self.actions = actions
        self.logits = logits
        self.t = 0
        self.worst = 0.0

    def __call__(self, ply, masked_sl, masked_rl, sens, U, t, generator):
        assert t == self.t
        want_sl, want_rl, want_sens = self.logits[t]
        eq(sens.numpy(), want_sens, f"ply {t}: sensible mask")
        for got, want in ((masked_sl, want_sl), (masked_rl, want_rl)):
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL,
                                       rtol=RTOL, err_msg=f"ply {t}")
            self.worst = max(self.worst, float(np.abs(
                got.numpy() - want)[want_sens].max(initial=0.0)))
        a = torch.as_tensor(self.actions[t].copy()).int()
        at = sens.gather(1, a.clamp(max=N - 1).long()[:, None])[:, 0]
        live = torch.as_tensor(~self.done[t])
        ok = torch.where(a < N, at, ~sens.any(dim=1))
        assert bool((ok | ~live).all()), f"ply {t}: a move is not sensible"
        self.t += 1
        return a


def replayed(monkeypatch, run):
    """``run(U)`` with the reference's actions in place of the draws."""
    samples, U, states, logits, _ = reference_games()
    replay = Replay(recovered_actions(states), logits)
    replay.done = [s.done for s in states]
    monkeypatch.setattr(selfplay_data.ValuePly, "sample",
                        lambda self, *a: replay(self, *a))
    got = run(torch.as_tensor(U.copy()))
    return got, replay


def assert_samples(got, want):
    assert_states(got.recorded, want.recorded, "recorded")
    for name in ("z", "valid", "u"):
        eq(getattr(got, name).numpy(), getattr(want, name), name)
    assert got.z.dtype == got.u.dtype == torch.int32


def test_value_games_replay_the_reference(monkeypatch):
    samples, U, states, _, final = reference_games()
    # the ply-by-ply run is the reference's own play_value_games
    assert_states(torchgo.GoState(*(torch.as_tensor(np.array(
        x, np.int64 if x.dtype == np.uint32 else x.dtype))
        for x in final.recorded)), samples.recorded, "ply by ply")
    for name in ("z", "valid", "u"):
        eq(getattr(final, name), getattr(samples, name), name)
    # the fixture has games ending early and an invalid sample
    moves = states[-1].step_count
    assert moves.min() < MOVES and states[-1].done.any()
    assert samples.valid.any() and not samples.valid.all()
    assert (samples.z != 0).any()
    (_, ps), (_, pr) = nets()
    got, replay = replayed(monkeypatch, lambda u: selfplay_data
                           .play_value_games(TCFG, FEATS, ps.module,
                                             pr.module, torch.Generator(),
                                             BATCH, MOVES, TEMP, U=u,
                                             device="cpu"))
    assert replay.t == MOVES
    assert_samples(got, samples)


def test_chunked_runner_replays_the_reference(monkeypatch):
    samples, _, states, _, _ = reference_games()
    (_, ps), (_, pr) = nets()
    run = selfplay_data.make_value_games_chunked(
        TCFG, FEATS, ps.module, pr.module, BATCH, MOVES, TEMP, chunk=7,
        device="cpu")
    got, replay = replayed(monkeypatch, lambda u: run(torch.Generator(),
                                                      U=u))
    assert_samples(got, samples)
    assert replay.t == MOVES     # some games are still on at the limit


def test_chunked_equals_monolithic_with_draws(monkeypatch):
    """Long enough for every game to end: the chunked runner stops one
    segment after the first all-done one, with the monolithic run's
    samples."""
    (_, ps), (_, pr) = nets()
    moves = 150
    mono = selfplay_data.play_value_games(
        TCFG, FEATS, ps.module, pr.module, torch.Generator().manual_seed(2),
        BATCH, moves, TEMP, device="cpu")
    run = selfplay_data.make_value_games_chunked(
        TCFG, FEATS, ps.module, pr.module, BATCH, moves, TEMP, chunk=9,
        device="cpu")
    plies = []
    real = selfplay_data.ValuePly.sample
    monkeypatch.setattr(selfplay_data.ValuePly, "sample",
                        lambda self, *a: plies.append(a[4]) or real(self, *a))
    got = run(torch.Generator().manual_seed(2))
    assert plies == list(range(len(plies))) and len(plies) < moves
    assert len(plies) % 9 == 0
    for a, b in zip(got.recorded, mono.recorded):
        assert torch.equal(a, b)
    for name in ("z", "valid", "u"):
        assert torch.equal(getattr(got, name), getattr(mono, name)), name
    assert bool(mono.valid.any())
    # the recorded position is right after the random move U
    v = mono.valid
    assert torch.equal(mono.recorded.step_count[v], mono.u[v] + 1)
    with pytest.raises(ValueError, match="chunk"):
        selfplay_data.make_value_games_chunked(
            TCFG, FEATS, ps.module, pr.module, BATCH, chunk=0, device="cpu")


def to_ref_states(states) -> jaxgo.GoState:
    """The port's states as the reference's (hash words as uint32)."""
    return jaxgo.GoState(*(
        jnp.asarray(x.numpy().astype(np.uint32) if x.dtype == torch.int64
                    else x.numpy()) for x in states))


def test_generate_writes_the_references_corpus(tmp_path):
    (rs, ps), (rr, pr) = nets()
    gen = selfplay_data.ValueDataGenerator(ps, pr, VALUE_FEATS, batch=BATCH,
                                           max_moves=MOVES, temperature=TEMP)
    assert gen.cfg.komi == KOMI
    prefix = str(tmp_path / "port" / "value")
    manifest = gen.generate(12, prefix, seed=3, shard_size=8)
    with jax.enable_checks(False):
        ref_gen = ref_sd.ValueDataGenerator(rs, rr, VALUE_FEATS,
                                            batch=BATCH, max_moves=MOVES,
                                            temperature=TEMP)
        ref_prefix = str(tmp_path / "ref" / "value")
        ref_manifest = ref_gen.generate(12, ref_prefix, seed=3,
                                        shard_size=8)
    assert manifest.keys() == ref_manifest.keys()
    for k in ("board_size", "komi", "planes", "feature_list", "targets"):
        assert manifest[k] == ref_manifest[k], k
    assert manifest["num_positions"] >= 12
    assert len(manifest["shard_counts"]) >= 2
    assert sum(manifest["shard_counts"]) == manifest["num_positions"]

    # the shards hold the reference's encode of the port's snapshots
    pre = RefPreprocess(VALUE_FEATS, cfg=CFG)
    want_s, want_z = [], []
    index = 0
    while sum(len(z) for z in want_z) < manifest["num_positions"]:
        s = gen._run(torch.Generator().manual_seed(
            selfplay_data.batch_seed(3, index)))
        index += 1
        with jax.enable_checks(False):
            planes = np.asarray(pre.states_to_tensor(to_ref_states(
                s.recorded)) > 0.5).astype(np.uint8)
        keep = s.valid.numpy() & (s.z.numpy() != 0)
        want_s.append(planes[keep])
        want_z.append(s.z.numpy()[keep])
    files = sorted(f for f in os.listdir(tmp_path / "port")
                   if f.endswith(".npz"))
    assert files == [f"value-{i:05d}.npz" for i in range(len(files))]
    got = [np.load(tmp_path / "port" / f) for f in files]
    states = np.concatenate([g["states"] for g in got])
    z = np.concatenate([g["actions"] for g in got])
    assert states.dtype == np.uint8 and z.dtype == np.int32
    assert states.shape == (manifest["num_positions"], SIZE, SIZE,
                            manifest["planes"])
    eq(states, np.concatenate(want_s), "planes")
    eq(z, np.concatenate(want_z), "z")
    assert set(z.tolist()) <= {-1, 1}

    # each package reads the other's corpus
    for reader, path in ((RefDataset, prefix), (ShardedDataset, ref_prefix),
                         (ShardedDataset, prefix)):
        ds = reader(path)
        assert ds.manifest["targets"] == "outcome"
        idx = np.arange(len(ds))
        s, a = ds.gather(idx)
        assert s.shape[1:] == (SIZE, SIZE, manifest["planes"])
        assert set(np.asarray(a).tolist()) <= {-1, 1}
    s, a = RefDataset(prefix).gather(np.arange(len(z)))
    eq(s, states, "reference reader")
    eq(a, z, "reference reader z")


def test_twenty_dry_batches_raise(tmp_path):
    (_, ps), (_, pr) = nets()
    gen = selfplay_data.ValueDataGenerator(ps, pr, VALUE_FEATS, batch=4,
                                           max_moves=8)
    calls = [0]
    real = gen._run

    def dry(generator):
        calls[0] += 1
        s = real(generator)
        return s._replace(valid=torch.zeros_like(s.valid))

    gen._run = dry
    with pytest.raises(RuntimeError, match="20 consecutive"):
        gen.generate(4, str(tmp_path / "dry"))
    assert calls[0] == 20
    assert not os.path.exists(tmp_path / "dry-manifest.json")


def test_cli_on_the_cpu(tmp_path):
    (_, ps), (_, pr) = nets()
    sl_spec, rl_spec = str(tmp_path / "sl.json"), str(tmp_path / "rl.json")
    ps.save_model(sl_spec)
    pr.save_model(rl_spec)
    prefix = str(tmp_path / "corpus" / "v")
    manifest = selfplay_data.run_generator(
        [sl_spec, rl_spec, prefix, "--n-positions", "6", "--batch", "4",
         "--max-moves", "30", "--chunk", "8", "--device", "cpu"])
    assert manifest["planes"] == output_planes(VALUE_FEATS)
    assert manifest["komi"] == KOMI
    assert manifest["feature_list"] == list(VALUE_FEATS)
    with open(f"{prefix}-manifest.json") as f:
        assert json.load(f) == manifest
    assert ShardedDataset(prefix).planes == manifest["planes"]
