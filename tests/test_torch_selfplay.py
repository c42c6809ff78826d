"""The port's batched self-play (``rocalphago_tpu_torch/search/
selfplay.py``), ``terminal_labels`` and the self-play CLI against the
reference's, on the CPU.

The reference's chunked runner plays seeded games between two different
small nets (carried across in float32); its action stream is replayed
ply by ply through the port's :meth:`Ply.logits` and :meth:`Ply.advance`
and through the reference's own pieces on the same states (torch cannot
reproduce JAX's draws, so the draw is the one part not compared).
Tolerances: planes, sensible masks, states, ``live``, ``num_moves``,
final states and winners exact; masked logits within ``LOGIT_ATOL`` in
float32 (summation order). ``terminal_labels`` and the SGF text are
exact.

The nets read every default plane but the two ladder planes: XLA takes
some 25 s to compile the reference's ladder reader, twice here (in the
runner and in the per-ply pieces). The ladder planes are held against
the reference by ``test_torch_ladders.py`` and ``test_torch_features*``,
and the chase kernel at self-play shapes by ``chip_smoke.py``.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.data import sgf as ref_sgf
from rocalphago_tpu.engine import jaxgo, pygo
from rocalphago_tpu.features.planes import batched_encoder
from rocalphago_tpu.interface import selfplay_cli as ref_cli
from rocalphago_tpu.models import CNNPolicy as RefPolicy
from rocalphago_tpu.ops import labels as ref_labels
from rocalphago_tpu.search import selfplay as ref_selfplay
from rocalphago_tpu_torch.data import sgf
from rocalphago_tpu_torch.engine import pygo as tpygo
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.features import DEFAULT_FEATURES
from rocalphago_tpu_torch.features.planes import encode
from rocalphago_tpu_torch.interface import selfplay_cli
from rocalphago_tpu_torch.models import CNNPolicy
from rocalphago_tpu_torch.models.weights import params_from_flax
from rocalphago_tpu_torch.ops.labels import terminal_labels
from rocalphago_tpu_torch.search import selfplay
from torch_port_helpers import one_torch_thread, torch_states  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 5
N = SIZE * SIZE
BATCH = 8
MAX_MOVES = 64
CHUNK = 8
TEMP = 0.8
CFG = jaxgo.GoConfig(size=SIZE)
TCFG = torchgo.GoConfig(size=SIZE)
FEATS = tuple(f for f in DEFAULT_FEATURES if not f.startswith("ladder"))
LOGIT_ATOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUCT = os.path.join(ROOT, "results/zero_r5/target_compare/puct")


def eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got).astype(np.float64),
                                  np.asarray(want).astype(np.float64),
                                  err_msg=what)


def assert_states(got, want, what):
    for name in jaxgo.GoState._fields:
        eq(getattr(got, name).numpy(), getattr(want, name),
           f"{what}: {name}")


@functools.lru_cache(maxsize=None)
def nets():
    """Two different 2 × 8 policies of the reference, float32, and the
    port's twins carried across."""
    out = []
    for seed in (11, 12):
        ref = RefPolicy(FEATS, board=SIZE, layers=2, filters_per_layer=8,
                        seed=seed)
        ref.module = ref.module.clone(dtype=jnp.float32)
        port = CNNPolicy(FEATS, board=SIZE, layers=2, filters_per_layer=8,
                         init_weights=False, device="cpu",
                         dtype=torch.float32)
        port.module.load_state_dict(params_from_flax(
            jax.tree.map(np.asarray, ref.params)))
        out.append((ref, port))
    return out


@functools.lru_cache(maxsize=None)
def reference_games():
    """The reference's chunked runner, stopping when every game is
    over: ``(result, per-ply states)``; the states come from replaying
    its actions through its own step."""
    (ra, _), (rb, _) = nets()
    with jax.enable_checks(False):
        run = ref_selfplay.make_selfplay_chunked(
            CFG, FEATS, ra.module.apply, rb.module.apply, batch=BATCH,
            max_moves=MAX_MOVES, chunk=CHUNK, temperature=TEMP,
            incremental=False)
        res = run(ra.params, rb.params, jax.random.key(3),
                  stop_when_done=True)
        res = jax.tree.map(np.asarray, res)
        vstep = jax.jit(jax.vmap(functools.partial(jaxgo.step, CFG)))
        states = [jaxgo.new_states(CFG, BATCH)]
        for t in range(MAX_MOVES):
            states.append(vstep(states[-1], jnp.asarray(res.actions[t])))
    return res, [jax.tree.map(np.asarray, s) for s in states]


@functools.lru_cache(maxsize=None)
def ref_pieces():
    (ra, _), (rb, _) = nets()
    vgd = jax.jit(jaxgo.vgroup_data(CFG))
    enc = jax.jit(batched_encoder(CFG, FEATS))
    vsens = jax.jit(jax.vmap(functools.partial(ref_selfplay.sensible_mask,
                                               CFG)))

    @jax.jit
    def masked(states, t):
        gd = vgd(states)
        planes = enc(states, gd)
        swap = (t % 2) == 1
        rolled = ref_selfplay._half_swap(planes, swap)
        half = BATCH // 2
        logits = ref_selfplay._half_swap(jnp.concatenate(
            [ra.module.apply(ra.params, rolled[:half]),
             rb.module.apply(rb.params, rolled[half:])]), swap)
        sens = vsens(states, gd)
        return (planes, sens, jnp.where(sens, logits / TEMP,
                                        jnp.finfo(logits.dtype).min))

    return masked


def port_states(states_np) -> torchgo.GoState:
    """The reference's states as the port's (uint32 hash words held in
    int64)."""
    return torchgo.GoState(*(
        torch.as_tensor(np.array(x, np.int64 if x.dtype == np.uint32
                                 else x.dtype)) for x in states_np))


def port_ply():
    (_, pa), (_, pb) = nets()
    return selfplay.Ply(TCFG, FEATS, pa.module, pb.module, BATCH, TEMP)


class Replay:
    """A sampler that hands out a recorded action stream and, until
    ``check_until``, checks each action against the port's sensible mask
    (a pass only where nothing is sensible)."""

    def __init__(self, actions, check_until):
        self.actions = actions
        self.check_until = check_until
        self.t = 0

    def __call__(self, masked, sens, generator):
        a = torch.as_tensor(self.actions[self.t].copy()).int()
        if self.t < self.check_until:
            at = sens.gather(1, a.clamp(max=N - 1).long()[:, None])[:, 0]
            ok = torch.where(a < N, at, ~sens.any(dim=1))
            assert bool(ok.all()), f"ply {self.t}: a move is not sensible"
        self.t += 1
        return a


def np_states(states):
    return torchgo.GoState._make(x.numpy() for x in states)


def test_policy_selfplay_replays_the_reference_ply_by_ply():
    res, ref_states = reference_games()
    masked_ref = ref_pieces()
    ply = port_ply()
    plies = int(res.num_moves.max())
    assert 10 < plies < MAX_MOVES and bool(res.final.done.all())
    st = port_states(ref_states[0])
    worst = 0.0
    with jax.enable_checks(False):
        for t in range(plies + 1):
            assert_states(st, ref_states[t], f"ply {t}")
            planes_r, sens_r, m_r = masked_ref(
                jax.tree.map(jnp.asarray, ref_states[t]), t)
            masked, gd, sens = ply.logits(st, t)
            eq(encode(TCFG, st, FEATS, gd=gd).numpy(), planes_r,
               f"ply {t}: planes")
            eq(sens.numpy(), sens_r, f"ply {t}: sensible mask")
            m_r = np.asarray(m_r)
            eq(masked.numpy() == np.finfo(np.float32).min,
               m_r == np.finfo(np.float32).min, f"ply {t}: masked points")
            live_pts = np.asarray(sens_r)
            if live_pts.any():
                worst = max(worst, float(np.abs(
                    masked.numpy()[live_pts] - m_r[live_pts]).max()))
            st, live = ply.advance(st, torch.as_tensor(res.actions[t].copy()),
                                  gd)
            eq(live.numpy(), res.live[t], f"ply {t}: live")
    assert worst <= LOGIT_ATOL, worst
    assert_states(st, res.final, "final")


@pytest.mark.parametrize("chunk", [CHUNK, 5])
def test_chunked_runner_replays_the_reference_result(chunk):
    """The port's chunked runner, drawing the reference's actions,
    gives its result: actions zero-padded after the all-done segment,
    ``live``, ``num_moves``, the final states and the winners; the host
    scorer agrees with the card's."""
    res, _ = reference_games()
    (_, pa), (_, pb) = nets()
    run = selfplay.make_selfplay_chunked(
        TCFG, FEATS, pa.module, pb.module, BATCH, max_moves=MAX_MOVES,
        chunk=chunk, temperature=TEMP, device="cpu")
    run.ply.sample = Replay(res.actions, int(res.num_moves.max()))
    got = run(torch.Generator().manual_seed(0), stop_when_done=True)
    assert got.actions.shape == (MAX_MOVES, BATCH)
    done_at = int(res.num_moves.max())
    # the port stops at the first all-done segment of its own chunking
    cut = -(-done_at // chunk) * chunk
    eq(got.actions[:cut].numpy(), res.actions[:cut], "actions")
    eq(got.actions[cut:].numpy(), 0, "zero padding")
    eq(got.live.numpy(), res.live, "live")
    eq(got.num_moves.numpy(), res.num_moves, "num_moves")
    assert_states(got.final, res.final, "final")
    eq(got.winners.numpy(), res.winners, "winners")
    eq(selfplay.host_winners(TCFG, got.final.board), got.winners.numpy(),
       "host winners")
    # the extra segment on finished games played nothing
    assert run.ply.sample.t <= cut + chunk


def test_chunked_equals_monolithic_and_deadline():
    (_, pa), (_, pb) = nets()
    args = (TCFG, FEATS, pa.module, pb.module)
    mono = selfplay.play_games(*args, torch.Generator().manual_seed(5),
                               BATCH, max_moves=24, temperature=TEMP,
                               device="cpu")
    run = selfplay.make_selfplay_chunked(*args, BATCH, max_moves=24,
                                         chunk=7, temperature=TEMP,
                                         device="cpu")
    got = run(torch.Generator().manual_seed(5))
    for name in ("actions", "live", "winners", "num_moves"):
        eq(getattr(got, name).numpy(), getattr(mono, name).numpy(), name)
    assert_states(got.final, np_states(mono.final), "final")
    assert selfplay.make_selfplay(*args, BATCH, max_moves=24,
                                  temperature=TEMP, device="cpu")(
        torch.Generator().manual_seed(5)).actions.equal(mono.actions)

    # continuing from given states leaves them unchanged
    half = run(torch.Generator().manual_seed(1), initial_states=got.final)
    assert half.actions.shape == (24, BATCH)
    assert_states(got.final, np_states(mono.final),
                  "initial states")

    # a deadline that passes during the first segment: the short shape
    clock = iter([0.0, 100.0, 100.0])
    real = selfplay.time.time
    selfplay.time.time = lambda: next(clock)
    try:
        short = run(torch.Generator().manual_seed(5), deadline=50.0)
    finally:
        selfplay.time.time = real
    assert short.actions.shape == (7, BATCH)
    eq(short.actions.numpy(), mono.actions[:7].numpy(), "truncated")
    assert not bool(short.final.done.all())
    with pytest.raises(ValueError, match="even"):
        selfplay.Ply(TCFG, FEATS, pa.module, pb.module, 3, 1.0)


def test_sampler_keeps_to_sensible_moves():
    ply = port_ply()
    rng = np.random.default_rng(0)
    sens = torch.as_tensor(rng.random((BATCH, N)) < 0.2)
    sens[0] = False                                   # must pass
    sens[1] = False
    sens[1, 7] = True                                 # one choice
    logits = torch.as_tensor(rng.normal(0, 3, (BATCH, N)),
                             dtype=torch.float32)
    masked = torch.where(sens, logits, torch.finfo(torch.float32).min)
    g = torch.Generator().manual_seed(1)
    counts = torch.zeros((BATCH, N + 1))
    for _ in range(300):
        a = ply.sample(masked, sens, g)
        assert a.dtype == torch.int32
        counts[torch.arange(BATCH), a.long()] += 1
    assert counts[0, N] == 300 and counts[1, 7] == 300
    chosen = counts[:, :N] > 0
    assert not bool((chosen & ~sens).any())
    # with a real choice, the draw follows the softmax
    row = int(torch.nonzero(sens.sum(1) > 2)[0, 0])
    p = torch.softmax(masked[row], 0)
    assert float((counts[row, :N] / 300 - p).abs().max()) < 0.15


def finished_games(size, count, seed):
    """Seeded random games of sensible moves played to two passes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        st = pygo.GameState(size=size)
        while not st.is_end_of_game:
            moves = st.get_legal_moves(include_eyes=False)
            if not moves or rng.random() < 0.02:
                st.do_move(None)
            else:
                st.do_move(moves[rng.integers(len(moves))])
        out.append(st)
    return out


@pytest.mark.parametrize("size", [5, 9])
def test_terminal_labels_are_the_references(size):
    cfg = jaxgo.GoConfig(size=size)
    sts = finished_games(size, 12, size)
    jst = jax.tree.map(lambda *xs: jnp.stack(xs),
                       *[jaxgo.from_pygo(cfg, s) for s in sts])
    with jax.enable_checks(False):
        own_r, score_r = jax.jit(jax.vmap(functools.partial(
            ref_labels.terminal_labels, cfg)))(jst)
    tst = torch_states(size, sts)
    own, score = terminal_labels(torchgo.GoConfig(size=size), tst)
    assert own.dtype == torch.int8 and score.dtype == torch.float32
    eq(own.numpy(), own_r, "ownership")
    eq(score.numpy(), score_r, "score")
    win = torchgo.winner(torchgo.GoConfig(size=size), tst)
    eq(torch.sign(score).int().numpy(), win.numpy(), "sign(score)")
    assert len(set(win.tolist())) > 1


def test_games_to_sgf_writes_the_references_text(tmp_path):
    res, _ = reference_games()
    (_, pa), (_, pb) = nets()
    run = selfplay.make_selfplay_chunked(
        TCFG, FEATS, pa.module, pb.module, BATCH, max_moves=MAX_MOVES,
        chunk=CHUNK, temperature=TEMP, device="cpu")
    run.ply.sample = Replay(res.actions, int(res.num_moves.max()))
    got = run(torch.Generator().manual_seed(0), stop_when_done=True)
    with jax.enable_checks(False):
        ref_paths = ref_cli.games_to_sgf(CFG, res, str(tmp_path / "ref"),
                                         black_name="a", white_name="b")
    paths = selfplay_cli.games_to_sgf(TCFG, got, str(tmp_path / "port"),
                                      black_name="a", white_name="b",
                                      app="rocalphago_tpu")
    assert len(paths) == len(ref_paths) == BATCH
    for p, r in zip(paths, ref_paths):
        with open(p) as f, open(r) as g:
            text = f.read()
            assert text == g.read()
        game = sgf.parse(text)
        assert game.moves == ref_sgf.parse(text).moves
    assert sgf.render(sgf.parse(text)).startswith(
        "(;GM[1]FF[4]AP[rocalphago_tpu_torch]")


def replay_sgf(path):
    """Parse a record with the port's reader and replay it legally on
    the port's rules oracle; the final position."""
    with open(path) as f:
        game = sgf.parse(f.read())
    st = tpygo.GameState(size=game.size, komi=game.komi)
    for color, move in game.moves:
        assert st.is_legal(move), (path, move)
        st.do_move(move, color)
    return game, st


@pytest.mark.parametrize("mode", ["policy", "search"])
def test_cli_main_on_the_cpu(tmp_path, mode):
    out = tmp_path / mode
    argv = ["--policy", os.path.join(PUCT, "policy.json"), "--out",
            str(out), "--device", "cpu", "--seed", "4"]
    if mode == "policy":
        argv += ["--games", "4", "--chunk", "10", "--max-moves", "30"]
    else:
        argv += ["--search-sims", "4", "--value",
                 os.path.join(PUCT, "value.json"), "--games", "3",
                 "--max-moves", "4", "--dirichlet-alpha", "0.03"]
    summary = selfplay_cli.main(argv)
    with open(out / "summary.json") as f:
        assert json.load(f) == summary
    games = summary["games"]
    assert set(summary) == {"games", "black_wins", "white_wins", "draws",
                            "mean_moves", "games_per_min", "wall_s",
                            "sgf_files"}
    assert summary["sgf_files"] == games
    assert (summary["black_wins"] + summary["white_wins"]
            + summary["draws"]) == games
    lengths = []
    for g in range(games):
        game, st = replay_sgf(out / f"selfplay-{g:05d}.sgf")
        assert game.size == 9 and game.properties["PB"] == "policy.json"
        lengths.append(len(game.moves))
        black, white = st.get_scores()
        assert game.result == ("0" if black == white else
                               f"{'B' if black > white else 'W'}+"
                               f"{abs(black - white):g}")
    assert np.mean(lengths) == summary["mean_moves"]
    with pytest.raises(SystemExit):
        selfplay_cli.main(argv[:-2] + ["--games", "3"] if mode == "policy"
                          else argv + ["--opponent", argv[1]])
