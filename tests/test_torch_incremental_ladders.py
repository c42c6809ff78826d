"""The incremental encoder's ladder machinery against the reference's,
on the CPU: ladder-rich trajectories, the invalidation cascade, the
footprint expansion and the chase's read core.

* A capture-heavy 7×7 game and a 9×9 ladder opening, ply by ply, as in
  ``tests/test_torch_incremental.py`` (planes and every cache field).
* The invalidation cascade (the reference's ``TestInvalidationCascade``):
  churn inside a live chase's footprint, far churn that invalidates
  nothing, and a ladder breaker that re-chases exactly the flipped
  lanes -- with the stats equal to the reference's at every step.
* ``_chase_read_regions`` on random cores equals the reference's (which
  reads groups through a float32 one-hot matmul; the port scatters).
* The read core: the port reads every lane to full depth in one chase
  and ORs the opening's core in after; the reference seeds its chase
  with that core and reads either at full depth (its narrow branch) or
  2 rungs lockstep then the rest (its wide branch). On lanes that run
  past 2 rungs, all three cores are equal, and so are the verdicts.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.engine import jaxgo, pygo
from rocalphago_tpu.features import ladders as ref_ladders
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.features import incremental as incr
from rocalphago_tpu_torch.features import ladders
from rocalphago_tpu_torch.ops import chase as chase_op
from torch_port_helpers import (  # noqa: F401
    INCR_KOMI as KOMI,
    IncrementalCarry as Carry,
    ladder_start,
    one_torch_thread,
    play_carry as play,
    random_games,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DEPTH = 40
PHASE1 = 2          # the reference's lockstep depth before it resumes


def ladder_board_9x9():
    """The reference's cascade board: the working ladder of
    :func:`ladder_start` and a white group in atari at (4,3)-(4,4)
    inside the chase's read region."""
    st = pygo.GameState(size=9, komi=KOMI)
    for mv, color in (((1, 2), pygo.BLACK), ((2, 2), pygo.WHITE),
                      ((2, 1), pygo.BLACK), ((8, 8), pygo.WHITE),
                      ((3, 1), pygo.BLACK), ((4, 3), pygo.WHITE),
                      ((3, 3), pygo.BLACK), ((4, 4), pygo.WHITE),
                      ((3, 4), pygo.BLACK), ((8, 0), pygo.WHITE),
                      ((5, 3), pygo.BLACK), ((0, 8), pygo.WHITE),
                      ((5, 4), pygo.BLACK), ((8, 4), pygo.WHITE),
                      ((4, 2), pygo.BLACK)):
        st.do_move(mv, color)
    st.current_player = pygo.BLACK
    return st


def scripted(carry: Carry, st, moves, what: str):
    """Play ``moves`` (point, colour), black to move after each, the
    carry checked every time; returns the stats deltas."""
    before = carry.stats().copy()
    for mv, color in moves:
        st.do_move(mv, color)
        st.current_player = pygo.BLACK
        carry.step(st, f"{what} after {mv}")
    np.testing.assert_array_equal(carry.port.stats[0].numpy(),
                                  np.asarray(carry.ref.stats))
    return carry.stats() - before


def test_capture_heavy_7x7():
    carry = Carry(7)
    play(carry, seed=4, plies=40)
    assert carry.stats()[incr.STAT_REFRESHED] > 0


def test_ladder_opening_9x9():
    """Random play on top of a live ladder: candidates, chases and
    invalidations churn."""
    carry = Carry(9)
    play(carry, seed=7, plies=18, start=ladder_start(9))
    assert carry.stats()[incr.STAT_CHASES] > 0


def test_ladder_heavy_adversarial_game():
    """Captures inside the live chase's read region, a replay into the
    hole and the prey grown: region hits that fail the cell test and
    invalidate entries; then random play from the wreckage."""
    st = ladder_board_9x9()
    carry = Carry(9)
    carry.step(st, "the cascade board")
    assert carry.stats()[incr.STAT_CHASES] > 0
    delta = scripted(carry, st, (((4, 5), pygo.BLACK), ((4, 4), pygo.WHITE),
                                 ((6, 3), pygo.BLACK), ((3, 2), pygo.WHITE),
                                 ((6, 5), pygo.BLACK)), "adversarial")
    assert delta[incr.STAT_FOOT_HITS] > 0
    assert carry.stats()[incr.STAT_INVALIDATED] > 0
    play(carry, seed=29, plies=12, start=st)


def test_far_churn_does_not_invalidate():
    """A top-edge exchange outside every recorded footprint (one stone
    shares a coarse block with footprint cells: a block hit whose cell
    test passes) invalidates nothing, and verdicts keep being reused."""
    st = ladder_start(9)
    carry = Carry(9)
    carry.step(st, "the ladder")
    assert carry.stats()[incr.STAT_CHASES] > 0
    delta = scripted(carry, st, (((0, 5), pygo.WHITE), ((0, 7), pygo.BLACK)),
                     "far churn")
    assert delta[incr.STAT_INVALIDATED] == 0
    assert delta[incr.STAT_REUSED] > 0


def test_verdict_flip_rechases_exactly_the_flipped_lanes():
    """A ladder breaker inside the chase footprint flips the recorded
    verdict: that lane re-chases (a flip), and only affected entries
    go dormant."""
    st = ladder_start(9)
    carry = Carry(9)
    carry.step(st, "the ladder")
    delta = scripted(carry, st, (((5, 5), pygo.WHITE),), "breaker")
    assert delta[incr.STAT_FOOT_HITS] > 0
    assert delta[incr.STAT_INVALIDATED] > 0
    assert delta[incr.STAT_FLIPS] > 0
    assert delta[incr.STAT_CHASES] >= delta[incr.STAT_FLIPS]


@functools.lru_cache(maxsize=None)
def ref_regions(size: int):
    cfg = jaxgo.GoConfig(size=size)
    return jax.jit(jax.vmap(lambda b, l, c: ref_ladders._chase_read_regions(
        cfg, b, l, c)))


@pytest.mark.parametrize("size", [9, 19])
def test_read_regions_are_the_references(size):
    """Random positions, 6 random cores each (sparse, so the footprint
    does not fill the board): the same footprints bit for bit."""
    sts = random_games(size, 4, size * 2, size * 5, seed=size)
    cfg = torchgo.GoConfig(size=size)
    ts = torchgo.from_pygo(cfg, sts, device="cpu")
    rng = np.random.default_rng(size + 1)
    cores = rng.random((len(sts), 6, size * size)) < 0.02
    cores[:, 1:, 0] = True                      # no other core is empty
    cores[:, 0] = False                         # an empty core too
    got = ladders._chase_read_regions(cfg, ts.board, ts.labels,
                                      torch.as_tensor(cores))
    want = ref_regions(size)(jnp.asarray(ts.board.numpy()),
                             jnp.asarray(ts.labels.numpy()),
                             jnp.asarray(cores))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:, 1:].any(dim=2).all() and not got[:, 0].any()
    one = ladders._chase_read_region(cfg, ts.board, ts.labels,
                                     torch.as_tensor(cores[:, 3]))
    assert torch.equal(one, got[:, 3])


def chase_lanes(size: int):
    """The live chase lanes of ladder positions, as the encoder builds
    them: candidates, openings, and the lanes left needing a chase.
    Returns ``(boards int8 [L, N], labels int32 [L, N], prey int32
    [L])``."""
    cfg = torchgo.GoConfig(size=size)
    if size == 9:
        sts = [ladder_start(size), ladder_board_9x9()]
    else:               # and with a white stone in the ladder's path
        sts = [ladder_start(size), ladder_start(size)]
        sts[1].do_move((size // 2, size // 2), pygo.WHITE)
        sts[1].current_player = pygo.BLACK
    st = torchgo.from_pygo(cfg, sts, device="cpu")
    gd = torchgo.group_data(cfg, st.board, labels=st.labels)
    legal = torchgo.legal_mask(cfg, st, gd)[:, :cfg.num_points]
    boards, labels, prey = [], [], []
    for libs, opp, opening in ((2, True, ladders._capture_opening),
                               (1, False, ladders._escape_opening)):
        mv, pr, ok = ladders._candidate_lanes(cfg, st, gd, legal, libs, opp,
                                              16)
        b, lab, need, _ = opening(cfg, st, gd, mv, pr, ok)
        boards.append(b[need])
        labels.append(lab[need])
        prey.append(pr[need])
    return (torch.cat(boards), torch.cat(labels),
            torch.cat(prey).int())


@functools.lru_cache(maxsize=None)
def ref_chases(size: int):
    """The reference's two schedules of a seeded chase, vmapped over
    lanes: ``narrow`` (full depth) and ``wide`` (``PHASE1`` rungs, then
    the unresolved lanes resumed from their exit boards)."""
    cfg = jaxgo.GoConfig(size=size)

    def narrow(b, l, p, c0):
        return ref_ladders._chase(cfg, b, l, p, DEPTH, collect_core=True,
                                  core0=c0)

    def wide(b, l, p, c0):
        cap, unres, b_end, l_end, core = ref_ladders._chase(
            cfg, b, l, p, PHASE1, return_state=True, collect_core=True,
            core0=c0)
        cap2, core2 = ref_ladders._chase(cfg, b_end, l_end, p,
                                         DEPTH - PHASE1, enabled=unres,
                                         collect_core=True, core0=core)
        return (jnp.where(unres, cap2, cap),
                jnp.where(unres, core2, core), unres)

    return jax.jit(jax.vmap(narrow)), jax.jit(jax.vmap(wide))


@pytest.mark.parametrize("size", [9, 19])
def test_chase_core_is_the_references_seeded_schedules(size):
    """Live lanes of ladder positions, seeded with a random opening
    core: the port's full-depth chase core ORed with the seed equals
    the reference's narrow core and its two-phase wide core, and the
    verdicts agree; some lanes run past the lockstep depth (the resume
    is exercised)."""
    boards, labels, prey = chase_lanes(size)
    captured, core, rungs = chase_op.chase_plain(
        boards, labels, prey, size, DEPTH, collect_core=True,
        return_rungs=True)
    assert int(rungs.max()) > PHASE1 and len(prey) >= 3
    seed = torch.as_tensor(np.random.default_rng(size).random(
        boards.shape) < 0.05)
    got = core | seed
    args = (jnp.asarray(boards.numpy()), jnp.asarray(labels.numpy()),
            jnp.asarray(prey.numpy()), jnp.asarray(seed.numpy()))
    narrow, wide = ref_chases(size)
    cap_n, core_n = narrow(*args)
    cap_w, core_w, resumed = wide(*args)
    assert bool(np.asarray(resumed).any())
    for cap, ref_core, what in ((cap_n, core_n, "narrow"),
                                (cap_w, core_w, "wide")):
        np.testing.assert_array_equal(captured.numpy(), np.asarray(cap),
                                      err_msg=what)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_core),
                                      err_msg=what)
