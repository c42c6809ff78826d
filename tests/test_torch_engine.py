"""The port's engine (``rocalphago_tpu_torch/engine``) against the
reference's (``rocalphago_tpu/engine``).

Seeded random games on the rules oracle go through ``from_pygo`` of
both packages; the batched port and the vmapped reference must then
agree on every field of the state, the labels, the group analysis
(sizes, liberty counts, membership, per-group Zobrist XORs), the
neighbor analysis and legality, at 5×5, 9×9 and 19×19 with superko
on and off. Tolerance: exact -- all outputs are integers or booleans
(uint32 hash words are compared as integers).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from rocalphago_tpu.engine import jaxgo, pygo, zobrist
from rocalphago_tpu_torch.engine import pygo as tpygo
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.engine import zobrist as tzobrist
from torch_port_helpers import (  # noqa: F401
    jax_states,
    one_torch_thread,
    random_games,
    torch_states,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = [(5, False), (9, False), (9, True), (19, False), (19, True)]


def games(size, superko):
    hi = {5: 20, 9: 60, 19: 200}[size]
    return random_games(size, 6, 0, hi, seed=size + 100 * superko,
                        komi=5.5, superko=superko)


def test_zobrist_tables_are_the_references():
    for size in (5, 9, 19):
        np.testing.assert_array_equal(tzobrist.position_table(size),
                                      zobrist.position_table(size))
        for a, b in zip(tzobrist.signature_tables(size),
                        zobrist.signature_tables(size)):
            np.testing.assert_array_equal(a, b)


def test_port_oracle_replays_the_reference_oracle():
    """The copied rules oracle makes the same decisions and hashes as
    the reference's on the same move sequences (illegal tries too)."""
    rng = np.random.default_rng(7)
    for size, superko in ((9, False), (9, True), (19, False)):
        a = pygo.GameState(size=size, enforce_superko=superko)
        b = tpygo.GameState(size=size, enforce_superko=superko)
        for _ in range(150):
            mv = tuple(int(v) for v in rng.integers(0, size, 2))
            if rng.random() < 0.03:
                mv = None
            assert a.is_legal(mv) == b.is_legal(mv)
            if a.is_legal(mv):
                a.do_move(mv)
                b.do_move(mv)
            np.testing.assert_array_equal(a.board, b.board)
            np.testing.assert_array_equal(a.zobrist_hash, b.zobrist_hash)
            assert a.ko == b.ko and a.get_scores() == b.get_scores()
            if a.is_end_of_game:
                break


@functools.lru_cache(maxsize=None)
def ref_fns(size, superko):
    cfg = jaxgo.GoConfig(size=size, komi=5.5, enforce_superko=superko)
    gd = jax.jit(jax.vmap(lambda b, l: jaxgo.group_data(
        cfg, b, with_member=True, with_zxor=True, labels=l)))
    na = jax.jit(jax.vmap(lambda b, l: jaxgo.neighbor_analysis(cfg, b, l)))
    legal = jax.jit(jax.vmap(lambda s: jaxgo.legal_mask(cfg, s)))
    return cfg, gd, na, legal


@pytest.mark.parametrize("size,superko", CASES)
def test_from_pygo_and_seed_labels(size, superko):
    sts = games(size, superko)
    cfg = ref_fns(size, superko)[0]
    want = jax_states(cfg, sts)
    got = torch_states(size, sts, superko)
    for name in jaxgo.GoState._fields:
        w = np.asarray(getattr(want, name)).astype(np.int64)
        g = getattr(got, name).numpy().astype(np.int64)
        np.testing.assert_array_equal(g, w, err_msg=name)
    # the batched fill reseeds what the host BFS skipped
    bare = torch_states(size, sts, superko, with_labels=False)
    assert (bare.labels == size * size).all()
    tcfg = torchgo.GoConfig(size=size, enforce_superko=superko)
    np.testing.assert_array_equal(
        torchgo.seed_labels(tcfg, bare).labels.numpy(),
        np.asarray(want.labels))


@pytest.mark.parametrize("size,superko", CASES)
def test_group_analysis_and_legality(size, superko):
    sts = games(size, superko)
    cfg, gd_fn, na_fn, legal_fn = ref_fns(size, superko)
    ref = jax_states(cfg, sts)
    st = torch_states(size, sts, superko)
    tcfg = torchgo.GoConfig(size=size, enforce_superko=superko)

    want = gd_fn(ref.board, ref.labels)
    got = torchgo.group_data(tcfg, st.board, with_member=True,
                             with_zxor=True, labels=st.labels)
    for name in ("labels", "sizes", "lib_counts", "member", "zxor"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy().astype(np.int64),
            np.asarray(getattr(want, name)).astype(np.int64),
            err_msg=name)
    # without carried labels the fill runs inside
    np.testing.assert_array_equal(
        torchgo.group_data(tcfg, st.board).lib_counts.numpy(),
        np.asarray(want.lib_counts))
    np.testing.assert_array_equal(
        torchgo.lib_counts_from_labels(tcfg, st.board, st.labels).numpy(),
        np.asarray(want.lib_counts))

    w_color, w_root, w_uniq, w_valid = na_fn(ref.board, ref.labels)
    g_color, g_root, g_uniq, g_valid = torchgo.neighbor_analysis(
        tcfg, st.board, st.labels)
    np.testing.assert_array_equal(g_color.numpy(), np.asarray(w_color))
    np.testing.assert_array_equal(g_root.numpy(), np.asarray(w_root))
    np.testing.assert_array_equal(g_uniq.numpy(), np.asarray(w_uniq))
    np.testing.assert_array_equal(
        np.broadcast_to(g_valid.numpy(), np.asarray(w_valid).shape),
        np.asarray(w_valid))

    legal = torchgo.legal_mask(tcfg, st).numpy()
    np.testing.assert_array_equal(legal, np.asarray(legal_fn(ref)))
    # and the oracle agrees on every board point
    for i, s in enumerate(sts):
        for p in range(size * size):
            assert legal[i, p] == s.is_legal(divmod(p, size))


@pytest.mark.parametrize("size", [9, 19])
def test_relabel_after_place_matches_reference(size):
    sts = games(size, False)
    cfg = jaxgo.GoConfig(size=size)
    tcfg = torchgo.GoConfig(size=size)
    rng = np.random.default_rng(size)
    for s in sts:
        legal = s.get_legal_moves()
        if not legal:
            continue
        mv = legal[rng.integers(len(legal))]
        pt = mv[0] * size + mv[1]
        after = s.copy()
        after.do_move(mv)
        cap = (np.asarray(s.board) != 0) & (np.asarray(after.board) == 0)
        ref = jaxgo.from_pygo(cfg, s)
        want = jaxgo.relabel_after_place(cfg, ref.board, ref.labels, pt,
                                         s.current_player, cap.reshape(-1))
        st = torch_states(size, [s])
        got = torchgo.relabel_after_place(
            tcfg, st.board, st.labels, torch.tensor([pt]),
            torch.tensor([s.current_player], dtype=torch.int8),
            torch.as_tensor(cap.reshape(1, -1)))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
        # and it is the fill of the new board
        np.testing.assert_array_equal(
            got[0].numpy(), torch_states(size, [after]).labels[0].numpy())
