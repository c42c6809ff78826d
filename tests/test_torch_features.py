"""The port's 48-plane encoder against the reference's.

Positions go through ``from_pygo`` of both packages, then the
reference's ``Preprocess.states_to_tensor`` and the port's (on the CPU,
where the ladder chase and the group fill run their plain versions).
The planes must be bit-identical: random 9×9 positions and the curated
ladder shapes of ``tests/test_features.py`` (``TestLadders``, the
``TestLadderDifferential`` zigzag family, the ``TestSharedGating``
boards). Tolerance: exact. 19×19 positions are in
``tests/test_torch_features19.py``, chase-slot overflow and the
single-plane readers in ``tests/test_torch_ladders.py`` (each file
builds its own reference programs, which is what costs).

The reference runs with JAX's internal consistency checks
(``jax_enable_checks``, which ``tests/conftest.py`` turns on) off: they
check JAX's own tracing, not the reference's answers, and make these
encoder programs several times slower to build.
"""

import jax
import numpy as np
import pytest

import test_features as ref_tests
from rocalphago_tpu.engine import jaxgo, pygo
from rocalphago_tpu.features import Preprocess
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.features import Preprocess as TPreprocess
from torch_port_helpers import (  # noqa: F401
    jax_states,
    one_torch_thread,
    random_games,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def encode_both(size, states, features=None, **kw):
    """(reference planes, port planes) as numpy ``[B, s, s, F]``."""
    features = features or ref_tests.DEFAULT_FEATURES
    cfg = jaxgo.GoConfig(size=size, komi=5.5)
    with jax.enable_checks(False):
        ref = Preprocess(features, cfg=cfg, **kw)
        want = np.asarray(ref.states_to_tensor(jax_states(cfg, states)))
    tcfg = torchgo.GoConfig(size=size, komi=5.5)
    port = TPreprocess(features, cfg=tcfg, device="cpu", **kw)
    batch = torchgo.seed_labels(tcfg, torchgo.from_pygo(
        tcfg, states, device="cpu", with_labels=False))
    return want, port.states_to_tensor(batch).numpy()


def zigzag_boards():
    """``TestLadderDifferential``'s shifted standard ladders, with and
    without a breaker stone on the path."""
    for dx, dy in [(0, 0), (1, 2), (2, 1), (2, 2), (1, 1), (0, 2)]:
        for breaker in (None, (4 + dx, 4 + dy)):
            st = pygo.GameState(size=9, komi=5.5)
            st.do_move((1 + dx, 2 + dy), pygo.BLACK)
            st.do_move((2 + dx, 2 + dy), pygo.WHITE)
            st.do_move((2 + dx, 1 + dy), pygo.BLACK)
            st.do_move((7, 1), pygo.WHITE)
            st.do_move((3 + dx, 1 + dy), pygo.BLACK)
            if breaker and st.board[breaker] == 0:
                st.do_move(breaker, pygo.WHITE)
            st.current_player = pygo.BLACK
            yield st


def ladder_boards():
    """``TestLadders``: the working and the broken ladder, and the
    escape position (white in atari) with and without the breaker."""
    tl = ref_tests.TestLadders()
    out = [tl.ladder_position(), tl.ladder_position(breaker=(6, 6))]
    for breaker in (None, (6, 6)):
        st = tl.ladder_position(breaker=breaker)
        st.do_move((2, 3), pygo.BLACK)
        st.current_player = pygo.WHITE
        out.append(st)
    return out


def gating_boards():
    """``TestSharedGating``'s family: random mid-games, the curated
    ladders and the first-line edge/corner ladders."""
    rng = np.random.default_rng(20260804)
    boards = []
    for _ in range(4):
        st = pygo.GameState(size=9, komi=5.5)
        for _ in range(int(rng.integers(10, 41))):
            legal = st.get_legal_moves(include_eyes=False)
            if not legal or st.is_end_of_game:
                break
            st.do_move(legal[rng.integers(len(legal))])
        if not st.is_end_of_game:
            boards.append(st)
    return (boards + ladder_boards()[:2]
            + list(ref_tests.TestSharedGating._edge_boards()))


@pytest.fixture(scope="module")
def nine():
    """One reference compile for every 9×9 family: ``{name: (want,
    got)}`` sliced out of one batched encode."""
    families = {
        "random": random_games(9, 8, 5, 60, seed=9, komi=5.5),
        "ladders": ladder_boards(),
        "zigzag": list(zigzag_boards()),
        "gating": gating_boards(),
    }
    states = [s for fam in families.values() for s in fam]
    want, got = encode_both(9, states)
    out, i = {}, 0
    for name, fam in families.items():
        out[name] = (want[i:i + len(fam)], got[i:i + len(fam)])
        i += len(fam)
    return out


@pytest.mark.parametrize("family", ["random", "ladders", "zigzag",
                                    "gating"])
def test_9x9_planes_bit_identical(nine, family):
    want, got = nine[family]
    assert want.shape == got.shape and want.shape[-1] == 48
    np.testing.assert_array_equal(got, want)
    if family in ("ladders", "zigzag"):
        assert want[..., 44:46].any()     # the ladder planes fire


def test_preprocess_contract():
    pre = TPreprocess(device="cpu")
    assert pre.output_dim == 48
    with pytest.raises(KeyError):
        TPreprocess(("board", "frobnicate"), device="cpu")
    st = torchgo.from_pygo(torchgo.GoConfig(), pygo.GameState(),
                           device="cpu")
    planes = pre.state_to_tensor(st).numpy()[0]
    assert planes.shape == (19, 19, 48)
    # the empty board, black to move: the empty, ones, capture-size-0
    # and sensibleness planes are full, liberties-after is 2 in the
    # corners, 3 on the edges and 4 inside, and nothing else is set
    full = [2, 3, 20, 46]
    assert planes[..., full].all()
    libs = planes[..., 37] * 2 + planes[..., 38] * 3 + planes[..., 39] * 4
    assert libs[0, 0] == 2 and libs[0, 5] == 3 and libs[5, 5] == 4
    rest = [k for k in range(48) if k not in full + [37, 38, 39]]
    assert not planes[..., rest].any()
