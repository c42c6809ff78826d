"""The C++ game replayer (``data/native.py`` over ``csrc/goreplay.cpp``)
against the reference's and the pygo oracle, on the CPU.

* The reference's ``tests/test_native.py`` cases on both libraries:
  exact parity with pygo per board size, the ply of an illegal move,
  handicap setup; the outputs of ``replay_arrays`` bit-identical across
  the packages.
* The converter: the native replay equals the pygo replay it keeps as
  its plain version (passes, handicaps, free setup, out-of-turn moves),
  and its shards and manifest equal the reference converter's for the
  same SGFs.
* The build: into ``build/native/`` from the port's own copy of the
  source; a failed build (or no compiler) raises and the converter does
  not fall back; the reference's ``native/libgoreplay.so`` is neither
  created nor rewritten.
"""

import json
import os

import numpy as np
import pytest

from rocalphago_tpu.data import native as ref_native
from rocalphago_tpu.data.convert import GameConverter as RefConverter
from rocalphago_tpu_torch.data import native
from rocalphago_tpu_torch.data import sgf as sgflib
from rocalphago_tpu_torch.data.convert import GameConverter
from rocalphago_tpu_torch.engine import pygo
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_LIB = os.path.join(ROOT, "native", "libgoreplay.so")
FEATURES = ("board", "ones", "turns_since", "liberties")


def random_game(size, seed, plies=50):
    """The reference test's game: random legal moves (eyes included),
    5% passes, with each pre-move snapshot of the port's pygo."""
    rng = np.random.default_rng(seed)
    st = pygo.GameState(size=size, komi=5.5)
    moves, colors, snaps = [], [], []
    for _ in range(plies):
        legal = st.get_legal_moves(include_eyes=True)
        snaps.append((
            np.asarray(st.board, np.int8).reshape(-1).copy(),
            st.current_player,
            -1 if st.ko is None else st.ko[0] * size + st.ko[1],
            st.turns_played,
            np.asarray(st.stone_ages, np.int32).reshape(-1).copy()))
        mv = None if not legal or rng.random() < 0.05 \
            else legal[rng.integers(len(legal))]
        moves.append(size * size if mv is None
                     else mv[0] * size + mv[1])
        colors.append(st.current_player)
        st.do_move(mv)
        if st.is_end_of_game:
            break
    return moves[:len(snaps)], colors[:len(snaps)], snaps


def both(*args):
    """``replay_arrays`` of both libraries on the same game, held equal
    bit for bit (values and dtypes); returns the port's."""
    got = native.replay_arrays(*args)
    want = ref_native.replay_arrays(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("size", [5, 9, 19])
def test_exact_parity_with_pygo_and_the_reference(size):
    for seed in range(10):
        moves, colors, snaps = random_game(size, seed)
        boards, to_move, kos, steps, ages = both(size, [], [], moves, colors)
        assert len(boards) == len(snaps)
        for t, (b, p, ko, s, ag) in enumerate(snaps):
            assert (boards[t] == b).all()
            assert to_move[t] == p
            assert kos[t] == ko
            assert steps[t] == s
            assert (ages[t] == ag).all()


def test_illegal_move_reports_ply():
    for lib in (native, ref_native):
        with pytest.raises(lib.IllegalReplay) as e:
            lib.replay_arrays(5, [], [], [12, 12], [1, -1])
        assert e.value.ply == 1 and isinstance(e.value, ValueError)
        # a setup collision is ply 0; moves after the game ended are
        # illegal too
        with pytest.raises(lib.IllegalReplay) as e:
            lib.replay_arrays(5, [3], [3], [0], [1])
        assert e.value.ply == 0
        with pytest.raises(lib.IllegalReplay) as e:
            lib.replay_arrays(5, [], [], [25, 25, 0], [1, -1, 1])
        assert e.value.ply == 2
    assert [len(x) for x in both(5, [], [], [], [])] == [0] * 5


def test_handicap_setup_matches_pygo():
    size = 9
    pts = [(2, 2), (6, 6)]
    st = pygo.GameState(size=size)
    st.place_handicaps(pts)
    st.do_move((4, 4))  # white (handicap passes turn to white)
    boards, to_move, _, steps, ages = both(
        size, [p[0] * size + p[1] for p in pts], [],
        [4 * size + 4, 0], [pygo.WHITE, pygo.BLACK])
    assert to_move[0] == pygo.WHITE
    for p in pts:
        assert boards[0][p[0] * size + p[1]] == pygo.BLACK
        assert ages[0][p[0] * size + p[1]] == 0
    np.testing.assert_array_equal(
        boards[1], np.asarray(st.board, np.int8).reshape(-1))
    np.testing.assert_array_equal(
        ages[1], np.asarray(st.stone_ages, np.int32).reshape(-1))
    assert steps[1] == st.turns_played


def sgf_texts(size=9):
    """Records of every shape the converter meets: plain games with
    passes, a handicap game, free setup with an out-of-turn move."""
    texts = []
    for seed in range(3):
        moves, colors, _ = random_game(size, seed, plies=40)
        texts.append(sgflib.render(sgflib.from_moves(
            size, 5.5, [(c, None if m == size * size else divmod(m, size))
                        for c, m in zip(colors, moves)])))
    st = pygo.GameState(size=size)
    st.place_handicaps([(2, 2), (6, 6), (2, 6)])
    for mv in [(4, 4), (3, 3), (5, 5), None, (3, 5)]:
        st.do_move(mv)
    texts.append(sgflib.render(sgflib.from_gamestate(st)))
    texts.append(f"(;GM[1]SZ[{size}]KM[6.5]AB[cc][dd]AW[ee]"
                 ";W[ff];B[gg];B[hh];W[];B[aa])")
    return texts


@pytest.mark.parametrize("include_passes", [False, True])
def test_the_converter_replays_natively_as_pygo_does(include_passes):
    conv = GameConverter(FEATURES, board_size=9, device="cpu")
    for text in sgf_texts():
        game = sgflib.parse(text)
        got_f, got_a = conv._replay_native(game, include_passes)
        want_f, want_a = conv._replay_pygo(game, include_passes)
        assert got_a == want_a and len(got_f) == len(want_f) > 0
        for g, w in zip(got_f, want_f):
            for x, y in zip(g, w):
                assert np.asarray(x).dtype == np.asarray(y).dtype
                np.testing.assert_array_equal(x, y)
        states, actions = conv.convert_game(text, include_passes)
        np.testing.assert_array_equal(actions, np.asarray(want_a, np.int32))
        np.testing.assert_array_equal(states, conv._encode_fields(want_f))


def test_shards_are_the_reference_converters(tmp_path):
    files = []
    for i, text in enumerate(sgf_texts() + ["(;GM[1]SZ[9];B[ee];W[ee])"]):
        path = tmp_path / f"g{i}.sgf"
        path.write_text(text)
        files.append(str(path))
    port = GameConverter(FEATURES, board_size=9, device="cpu")
    ref = RefConverter(FEATURES, board_size=9)
    manifests = []
    for conv, name in ((ref, "ref"), (port, "port")):
        with pytest.warns(UserWarning, match="illegal move at ply 1"):
            manifests.append(conv.sgfs_to_shards(
                files, str(tmp_path / name / "corpus"), shard_size=64))
    want, got = manifests
    assert got == want and got["num_shards"] > 1
    assert [e["error"] for e in got["errors"]] == ["illegal move at ply 1"]
    for i in range(got["num_shards"]):
        a = np.load(tmp_path / "ref" / f"corpus-{i:05d}.npz")
        b = np.load(tmp_path / "port" / f"corpus-{i:05d}.npz")
        for k in ("states", "actions"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    with open(tmp_path / "port" / "corpus-manifest.json") as f:
        assert json.load(f) == got


# --------------------------------------------------------------- build


def stat(path):
    try:
        s = os.stat(path)
    except FileNotFoundError:
        return None
    return (s.st_ino, s.st_size, s.st_mtime_ns)


def test_builds_its_own_copy_into_build_and_never_the_references(
        monkeypatch, tmp_path):
    # the reference's library as its own tests leave it, before and
    # after every build of the port's
    assert ref_native.available()
    before = stat(REF_LIB)
    lib = native.load()
    assert native.library_path().startswith(
        os.path.join(ROOT, "build", "native") + os.sep)
    assert os.path.exists(native.library_path())
    assert native.SOURCE == os.path.join(
        ROOT, "rocalphago_tpu_torch", "csrc", "goreplay.cpp")
    assert lib is native.load()
    # a fresh build, from scratch
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native, "_lib", None)
    fresh = native.load()
    assert fresh is not lib and os.listdir(tmp_path / "b") == [
        os.path.basename(native.library_path())]
    moves, colors, _ = random_game(9, 7)
    both(9, [], [], moves, colors)
    assert stat(REF_LIB) == before


def test_a_failed_build_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    bad = tmp_path / "goreplay.cpp"
    bad.write_text("int go_replay( {\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.replay_arrays(5, [], [], [0], [1])
    assert not os.path.exists(native.library_path())
    assert os.listdir(tmp_path / "b") == []     # no temporary left
    conv = GameConverter(FEATURES, board_size=9, device="cpu")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        conv.convert_game(sgf_texts()[0])
    one = tmp_path / "one.sgf"
    one.write_text(sgf_texts()[0])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        conv.sgfs_to_shards([str(one)], str(tmp_path / "c"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load()
