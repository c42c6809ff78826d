"""The port's SGF converter against the reference's.

The 9×9 test games (``tests/test_data/game*.sgf``, ``handicap.sgf``)
and a free-setup record go through both packages' ``GameConverter``
with the reference converter's own ladder settings (depth 40, 16
lanes, 4 chase slots -- not ``Preprocess``'s default 6): all 48 planes
and every action bit-identical, with passes and without. Each package
reads the other's shards and manifest, and both skip the corrupt and
the non-SGF file with the same error count. One module-scoped
reference converter, so XLA compiles the ladder reader once.
"""

import glob
import inspect
import json
import os
import warnings

import numpy as np
import pytest

from rocalphago_tpu.data import pipeline as ref_pipeline
from rocalphago_tpu.data import sgf as ref_sgf
from rocalphago_tpu.data.convert import GameConverter as RefConverter
from rocalphago_tpu_torch.data import convert, pipeline, sgf
from rocalphago_tpu_torch.data.convert import GameConverter, run_game_converter
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_data")
GAMES = sorted(glob.glob(os.path.join(DATA, "game*.sgf"))) + [
    os.path.join(DATA, "handicap.sgf")]
FREE_SETUP = "(;GM[1]SZ[9]KM[6.5]AB[cc][dd]AW[gg][cd];W[dc];B[ee];W[];B[ef])"


@pytest.fixture(scope="module")
def ref_conv():
    return RefConverter(board_size=9)


@pytest.fixture(scope="module")
def conv():
    return GameConverter(board_size=9, device="cpu")


def test_converter_keeps_the_reference_ladder_settings(conv, ref_conv):
    ref = inspect.signature(RefConverter).parameters
    assert (convert.LADDER_DEPTH, convert.LADDER_LANES,
            convert.LADDER_CHASE_SLOTS) == (
        ref["ladder_depth"].default, ref["ladder_lanes"].default,
        ref["ladder_chase_slots"].default) == (40, 16, 4)
    assert conv.pre._encode.keywords == dict(
        features=conv.feature_list, ladder_depth=40, ladder_lanes=16,
        ladder_chase_slots=4)
    assert conv.pre.output_dim == ref_conv.pre.output_dim == 48


def read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("include_passes", [False, True])
def test_games_convert_bit_identical(conv, ref_conv, include_passes):
    texts = [read(p) for p in GAMES] + [FREE_SETUP]
    ladder_hits = np.zeros(2, np.int64)
    for text in texts:
        want_s, want_a = ref_conv.convert_game(text, include_passes)
        got_s, got_a = conv.convert_game(text, include_passes)
        assert got_s.dtype == np.uint8 and got_a.dtype == np.int32
        np.testing.assert_array_equal(got_a, want_a)
        np.testing.assert_array_equal(got_s, want_s)
        assert got_s.shape == (len(got_a), 9, 9, 48)
        ladder_hits += got_s[..., 44:46].sum(axis=(0, 1, 2), dtype=np.int64)
    # the ladder planes (44 capture, 45 escape) fire in these games, so
    # the chase settings are exercised
    assert (ladder_hits > 0).all()


def test_replay_yields_the_reference_states():
    for text in [read(p) for p in GAMES] + [FREE_SETUP]:
        mine = [(st.board.copy(), st.current_player, st.ko, mv, who,
                 st.zobrist_hash.copy(), st.stone_ages.copy())
                for st, mv, who in sgf.replay(sgf.parse(text))]
        ref = [(st.board.copy(), st.current_player, st.ko, mv, who,
                st.zobrist_hash.copy(), st.stone_ages.copy())
               for st, mv, who in ref_sgf.replay(ref_sgf.parse(text))]
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_each_package_reads_the_others_shards(conv, ref_conv, tmp_path):
    files = GAMES[:3]
    mine = conv.sgfs_to_shards(files, str(tmp_path / "port" / "c"),
                               shard_size=40)
    ref = ref_conv.sgfs_to_shards(files, str(tmp_path / "ref" / "c"),
                                  shard_size=40)
    assert mine == ref
    assert mine["format"] == "rocalphago_tpu/npz-shards/v1"
    assert mine["num_shards"] > 1
    with open(tmp_path / "port" / "c-manifest.json") as f:
        assert json.load(f) == mine
    parts = [conv.convert_game(read(p)) for p in files]
    want_s = np.concatenate([p[0] for p in parts])
    want_a = np.concatenate([p[1] for p in parts])
    idx = np.random.default_rng(0).permutation(len(want_a))
    for reader, writer in ((ref_pipeline, "port"), (pipeline, "ref")):
        ds = reader.ShardedDataset(str(tmp_path / writer / "c"))
        assert (len(ds), ds.planes, ds.board_size) == (len(want_a), 48, 9)
        got_s, got_a = ds.gather(idx)
        np.testing.assert_array_equal(got_s, want_s[idx])
        np.testing.assert_array_equal(got_a, want_a[idx])


def test_corrupt_and_non_sgf_files_are_skipped_alike(conv, ref_conv,
                                                     tmp_path):
    files = sorted(glob.glob(os.path.join(DATA, "*.sgf")))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mine = conv.sgfs_to_shards(files, str(tmp_path / "port" / "c"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_conv.sgfs_to_shards(files, str(tmp_path / "ref" / "c"))
    assert len(mine["errors"]) == len(ref["errors"]) == 2
    assert [e["file"] for e in mine["errors"]] == [
        e["file"] for e in ref["errors"]]
    assert sum("skipping" in str(w.message) for w in caught) == 2
    assert mine["num_games"] == ref["num_games"] == 5
    assert mine["shard_counts"] == ref["shard_counts"]
    with pytest.raises(sgf.SGFError):
        conv.sgfs_to_shards(files, str(tmp_path / "strict" / "c"),
                            ignore_errors=False)


def test_cli_writes_the_manifest(tmp_path, capsys):
    src = tmp_path / "games"
    src.mkdir()
    for p in GAMES[:2]:
        (src / os.path.basename(p)).write_text(read(p))
    out = run_game_converter(["--directory", str(src), "--outfile",
                              str(tmp_path / "out" / "c"), "--size", "9",
                              "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == out
    assert out["num_games"] == 2 and out["num_shards"] == 1
