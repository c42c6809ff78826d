"""The SGF writers of a host game (``data/sgf.py``'s ``from_gamestate``
and ``save_gamestate``) against the reference's, on the CPU.

The same moves drive both packages' pygo games; the rendered records
are equal byte for byte but the ``AP[]`` application name, for a
finished game (scored), a handicap game and a game in progress, and a
saved file parses back to the game it was written from.
"""

import numpy as np
import pytest

from rocalphago_tpu.data import sgf as ref_sgf
from rocalphago_tpu.engine import pygo as ref_pygo
from rocalphago_tpu_torch.data import sgf
from rocalphago_tpu_torch.engine import pygo


def play(size, handicaps, plies, seed, komi=6.5):
    """Both packages' games under the same random legal moves (the
    reference's game chooses; passes 10% of the time, two in a row end
    the game): ``(reference state, port state)``."""
    rng = np.random.default_rng(seed)
    ref = ref_pygo.GameState(size=size, komi=komi)
    port = pygo.GameState(size=size, komi=komi)
    if handicaps:
        ref.place_handicaps(handicaps)
        port.place_handicaps(handicaps)
    for _ in range(plies):
        if ref.is_end_of_game:
            break
        legal = ref.get_legal_moves(include_eyes=False)
        mv = None if not legal or rng.random() < 0.1 \
            else legal[rng.integers(len(legal))]
        ref.do_move(mv)
        port.do_move(mv)
    return ref, port


def strip_app(text: str, app: str) -> str:
    tag = f"AP[{app}]"
    assert text.count(tag) == 1, text[:80]
    return text.replace(tag, "AP[]")


CASES = {
    "finished": dict(size=9, handicaps=[], plies=400, seed=1),
    "handicap": dict(size=9, handicaps=[(2, 2), (6, 6), (2, 6)], plies=30,
                     seed=2),
    "handicap_finished": dict(size=7, handicaps=[(1, 1), (5, 5)],
                              plies=400, seed=3),
    "in_progress": dict(size=19, handicaps=[], plies=60, seed=4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_records_are_the_references_byte_for_byte(case, tmp_path):
    ref, port = play(**CASES[case])
    assert ref.is_end_of_game == port.is_end_of_game == (
        case.endswith("finished"))
    want = ref_sgf.from_gamestate(ref)
    got = sgf.from_gamestate(port)
    assert (got.result != "") == port.is_end_of_game
    assert (got.size, got.komi, got.handicap, got.setup_black,
            got.setup_white, got.moves, got.result, got.properties) == (
        want.size, want.komi, want.handicap, want.setup_black,
        want.setup_white, want.moves, want.result, want.properties)
    text = strip_app(sgf.render(got), "rocalphago_tpu_torch")
    assert text == strip_app(ref_sgf.render(want), "rocalphago_tpu")

    # save_gamestate round-trips through parse (both packages' readers)
    path = tmp_path / "game.sgf"
    sgf.save_gamestate(port, str(path))
    saved = path.read_text()
    assert strip_app(saved, "rocalphago_tpu_torch") == text
    for lib in (sgf, ref_sgf):
        back = lib.parse(saved)
        assert (back.size, back.komi, back.handicap, back.setup_black,
                back.moves, back.result) == (
            got.size, got.komi, got.handicap, got.setup_black, got.moves,
            got.result)
    # and replays to the saved position (the generator plays each move
    # after yielding it, the last one as it runs out)
    replayed = None
    for replayed, _, _ in sgf.replay(sgf.parse(saved)):
        pass
    np.testing.assert_array_equal(replayed.board, port.board)
    assert replayed.is_end_of_game == port.is_end_of_game
