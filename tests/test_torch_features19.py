"""The port's 48-plane encoder against the reference's at 19×19:
seeded random positions and the six-ladder board of
``tests/test_features.py::TestLadderOverflow`` (six live chases, which
the default six chase slots cover). Bit-identical planes, as in
``tests/test_torch_features.py``, whose helpers this file shares.
"""

import numpy as np
import pytest

import test_features as ref_tests
from test_torch_features import encode_both
from torch_port_helpers import one_torch_thread, random_games  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def overflow_board():
    return ref_tests.TestLadderOverflow()._board()


def test_19x19_planes_bit_identical():
    states = random_games(19, 4, 20, 220, seed=19, komi=5.5)
    states.append(overflow_board())
    want, got = encode_both(19, states)
    np.testing.assert_array_equal(got, want)
    assert want[-1, ..., 44].sum() == 6   # six live ladders, six slots
