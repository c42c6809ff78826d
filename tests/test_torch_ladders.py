"""The port's ladder planes against the reference's, beyond the shared
48-plane encodes of ``tests/test_torch_features.py`` and
``tests/test_torch_features19.py``: chase-slot
overflow (more live chases than ``ladder_chase_slots``, where both
packages read the same chases and leave the rest a conservative
False) and the single-plane readers an encode with only one ladder
plane takes. Tolerance: exact. The reference runs with JAX's internal
consistency checks off, as in ``tests/test_torch_features.py``.
"""

import numpy as np
import pytest

from rocalphago_tpu.engine import pygo
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.features import Preprocess as TPreprocess
from test_torch_features import encode_both, ladder_boards, zigzag_boards
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PLANES = ("ladder_capture", "ladder_escape")


def two_ladder_board():
    """Two independent standard ladders on 9×9 (white flanked on three
    sides, black to move): two live chases, both working."""
    st = pygo.GameState(size=9, komi=5.5)
    for r, c in ((2, 2), (6, 5)):
        st.do_move((r - 1, c), pygo.BLACK)
        st.do_move((r, c), pygo.WHITE)
        st.do_move((r, c - 1), pygo.BLACK)
        st.do_move((r + 1, c - 1), pygo.BLACK)
    st.current_player = pygo.BLACK
    return st


def test_chase_slot_overflow_stays_conservative():
    """Two live chases through one shared slot: both packages read the
    same first chase and leave the other a conservative False, which
    more slots then assert."""
    st = two_ladder_board()
    want, got = encode_both(9, [st], features=PLANES, ladder_chase_slots=1)
    np.testing.assert_array_equal(got, want)
    cfg = torchgo.GoConfig(size=9, komi=5.5)
    full = TPreprocess(PLANES, cfg=cfg, device="cpu", ladder_chase_slots=8) \
        .states_to_tensor(torchgo.from_pygo(cfg, [st], device="cpu")).numpy()
    assert int(got[0, ..., 0].sum()) == 1 and int(full[0, ..., 0].sum()) == 2
    assert not ((got == 1) & (full == 0)).any()


@pytest.mark.parametrize("plane", PLANES)
def test_single_ladder_plane_encodes(plane):
    """One ladder plane alone takes the per-plane reader. One chase
    slot covers these boards (at most one live chase each) and keeps
    the reference's program small to build."""
    states = ladder_boards() + list(zigzag_boards())[:4]
    want, got = encode_both(9, states, features=(plane,),
                            ladder_chase_slots=1)
    np.testing.assert_array_equal(got, want)
    assert want.any()
