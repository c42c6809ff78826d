"""Feature names and plane counts: the feature⇄network contract.

The constants of the reference's ``features/pyfeatures.py`` that the
encoder and the saved model specs read (the host oracle encoder there
stays in the reference). Plane layout (48 in ``DEFAULT_FEATURES``
order): board 3, ones 1, turns_since 8, liberties 8, capture_size 8,
self_atari_size 8, liberties_after 8, ladder_capture 1, ladder_escape
1, sensibleness 1, zeros 1; ``color`` (1) is the value net's 49th.
"""

from __future__ import annotations

DEFAULT_FEATURES = (
    "board", "ones", "turns_since", "liberties", "capture_size",
    "self_atari_size", "liberties_after", "ladder_capture",
    "ladder_escape", "sensibleness", "zeros",
)

# the value net's 49-plane input: the 48 policy planes + player color
VALUE_FEATURES = DEFAULT_FEATURES + ("color",)

#: the two handcrafted ladder plane groups
LADDER_FEATURES = ("ladder_capture", "ladder_escape")

FEATURE_PLANES = {
    "board": 3, "ones": 1, "turns_since": 8, "liberties": 8,
    "capture_size": 8, "self_atari_size": 8, "liberties_after": 8,
    "ladder_capture": 1, "ladder_escape": 1, "sensibleness": 1,
    "zeros": 1, "color": 1,
}


def output_planes(features=DEFAULT_FEATURES) -> int:
    return sum(FEATURE_PLANES[f] for f in features)
