"""Minimal SGF (Smart Game Format) reader/writer, host-side.

A copy of what the self-play CLI and the converter need from the
reference package's ``data/sgf.py``: :class:`SGFGame`, :func:`parse`,
:func:`replay`, :func:`render` and :func:`from_moves`. Only the subset of SGF needed for Go game records
is implemented: one gametree, ``SZ/KM/HA/RE`` headers, ``AB/AW`` setup
stones, ``B/W`` move nodes, pass as ``[]`` or ``[tt]`` (boards ≤ 19).

Coordinates: SGF ``"ab"`` = column a (y=0), row b (x=1) → our ``(x, y)``
board indices; the writer emits the inverse mapping.
"""

from __future__ import annotations

import re
import string
from dataclasses import dataclass, field

import numpy as np

from rocalphago_tpu_torch.engine import pygo
from rocalphago_tpu_torch.engine.zobrist import position_table

_LETTERS = string.ascii_lowercase


class SGFError(ValueError):
    pass


@dataclass
class SGFGame:
    size: int = 19
    komi: float = 7.5
    handicap: int = 0
    setup_black: list = field(default_factory=list)  # AB points (x, y)
    setup_white: list = field(default_factory=list)  # AW points
    moves: list = field(default_factory=list)        # (color, (x,y)|None)
    result: str = ""                                 # RE value, e.g. B+3.5
    properties: dict = field(default_factory=dict)   # other root props

    @property
    def winner(self) -> int:
        if self.result.upper().startswith("B"):
            return pygo.BLACK
        if self.result.upper().startswith("W"):
            return pygo.WHITE
        return 0


_TOKEN = re.compile(
    r"\s*(?:;|\(|\)|([A-Za-z]{1,8})((?:\s*\[(?:[^\]\\]|\\.)*\])+))",
    re.DOTALL)
_VALUE = re.compile(r"\[((?:[^\]\\]|\\.)*)\]", re.DOTALL)


def _point(val: str, size: int):
    """SGF coordinate value → (x, y) or None for pass."""
    val = val.strip()
    if val == "" or (val == "tt" and size <= 19):
        return None
    if len(val) != 2 or val[0] not in _LETTERS or val[1] not in _LETTERS:
        raise SGFError(f"bad point {val!r}")
    y, x = _LETTERS.index(val[0]), _LETTERS.index(val[1])
    if not (0 <= x < size and 0 <= y < size):
        raise SGFError(f"point {val!r} off a {size}x{size} board")
    return (x, y)


def parse(text: str) -> SGFGame:
    """Parse the first gametree of an SGF document (variations beyond
    the main line are ignored, as in the reference pipeline)."""
    if "(" not in text or ";" not in text:
        raise SGFError("not an SGF document")
    game = SGFGame()
    # The first child gametree at any branch point is the main-line
    # continuation (SGF spec); later siblings are variations and are
    # skipped. ``children[-1]`` counts subtrees opened at the current
    # level; ``skip_depth`` marks the shallowest variation being skipped.
    depth = 0
    children = [0]
    skip_depth: int | None = None
    seen_props: list[tuple[str, list[str]]] = []
    for m in _TOKEN.finditer(text):
        tok = m.group(0).strip()
        if tok == "(":
            children[-1] += 1
            if skip_depth is None and depth >= 1 and children[-1] > 1:
                skip_depth = depth + 1
            depth += 1
            children.append(0)
            continue
        if tok == ")":
            depth -= 1
            children.pop()
            if skip_depth is not None and depth < skip_depth:
                skip_depth = None
            if depth <= 0:
                break
            continue
        if tok == ";" or skip_depth is not None:
            continue
        ident = m.group(1).upper()
        # SGF escaping: backslash makes the next char literal
        values = [re.sub(r"\\(.)", r"\1", v.group(1), flags=re.DOTALL)
                  for v in _VALUE.finditer(m.group(2))]
        seen_props.append((ident, values))
    if not seen_props:
        raise SGFError("no SGF properties found")

    # first pass: size must be known before points are parsed
    for ident, values in seen_props:
        if ident == "SZ":
            try:
                game.size = int(values[0])
            except ValueError as e:
                raise SGFError(f"bad SZ {values[0]!r}") from e
            if not (2 <= game.size <= 26):
                raise SGFError(f"unsupported board size {game.size}")
    for ident, values in seen_props:
        if ident == "SZ":
            continue
        elif ident == "KM":
            try:
                game.komi = float(values[0])
            except ValueError:
                game.komi = 7.5
        elif ident == "HA":
            game.handicap = int(values[0])
        elif ident == "AB":
            game.setup_black += [_point(v, game.size) for v in values]
        elif ident == "AW":
            game.setup_white += [_point(v, game.size) for v in values]
        elif ident == "RE":
            game.result = values[0]
        elif ident in ("B", "W"):
            color = pygo.BLACK if ident == "B" else pygo.WHITE
            game.moves.append((color, _point(values[0], game.size)))
        else:
            game.properties.setdefault(ident, values[0])
    return game


def replay(game: SGFGame, enforce_superko: bool = False):
    """Build the initial GameState for ``game`` and yield
    ``(state, move, player)`` before each move is applied — the
    reference's ``sgf_iter_states`` contract. The caller may encode
    ``state`` and then the generator plays ``move``."""
    st = pygo.GameState(size=game.size, komi=game.komi,
                        enforce_superko=enforce_superko)
    if game.setup_black and not game.setup_white:
        st.place_handicaps(game.setup_black)
    elif game.setup_black or game.setup_white:
        # free setup (AB+AW): stones get age 0, same as handicaps
        for p in game.setup_black:
            st.board[p] = pygo.BLACK
            st.stone_ages[p] = 0
        for p in game.setup_white:
            st.board[p] = pygo.WHITE
            st.stone_ages[p] = 0
        # re-derive the carried hash from the raw setup edits, then
        # restart the superko history at the setup position
        zob = position_table(st.size)
        h = np.zeros(2, np.uint32)
        for p in game.setup_black:
            h = h ^ zob[p[0] * st.size + p[1], 0]
        for p in game.setup_white:
            h = h ^ zob[p[0] * st.size + p[1], 1]
        st.zobrist_hash = h
        st._hash_history = dict.fromkeys([h.tobytes()])
    if game.moves:
        # the record's first move decides whose turn it is after setup
        st.current_player = game.moves[0][0]
    for color, move in game.moves:
        yield st, move, color
        st.do_move(move, color)


def render(game: SGFGame, app: str = "rocalphago_tpu_torch") -> str:
    """Serialize a game back to SGF text."""
    def pt(p):
        if p is None:
            return ""
        x, y = p
        return f"{_LETTERS[y]}{_LETTERS[x]}"

    def esc(val) -> str:
        return str(val).replace("\\", "\\\\").replace("]", "\\]")

    # only game-info properties belong in the root node; parse()
    # collects unhandled props from every node, so unknown keys (e.g.
    # per-move C comments) must not be relocated here
    root_props = ("PB", "PW", "PL", "GN", "DT", "EV", "RO", "SO", "US",
                  "AN", "CP", "GC", "RU", "TM", "OT", "CA", "ST", "HA")
    parts = [f"(;GM[1]FF[4]AP[{app}]SZ[{game.size}]KM[{game.komi}]"]
    if game.result:
        parts.append(f"RE[{esc(game.result)}]")
    for key in root_props:
        if key in game.properties:
            parts.append(f"{key}[{esc(game.properties[key])}]")
    if game.setup_black:
        parts.append("AB" + "".join(f"[{pt(p)}]" for p in game.setup_black))
    if game.setup_white:
        parts.append("AW" + "".join(f"[{pt(p)}]" for p in game.setup_white))
    for color, move in game.moves:
        tag = "B" if color == pygo.BLACK else "W"
        parts.append(f";{tag}[{pt(move)}]")
    parts.append(")")
    return "".join(parts)


def from_moves(size: int, komi: float, moves, result: str = "") -> SGFGame:
    """Build an SGFGame from engine-style (color, (x,y)|None) moves —
    used by self-play to persist games."""
    return SGFGame(size=size, komi=komi, moves=list(moves), result=result)
