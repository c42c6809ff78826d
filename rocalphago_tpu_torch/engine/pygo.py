"""Pure-Python Go rules oracle (host side).

A copy of the reference package's ``engine/pygo.py`` with its hashes
drawn from the port's own :mod:`.zobrist`. It mirrors the original
engine's public API (``do_move``, ``is_legal``, ``get_legal_moves``,
``get_winner``, ``copy``, ``is_eye``, constants
``BLACK/WHITE/EMPTY/PASS_MOVE``) and is the bookkeeping engine behind
the GTP adapter (:mod:`rocalphago_tpu_torch.interface.gtp`).

Rules: positional superko (optional, simple-ko always), suicide illegal,
two consecutive passes end the game, area (Chinese) scoring with komi.

Positions are identified by the same incremental uint32[2] Zobrist
hash the batched engine carries: superko is hash membership, and the
hash crosses the ``torchgo.from_pygo`` bridge verbatim.
"""

from __future__ import annotations

import numpy as np

from rocalphago_tpu_torch.engine import zobrist as zobrist_tables

BLACK = 1
WHITE = -1
EMPTY = 0
PASS_MOVE = None

_NEIGHBOR_OFFSETS = ((1, 0), (-1, 0), (0, 1), (0, -1))
_DIAGONAL_OFFSETS = ((1, 1), (1, -1), (-1, 1), (-1, -1))


class IllegalMove(Exception):
    pass


class Suicide(IllegalMove):
    pass


class GameState:
    """Mutable Go position with full rules bookkeeping.

    Parameters
    ----------
    size : board edge length (default 19).
    komi : compensation added to White's area score.
    enforce_superko : if True, forbid recreating any earlier whole-board
        position (positional superko); simple ko is always enforced.
    """

    def __init__(self, size: int = 19, komi: float = 7.5,
                 enforce_superko: bool = False):
        self.size = size
        self.komi = komi
        self.enforce_superko = enforce_superko
        self.board = np.zeros((size, size), dtype=np.int8)
        self.current_player = BLACK
        self.ko = None  # point banned by simple ko, or None
        self.history: list = []  # moves as (x, y) or PASS_MOVE
        self.num_black_prisoners = 0
        self.num_white_prisoners = 0
        self.is_end_of_game = False
        self.passes_black = 0
        self.passes_white = 0
        # move number at which the stone currently at (x, y) was placed
        # (-1 for empty); backs the turns-since feature plane.
        self.stone_ages = np.full((size, size), -1, dtype=np.int32)
        self.turns_played = 0
        # incremental position hash (uint32[2], shared Zobrist scheme
        # with the batched engine) and the insertion-ordered set of
        # hashes seen so far (for superko); the empty board hashes to
        # zeros in both engines.
        self.zobrist_hash = np.zeros(2, dtype=np.uint32)
        self._hash_history = dict.fromkeys([self.zobrist_hash.tobytes()])
        self.handicaps: list = []

    # ---------------------------------------------------------------- basics

    def copy(self) -> "GameState":
        other = GameState(self.size, self.komi, self.enforce_superko)
        other.board = self.board.copy()
        other.current_player = self.current_player
        other.ko = self.ko
        other.history = list(self.history)
        other.num_black_prisoners = self.num_black_prisoners
        other.num_white_prisoners = self.num_white_prisoners
        other.is_end_of_game = self.is_end_of_game
        other.passes_black = self.passes_black
        other.passes_white = self.passes_white
        other.stone_ages = self.stone_ages.copy()
        other.turns_played = self.turns_played
        other.zobrist_hash = self.zobrist_hash.copy()
        other._hash_history = dict(self._hash_history)
        other.handicaps = list(self.handicaps)
        return other

    def _on_board(self, point) -> bool:
        x, y = point
        return 0 <= x < self.size and 0 <= y < self.size

    def get_neighbors(self, point):
        x, y = point
        return [(x + dx, y + dy) for dx, dy in _NEIGHBOR_OFFSETS
                if self._on_board((x + dx, y + dy))]

    def get_diagonals(self, point):
        x, y = point
        return [(x + dx, y + dy) for dx, dy in _DIAGONAL_OFFSETS
                if self._on_board((x + dx, y + dy))]

    # ----------------------------------------------------------- group logic

    def get_group(self, point):
        """(stones, liberties) of the group containing ``point`` (BFS)."""
        color = self.board[point]
        if color == EMPTY:
            return set(), set()
        return _group_on(self.board, point, self.size)

    def liberty_count(self, point) -> int:
        return len(self.get_group(point)[1])

    # -------------------------------------------------------------- legality

    def _simulate(self, action, color):
        """Board after ``color`` plays ``action`` (with captures), plus the
        set of captured stones. Raises IllegalMove on occupied/suicide."""
        x, y = action
        if self.board[x, y] != EMPTY:
            raise IllegalMove(f"occupied point {action}")
        board = self.board.copy()
        board[x, y] = color
        captured = set()
        for n in self.get_neighbors(action):
            if board[n] == -color:
                stones, libs = _group_on(board, n, self.size)
                if not libs:
                    captured |= stones
        for p in captured:
            board[p] = EMPTY
        _, own_libs = _group_on(board, action, self.size)
        if not own_libs:
            raise Suicide(f"suicide at {action}")
        return board, captured

    def _hash_after(self, action, color, captured) -> np.ndarray:
        """Position hash after ``color`` plays ``action`` capturing the
        ``captured`` stones — incremental XOR off the carried hash."""
        zob = zobrist_tables.position_table(self.size)
        ci = 0 if color == BLACK else 1
        x, y = action
        h = self.zobrist_hash ^ zob[x * self.size + y, ci]
        for px, py in captured:
            h = h ^ zob[px * self.size + py, 1 - ci]
        return h

    def is_suicide(self, action) -> bool:
        if not self._on_board(action):
            return False
        try:
            self._simulate(action, self.current_player)
            return False
        except Suicide:
            return True
        except IllegalMove:
            return False

    def is_positional_superko(self, action) -> bool:
        """Would ``action`` recreate an earlier whole-board position?"""
        if not self._on_board(action):
            return False
        try:
            _, captured = self._simulate(action, self.current_player)
        except IllegalMove:
            return False
        h = self._hash_after(action, self.current_player, captured)
        return h.tobytes() in self._hash_history

    def is_legal(self, action) -> bool:
        if self.is_end_of_game:
            return False
        if action is PASS_MOVE:
            return True
        if not self._on_board(action):
            return False
        if self.board[action] != EMPTY:
            return False
        if self.ko is not None and action == self.ko:
            return False
        try:
            _, captured = self._simulate(action, self.current_player)
        except IllegalMove:
            return False
        if self.enforce_superko:
            h = self._hash_after(action, self.current_player, captured)
            if h.tobytes() in self._hash_history:
                return False
        return True

    # Eye heuristics follow the reference (``AlphaGo/go.py::is_eyeish`` /
    # ``is_eye``): eyeish = empty with all neighbors own; a true eye
    # additionally bounds opposing diagonals (1 allowed in the interior,
    # 0 on edge/corner).
    def is_eyeish(self, point, owner) -> bool:
        if self.board[point] != EMPTY:
            return False
        return all(self.board[n] == owner for n in self.get_neighbors(point))

    def is_eye(self, point, owner) -> bool:
        if not self.is_eyeish(point, owner):
            return False
        diagonals = self.get_diagonals(point)
        num_bad = sum(1 for d in diagonals if self.board[d] == -owner)
        num_off_board = 4 - len(diagonals)
        if num_off_board > 0:  # edge or corner point
            return num_bad == 0
        return num_bad <= 1

    def get_legal_moves(self, include_eyes: bool = True):
        moves = [(x, y) for x in range(self.size) for y in range(self.size)
                 if self.is_legal((x, y))]
        if not include_eyes:
            moves = [m for m in moves
                     if not self.is_eye(m, self.current_player)]
        return moves

    # --------------------------------------------------------------- playing

    def do_move(self, action, color=None):
        """Play ``action`` ((x, y) or PASS_MOVE) for ``color`` (default:
        current player). Returns True if the move ended the game."""
        color = self.current_player if color is None else color
        if self.is_end_of_game:
            raise IllegalMove("game is over")
        if action is PASS_MOVE:
            if color == BLACK:
                self.passes_black += 1
            else:
                self.passes_white += 1
            self.ko = None
            self.history.append(PASS_MOVE)
            self.turns_played += 1
            self.current_player = -color
            if (len(self.history) >= 2 and self.history[-2] is PASS_MOVE):
                self.is_end_of_game = True
            return self.is_end_of_game

        if not self._on_board(action) or self.board[action] != EMPTY:
            raise IllegalMove(f"illegal move {action}")
        if self.ko is not None and action == self.ko:
            raise IllegalMove(f"ko violation at {action}")
        board, captured = self._simulate(action, color)
        new_hash = self._hash_after(action, color, captured)
        if self.enforce_superko and new_hash.tobytes() in self._hash_history:
            raise IllegalMove(f"superko violation at {action}")

        # simple ko: single capture by a lone stone that itself has exactly
        # one liberty afterwards → that liberty (the captured point) is banned
        self.ko = None
        if len(captured) == 1:
            own_stones, own_libs = _group_on(board, action, self.size)
            if len(own_stones) == 1 and len(own_libs) == 1:
                self.ko = next(iter(captured))

        if color == BLACK:
            self.num_white_prisoners += len(captured)
        else:
            self.num_black_prisoners += len(captured)
        self.board = board
        for p in captured:
            self.stone_ages[p] = -1
        self.stone_ages[action] = self.turns_played
        self.turns_played += 1
        self.history.append(action)
        self.zobrist_hash = new_hash
        self._hash_history[new_hash.tobytes()] = None
        self.current_player = -color
        return False

    def place_handicaps(self, positions):
        """Place Black handicap stones before the game starts
        (reference: ``GameState.place_handicaps``)."""
        if self.turns_played > 0:
            raise IllegalMove("handicaps only before the first move")
        if not positions:
            return
        zob = zobrist_tables.position_table(self.size)
        for p in positions:
            if self.board[p] != EMPTY:
                raise IllegalMove(f"occupied handicap point {p}")
            self.board[p] = BLACK
            self.stone_ages[p] = 0
            self.handicaps.append(p)
            self.zobrist_hash = self.zobrist_hash ^ \
                zob[p[0] * self.size + p[1], 0]
        self._hash_history[self.zobrist_hash.tobytes()] = None
        self.current_player = WHITE

    # --------------------------------------------------------------- scoring

    def get_scores(self):
        """Area (Chinese) scores ``(black, white)``; white includes komi.

        Empty regions touching only one color count for that color;
        neutral (dame) regions touching both count for neither.
        """
        return score_board(self.board, self.komi)

    def get_winner(self):
        """BLACK, WHITE, or 0 for a drawn game (reference:
        ``GameState.get_winner``)."""
        black, white = self.get_scores()
        if black > white:
            return BLACK
        if white > black:
            return WHITE
        return 0

    def get_current_player(self):
        return self.current_player


def score_board(board: np.ndarray, komi: float):
    """Area (Chinese) scores ``(black, white + komi)`` of a raw board
    array (behind :meth:`GameState.get_scores`)."""
    board = np.asarray(board)
    size = board.shape[0]
    visited = np.zeros_like(board, dtype=bool)
    black = int(np.sum(board == BLACK))
    white = int(np.sum(board == WHITE))
    for x in range(size):
        for y in range(size):
            if board[x, y] != EMPTY or visited[x, y]:
                continue
            region, borders = [], set()
            frontier = [(x, y)]
            while frontier:
                p = frontier.pop()
                if visited[p]:
                    continue
                visited[p] = True
                region.append(p)
                px, py = p
                for nx, ny in ((px + 1, py), (px - 1, py),
                               (px, py + 1), (px, py - 1)):
                    if 0 <= nx < size and 0 <= ny < size:
                        if board[nx, ny] == EMPTY:
                            if not visited[nx, ny]:
                                frontier.append((nx, ny))
                        else:
                            borders.add(int(board[nx, ny]))
            if borders == {BLACK}:
                black += len(region)
            elif borders == {WHITE}:
                white += len(region)
    return float(black), float(white) + komi


def _group_on(board: np.ndarray, point, size: int):
    """(stones, liberties) of the group at ``point`` on an arbitrary board."""
    color = board[point]
    if color == EMPTY:
        return set(), set()
    stones, liberties = set(), set()
    frontier = [point]
    while frontier:
        p = frontier.pop()
        if p in stones:
            continue
        stones.add(p)
        x, y = p
        for dx, dy in _NEIGHBOR_OFFSETS:
            n = (x + dx, y + dy)
            if 0 <= n[0] < size and 0 <= n[1] < size:
                v = board[n]
                if v == color and n not in stones:
                    frontier.append(n)
                elif v == EMPTY:
                    liberties.add(n)
    return stones, liberties
