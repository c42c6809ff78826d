"""GTP (Go Text Protocol) engine over stdin/stdout: the port of
``interface/gtp.py``.

Commands: the GTP 2 administrative set (``protocol_version name
version known_command list_commands quit``), setup (``boardsize
clear_board komi fixed_handicap place_free_handicap
set_free_handicap``), play (``play genmove undo``) and ``showboard
final_score``. The reference's resilience ladder, time commands,
operator probes and serve pool are not ported yet, so this engine
behaves like the reference under ``--no-resilient``: a player error
is a ``? error`` reply, never a silent fallback move.

Run it as::

    python -m rocalphago_tpu_torch.interface.gtp --policy spec.json
"""

from __future__ import annotations

import argparse
import sys

from rocalphago_tpu_torch.engine import pygo

COLS = "ABCDEFGHJKLMNOPQRSTUVWXYZ"  # GTP skips I


def fixed_handicap_points(size: int, n: int) -> list:
    """GTP 2 fixed_handicap layouts on the star points: corners for
    2–4; center joins only at odd counts (5, 7, 9); 6 adds the left
    and right mid-sides, 8 all four mid-sides."""
    if size < 7 or size % 2 == 0:
        raise ValueError("board has no fixed handicap layout")
    edge = 2 if size < 13 else 3
    lo, hi, mid = edge, size - 1 - edge, size // 2
    corners = [(hi, hi), (lo, lo), (lo, hi), (hi, lo)]
    sides_lr = [(lo, mid), (hi, mid)]
    sides_tb = [(mid, lo), (mid, hi)]
    center = (mid, mid)
    layouts = {
        2: corners[:2], 3: corners[:3], 4: corners,
        5: corners + [center],
        6: corners + sides_lr,
        7: corners + sides_lr + [center],
        8: corners + sides_lr + sides_tb,
        9: corners + sides_lr + sides_tb + [center],
    }
    if n not in layouts:
        raise ValueError("invalid number of stones")
    return layouts[n]


def free_handicap_points(size: int, n: int) -> list:
    """Up to ``n`` engine-chosen handicap vertices: star points first,
    then a deterministic spread over the remaining third-line points."""
    try:
        pts = list(fixed_handicap_points(size, min(n, 9)))
    except ValueError:
        pts = []
    if len(pts) >= n:
        return pts[:n]
    edge = 2 if size < 13 else 3
    lo, hi = edge, size - 1 - edge
    seen = set(pts)
    for x in range(lo, hi + 1, 2):
        for y in range(lo, hi + 1, 2):
            if len(pts) >= n:
                return pts
            if (x, y) not in seen:
                pts.append((x, y))
                seen.add((x, y))
    return pts


def move_to_vertex(move, size: int) -> str:
    """(x, y) board move (or None) → GTP vertex; ``x`` is the column
    (A..T skipping I), ``y`` the row (1-based)."""
    if move is None:
        return "pass"
    x, y = move
    return f"{COLS[int(x)]}{int(y) + 1}"


def vertex_to_move(vertex: str, size: int):
    """GTP vertex → (x, y) or None for pass. Raises ValueError."""
    v = vertex.strip().upper()
    if v == "PASS":
        return None
    if v == "RESIGN":
        raise ValueError("resign is not a board vertex")
    x = COLS.index(v[0])
    y = int(v[1:]) - 1
    if not (0 <= x < size and 0 <= y < size):
        raise ValueError(f"vertex {vertex!r} off the {size}x{size} board")
    return (x, y)


def parse_color(s: str) -> int:
    c = s.strip().lower()
    if c in ("b", "black"):
        return pygo.BLACK
    if c in ("w", "white"):
        return pygo.WHITE
    raise ValueError(f"invalid color {s!r}")


class GTPEngine:
    """Stateful GTP command dispatcher around a player with
    ``get_move(state)``."""

    name = "rocalphago-tpu-torch"
    version = "0.1"

    def __init__(self, player):
        from rocalphago_tpu_torch.search.players import player_board

        self.player = player
        self.illegal_from_player = 0
        self.size = player_board(player) or 19
        self.komi = 7.5
        self.state = pygo.GameState(size=self.size, komi=self.komi)
        self._undo_stack: list = []
        self._commands = sorted(m[4:] for m in dir(self)
                                if m.startswith("cmd_"))

    # ------------------------------------------------------------ admin

    def cmd_protocol_version(self, args):
        return "2"

    def cmd_name(self, args):
        return self.name

    def cmd_version(self, args):
        return self.version

    def cmd_known_command(self, args):
        return "true" if args and args[0] in self._commands else "false"

    def cmd_list_commands(self, args):
        return "\n".join(self._commands)

    def cmd_quit(self, args):
        return ""

    # ------------------------------------------------------------ setup

    def _new_game(self):
        self.state = pygo.GameState(size=self.size, komi=self.komi)
        self._undo_stack.clear()

    def cmd_boardsize(self, args):
        from rocalphago_tpu_torch.search.players import player_board

        size = int(args[0])
        if not 2 <= size <= 25:
            raise ValueError("unacceptable size")
        # the net is built for one board; say so per GTP instead of
        # failing inside genmove
        net_board = player_board(self.player)
        if net_board is not None and size != net_board:
            raise ValueError("unacceptable size")
        self.size = size
        self._new_game()
        return ""

    def cmd_clear_board(self, args):
        self._new_game()
        return ""

    def cmd_komi(self, args):
        self.komi = float(args[0])
        self.state.komi = self.komi
        return ""

    def cmd_fixed_handicap(self, args):
        pts = fixed_handicap_points(self.size, int(args[0]))
        self.state.place_handicaps(pts)
        return " ".join(move_to_vertex(p, self.size) for p in pts)

    def cmd_place_free_handicap(self, args):
        n = int(args[0])
        if n < 2:
            raise ValueError("invalid number of stones")
        pts = free_handicap_points(self.size, n)
        self.state.place_handicaps(pts)
        return " ".join(move_to_vertex(p, self.size) for p in pts)

    def cmd_set_free_handicap(self, args):
        pts = [vertex_to_move(v, self.size) for v in args]
        if None in pts:
            raise ValueError("pass is not a handicap vertex")
        self.state.place_handicaps(pts)
        return ""

    # ------------------------------------------------------------- play

    def _apply_move(self, move, color) -> None:
        """Snapshot + play; a rejected move leaves the undo stack
        untouched."""
        snapshot = self.state.copy()
        self.state.do_move(move, color)
        self._undo_stack.append(snapshot)

    def cmd_play(self, args):
        color = parse_color(args[0])
        move = vertex_to_move(args[1], self.size)
        prev = self.state.current_player
        self.state.current_player = color
        try:
            if move is not None and not self.state.is_legal(move):
                raise ValueError("illegal move")
            self._apply_move(move, color)
        except Exception:
            # a rejected command leaves the side to move untouched
            self.state.current_player = prev
            raise
        return ""

    def _generate(self):
        move = self.player.get_move(self.state)
        if move is not None and not self.state.is_legal(move):
            # final guard: count it, then pass
            self.illegal_from_player += 1
            move = None
        return move

    def cmd_genmove(self, args):
        color = parse_color(args[0])
        prev = self.state.current_player
        self.state.current_player = color
        try:
            move = self._generate()
            self._apply_move(move, color)
        except Exception:
            self.state.current_player = prev
            raise
        return move_to_vertex(move, self.size)

    def cmd_undo(self, args):
        if not self._undo_stack:
            raise ValueError("cannot undo")
        self.state = self._undo_stack.pop()
        self.state.komi = self.komi
        return ""

    # ------------------------------------------------------ observation

    def cmd_showboard(self, args):
        s = self.state
        rows = []
        for y in reversed(range(s.size)):
            cells = []
            for x in range(s.size):
                v = s.board[x, y]
                cells.append("X" if v == pygo.BLACK
                             else "O" if v == pygo.WHITE else ".")
            rows.append(f"{y + 1:2d} " + " ".join(cells))
        rows.append("   " + " ".join(COLS[:s.size]))
        return "\n" + "\n".join(rows)

    def cmd_final_score(self, args):
        black, white = self.state.get_scores()
        if black > white:
            return f"B+{black - white:g}"
        if white > black:
            return f"W+{white - black:g}"
        return "0"

    # --------------------------------------------------------- dispatch

    def handle(self, line: str):
        """One GTP line → ``(reply or None, done)``."""
        line = line.split("#", 1)[0].strip()
        if not line:
            return None, False
        parts = line.split()
        cmd_id = ""
        if parts[0].isdigit():
            cmd_id = parts[0]
            parts = parts[1:]
        if not parts:
            return None, False
        cmd, args = parts[0], parts[1:]
        fn = getattr(self, f"cmd_{cmd}", None)
        if fn is None:
            return f"?{cmd_id} unknown command\n\n", False
        try:
            result = fn(args)
        except Exception as e:  # noqa: BLE001 — GTP reports all errors
            return f"?{cmd_id} {e}\n\n", False
        sep = " " if result else ""
        return f"={cmd_id}{sep}{result}\n\n", cmd == "quit"


def run_gtp(player, instream=None, outstream=None):
    """Blocking GTP loop; returns the engine."""
    instream = instream or sys.stdin
    outstream = outstream or sys.stdout
    engine = GTPEngine(player)
    for line in instream:
        reply, done = engine.handle(line)
        if reply is not None:
            outstream.write(reply)
            outstream.flush()
        if done:
            break
    return engine


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="GTP engine over the PyTorch port's policy players")
    ap.add_argument("--policy", required=True,
                    help="policy model JSON spec (the reference's format)")
    ap.add_argument("--player", default="greedy",
                    choices=("greedy", "probabilistic"))
    ap.add_argument("--temperature", type=float, default=0.1)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run on "
                         "the CPU)")
    a = ap.parse_args(argv)
    from rocalphago_tpu_torch.search.players import build_player

    try:
        player = build_player(a.player, a.policy,
                              temperature=a.temperature, device=a.device)
    except ValueError as e:
        raise SystemExit(str(e))
    run_gtp(player)


if __name__ == "__main__":
    main(sys.argv[1:])
