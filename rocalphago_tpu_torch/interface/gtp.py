"""GTP (Go Text Protocol) engine over stdin/stdout: the port of
``interface/gtp.py``.

Commands: the GTP 2 administrative set (``protocol_version name
version known_command list_commands quit``), setup (``boardsize
clear_board komi fixed_handicap place_free_handicap
set_free_handicap``), play (``play genmove undo``), time
(``time_settings time_left``), ``showboard final_score``, and the
operator probes ``rocalphago-health`` / ``rocalphago-stats`` (one-line
JSON). Before every genmove the engine hands the moving colour's budget
in seconds to the player's ``set_move_time`` (the search players turn
it into playouts or simulations).

Resilient serving (the default): a controller forfeits the game on a
``? error`` genmove reply, so the engine wraps the player in a
:class:`~rocalphago_tpu_torch.interface.resilient.ResilientPlayer` and
a failing search walks the degradation ladder (search → reduced
search → raw policy → host-rules fallback) until a legal vertex comes
out. The fault barriers ``genmove.pre_search`` /
``genmove.post_search`` / ``genmove.pre_apply``
(:mod:`rocalphago_tpu_torch.runtime.faults`) cover the engine's own
path; in resilient mode a fault there is counted and logged, never
echoed. ``--no-resilient`` (``resilient=False``) is the raw engine: a
player error is a ``? error`` reply.

Run it as::

    python -m rocalphago_tpu_torch.interface.gtp --policy spec.json
    python -m rocalphago_tpu_torch.interface.gtp --player device-mcts \
        --policy policy.json --value value.json [--playouts 100]

(``--player gumbel-mcts`` searches with the Gumbel root rule.) The
reference's AlphaGo player, host APV-MCTS with rollouts::

    python -m rocalphago_tpu_torch.interface.gtp --player mcts \
        --policy policy.json --value value.json --rollout rollout.json \
        [--device-rollout] [--lmbda 0.5] [--leaf-batch 8] [--symmetric]

The serve pool: the engine's game is one session of a
:class:`~rocalphago_tpu_torch.serve.sessions.ServePool` (the shared
batching evaluator, admission control, pool stats on the probes), or of
a :class:`~rocalphago_tpu_torch.multisize.MultiSizePool` whose
``boardsize`` re-routes the session::

    python -m rocalphago_tpu_torch.interface.gtp --serve \
        --policy policy.json --value value.json [--serve-slo-ms 2000] \
        [--serve-sizes 9,13,19] [--metrics serve.jsonl]

A network play gateway's client (:class:`GatewayBridge`): GTP on stdin
and stdout, every board change and genmove over the gateway's wire;
no model is loaded and no device touched::

    python -m rocalphago_tpu_torch.interface.gtp --connect HOST:PORT
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from rocalphago_tpu_torch.engine import pygo
from rocalphago_tpu_torch.obs import registry as obs_registry
from rocalphago_tpu_torch.obs import trace
from rocalphago_tpu_torch.runtime import faults

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
    ``get_move(state)``; a ``clear_board`` also clears the player's
    search state. ``resilient`` (default) serves every genmove through
    the degradation ladder; ``serve_pool`` / ``serve_session`` tie the
    engine to a serve pool (probes, ``komi`` and ``boardsize``
    re-routing)."""

    def __init__(self, player, name: str = "rocalphago-tpu-torch",
                 version: str = "0.1", metrics=None,
                 resilient: bool = True,
                 hang_timeout_s: float | None = None,
                 serve_pool=None, serve_session=None):
        from rocalphago_tpu_torch.interface.resilient import ResilientPlayer

        self.player = player
        self._metrics = metrics
        self._resilient = resilient
        self._hang_timeout_s = hang_timeout_s
        # multi-size serving: the engine owns its pool session handle
        # so that boardsize can re-route it to another size's pool
        self._serve_session = serve_session
        if not resilient:
            self._serve = None
        elif isinstance(player, ResilientPlayer):
            self._serve = player
            if metrics is not None and player.metrics is None:
                player.metrics = metrics
            if hang_timeout_s is not None and player.hang_timeout_s is None:
                player.hang_timeout_s = hang_timeout_s
        else:
            self._serve = ResilientPlayer(player, metrics=metrics,
                                          hang_timeout_s=hang_timeout_s)
        self.illegal_from_player = 0  # the engine's final-guard count
        # a serve-backed player's pool: explicit, else found off the
        # primary (SessionPlayer.pool)
        self._serve_pool = serve_pool
        self.name = name
        self.version = version
        self.size = self._player_board() or 19
        self.komi = 7.5
        self.state = pygo.GameState(size=self.size, komi=self.komi)
        self._undo_stack: list = []
        self._time_settings = None    # (main_s, byo_s, byo_stones)
        # color -> (seconds, stones, spent-at-report, genmoves-at-
        # report): the pair at the end ages a report that is not
        # repeated every move
        self._time_left: dict = {}
        self._time_spent: dict = {}   # color -> own genmove seconds
        self._genmoves: dict = {}     # color -> genmove count
        # the private extensions are dashed on the wire
        # (rocalphago-health); method names cannot be
        self._commands = sorted(
            m[4:].replace("rocalphago_", "rocalphago-", 1)
            for m in dir(self) if m.startswith("cmd_"))

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

    def _new_game(self, reason: str = "clear_board"):
        from rocalphago_tpu_torch.search.players import reset_player

        self.state = pygo.GameState(size=self.size, komi=self.komi)
        self._undo_stack.clear()
        self._time_left = {}          # a fresh game, fresh clocks
        self._time_spent = {}
        self._genmoves = {}
        # the reason labels the player's encode-cache reset
        # (encode_cache_resets_total{reason=})
        reset_player(self.player, reason=reason)

    def _player_board(self):
        """The board the player's nets were built for (None when the
        player is size-agnostic)."""
        from rocalphago_tpu_torch.search.players import player_board

        return player_board(self.player)

    def cmd_boardsize(self, args):
        size = int(args[0])
        if not 2 <= size <= 25:
            raise ValueError("unacceptable size")
        # the net is built for one board; say so per GTP instead of
        # failing inside genmove. A multi-size serve pool re-routes
        # the session to the size's member pool instead
        net_board = self._player_board()
        if net_board is not None and size != net_board \
                and not self._reroute_board(size):
            raise ValueError("unacceptable size")
        self.size = size
        self._new_game(reason="boardsize")
        return ""

    def _reroute_board(self, size: int) -> bool:
        """Move this engine's serve session to ``size``'s member pool
        (multi-size pools only); the engine's komi goes with it."""
        from rocalphago_tpu_torch.interface.resilient import ResilientPlayer

        pool = self._serve_pool
        if pool is None or not hasattr(pool, "pool_for"):
            return False
        try:
            new = pool.open_session(size=size, resilient=self._resilient)
        except KeyError:
            return False            # the size is not active on the pool
        if self._serve_session is not None:
            self._serve_session.close()
        self._serve_session = new
        new.set_komi(self.komi)
        self.player = new.player
        if isinstance(new.player, ResilientPlayer):
            self._serve = new.player
            if self._metrics is not None and new.player.metrics is None:
                new.player.metrics = self._metrics
            if self._hang_timeout_s is not None \
                    and new.player.hang_timeout_s is None:
                new.player.hang_timeout_s = self._hang_timeout_s
        return True

    def cmd_clear_board(self, args):
        self._new_game()
        return ""

    def cmd_komi(self, args):
        self.komi = float(args[0])
        self.state.komi = self.komi
        # a serve-backed engine re-threads the session's komi too, so
        # the shared evaluator scores terminal leaves under it
        primary = self._primary_player()
        if getattr(primary, "pool", None) is not None \
                and hasattr(primary, "komi"):
            primary.komi = self.komi
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

    def _serving_barrier(self, name: str) -> None:
        """A fault barrier on the genmove path: in resilient mode a
        fault here is counted and logged (the move still goes out); the
        raw engine lets it raise like any command error."""
        try:
            faults.barrier(name, iteration=self.state.turns_played)
        except Exception as e:  # noqa: BLE001 -- injected by design
            if self._serve is None:
                raise
            self._serve.note_barrier_fault(name, e)

    def _generate(self, color):
        """One move off the player. Resilient mode always has an answer
        (the ladder bottoms out at pass); the raw engine lets a player
        error through (a ``? error`` reply)."""
        try:
            # a raising time hook must not take the move down with it
            set_time = getattr(self.player, "set_move_time", None)
            if set_time is not None:
                set_time(self._move_budget_s(color))
        except Exception as e:  # noqa: BLE001
            if self._serve is None:
                raise
            self._serve.note_barrier_fault("genmove.set_move_time", e)
        self._serving_barrier("genmove.pre_search")
        if self._serve is not None:
            move = self._serve.get_move(self.state)
        else:
            move = self.player.get_move(self.state)
        self._serving_barrier("genmove.post_search")
        if move is not None and not self.state.is_legal(move):
            # the final guard (the ladder checks before this in
            # resilient mode): count it, log it, then pass
            self.illegal_from_player += 1
            if self._metrics is not None:
                self._metrics.log(
                    "degradation", rung="engine",
                    reason="illegal_from_player",
                    turn=self.state.turns_played, move=str(move))
            move = None
        return move

    def cmd_genmove(self, args):
        color = parse_color(args[0])
        prev = self.state.current_player
        self.state.current_player = color
        t0 = time.monotonic()
        try:
            # the span names this phase in watchdog stall events; the
            # histogram backs the stats probe's latency section
            with trace.span("gtp.genmove", turn=self.state.turns_played):
                move = self._generate(color)
                self._serving_barrier("genmove.pre_apply")
                self._apply_move(move, color)
        except Exception:
            self.state.current_player = prev
            raise
        finally:
            dt = time.monotonic() - t0
            self._time_spent[color] = self._time_spent.get(color, 0.0) + dt
            self._genmoves[color] = self._genmoves.get(color, 0) + 1
            obs_registry.histogram("gtp_genmove_seconds").observe(dt)
        return move_to_vertex(move, self.size)

    def cmd_undo(self, args):
        if not self._undo_stack:
            raise ValueError("cannot undo")
        self.state = self._undo_stack.pop()
        self.state.komi = self.komi
        # no player reset: the device player's subtree walk sees the
        # history go back and builds a fresh tree on its own
        return ""

    # ----------------------------------------------- operator probes
    #
    # Private extensions (the ``rocalphago-`` prefix keeps them out of
    # controllers' way): one-line JSON, so that an operator or a load
    # balancer can probe a live engine over its GTP pipe.

    def _primary_player(self):
        return self._serve.primary if self._serve is not None \
            else self.player

    def _pool(self):
        """The serve pool behind this engine's player, if any."""
        if self._serve_pool is not None:
            return self._serve_pool
        return getattr(self._primary_player(), "pool", None)

    def cmd_rocalphago_health(self, args):
        """Ladder health: counts per rung, p50/p99 genmove latency, the
        last fallback's reason, the simulations run; a serve-backed
        engine adds the pool block (live sessions, queue depth, batch
        occupancy, sheds)."""
        if self._serve is None:
            raise ValueError("resilient serving disabled")
        s = self._serve.stats()
        s["illegal_from_player"] += self.illegal_from_player
        s["status"] = ("ok" if s["last_rung"] in (None, "search")
                       else "degraded")
        primary = self._primary_player()
        s["sims"] = {"last": getattr(primary, "last_n_sim", None),
                     "nominal": getattr(primary, "n_sim", None)}
        s["deadline"] = {
            "hits": getattr(primary, "deadline_hits", 0),
            "last_hit": bool(getattr(primary, "last_deadline_hit", False))}
        pool = self._pool()
        if pool is not None:
            s["serve"] = pool.stats()
        return json.dumps(s, sort_keys=True)

    def cmd_rocalphago_stats(self, args):
        """Operational snapshot: game, clock and search state plus the
        full ladder stats (a superset of ``rocalphago-health``) and the
        live metric registry."""
        primary = self._primary_player()
        clock = getattr(primary, "_clock", None)

        def per_color(d, r=None):
            return {"black": (round(d.get(pygo.BLACK, 0), 3)
                              if r else d.get(pygo.BLACK, 0)),
                    "white": (round(d.get(pygo.WHITE, 0), 3)
                              if r else d.get(pygo.WHITE, 0))}

        pool = self._pool()
        out = {
            "name": self.name,
            "version": self.version,
            "game": {
                "size": self.size,
                "komi": self.komi,
                "turns": self.state.turns_played,
                "to_move": ("black" if self.state.current_player
                            == pygo.BLACK else "white"),
                "over": bool(self.state.is_end_of_game),
            },
            "genmoves": per_color(self._genmoves),
            "time_spent_s": per_color(self._time_spent, r=True),
            "clock": {
                "settings": (list(self._time_settings)
                             if self._time_settings else None),
                "move_time_s": getattr(clock, "move_time", None),
                "rate_units_per_s": getattr(clock, "rate", None),
            },
            "search": {
                "last_n_sim": getattr(primary, "last_n_sim", None),
                "nominal_n_sim": getattr(primary, "n_sim", None),
                "reuses": getattr(primary, "reuses", None),
                "deadline_hits": getattr(primary, "deadline_hits", None),
                "last_deadline_hit": getattr(primary, "last_deadline_hit",
                                             None),
            },
            "ladder": (self._serve.stats()
                       if self._serve is not None else None),
            "serve": pool.stats() if pool is not None else None,
            "registry": obs_registry.snapshot(),
        }
        return json.dumps(out, sort_keys=True)

    # ------------------------------------------------------------- time

    def cmd_time_settings(self, args):
        # GTP 2: main_time byo_yomi_time byo_yomi_stones (canadian)
        main, byo_t, byo_s = (float(args[0]), float(args[1]),
                              int(args[2]))
        if main < 0 or byo_t < 0 or byo_s < 0:
            raise ValueError("time arguments must be non-negative")
        self._time_settings = (main, byo_t, byo_s)
        self._time_left = {}
        self._time_spent = {}         # a re-issued clock starts fresh
        self._genmoves = {}
        return ""

    def cmd_time_left(self, args):
        color = parse_color(args[0])
        # snapshot our own spend and move counters so that the report
        # ages: one report must not freeze the budget for the game
        self._time_left[color] = (
            float(args[1]), int(args[2]),
            self._time_spent.get(color, 0.0),
            self._genmoves.get(color, 0))
        return ""

    def _est_moves_left(self) -> float:
        """Moves each player still has to make: a game runs ~0.75·N²
        plies, floored so that late budgets never spike."""
        total = 0.75 * self.size * self.size
        return max(10.0, (total - self.state.turns_played) / 2.0)

    def _move_budget_s(self, color):
        """Seconds this genmove may spend, or None (no time control).

        In byo-yomi (``time_left`` with stones > 0) the period's time
        left splits evenly over its stones left; in main time the clock
        left splits over the estimated moves left. A report is aged by
        the engine's own spend since it came. Idempotent per position:
        the byo-yomi rebase rewrites the ledger from the report, so
        repeated queries agree."""
        settings = self._time_settings
        left = self._time_left.get(color)
        if left is not None:
            t, stones, spent0, moves0 = left
            rem = min(t, t - (self._time_spent.get(color, 0.0) - spent0))
            if stones > 0:                     # canadian byo-yomi
                made = self._genmoves.get(color, 0) - moves0
                if rem > 0 and made < stones:
                    return rem / (stones - made)
                if rem > 0 and made >= stones:
                    # every reported stone went down with time to spare:
                    # a new period began; rebase the report to it
                    if settings is not None and settings[2] > 0:
                        byo_t, byo_s = settings[1], settings[2]
                        self._time_left[color] = (
                            byo_t, byo_s, spent0 + t, moves0 + stones)
                        return self._move_budget_s(color)
                # the period's time is gone with stones owed: minimum
                # budget until the controller reports again
                return 0.0
            if rem > 0:
                return rem / self._est_moves_left()
            if settings is not None and settings[2] > 0:
                return settings[1] / settings[2]
            return 0.0
        if settings is not None:
            main, byo_t, byo_s = settings
            if main > 0:
                # no report: the engine runs its own clock down
                rem = main - self._time_spent.get(color, 0.0)
                if rem > 0:
                    return rem / self._est_moves_left()
                if byo_s > 0:
                    return byo_t / byo_s
                return 0.0
            if byo_s > 0:
                return byo_t / byo_s
        return None

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
        # the private extensions are dashed on the wire
        lookup = (cmd.replace("-", "_") if cmd.startswith("rocalphago-")
                  else cmd)
        fn = getattr(self, f"cmd_{lookup}", None)
        if fn is None:
            return f"?{cmd_id} unknown command\n\n", False
        try:
            result = fn(args)
        except Exception as e:  # noqa: BLE001 — GTP reports all errors
            return f"?{cmd_id} {e}\n\n", False
        sep = " " if result else ""
        return f"={cmd_id}{sep}{result}\n\n", cmd == "quit"


def run_gtp(player, instream=None, outstream=None, **engine_kwargs):
    """Blocking GTP loop; returns the engine (``engine_kwargs`` go to
    :class:`GTPEngine`)."""
    instream = instream or sys.stdin
    outstream = outstream or sys.stdout
    engine = GTPEngine(player, **engine_kwargs)
    for line in instream:
        reply, done = engine.handle(line)
        if reply is not None:
            outstream.write(reply)
            outstream.flush()
        if done:
            break
    return engine


class GatewayBridge:
    """GTP front end over a network gateway.

    ``gtp.py --connect host:port`` speaks stdin/stdout GTP to the
    controller while every board mutation and genmove goes over the
    gateway's NDJSON wire. The process loads no model and touches no
    device: it computes nothing, so this is not a CPU fallback of the
    engine but a client, and a GoGui on a machine with no card can
    drive a pool on a card's host.

    Refusals stay structured end to end: a gateway shed
    (``overload``/``draining``) surfaces as a clean GTP error with
    the server's retry hint (``? gateway overload, retry in 1.0s``)
    instead of a hang or a dead pipe; a dropped connection ends the
    session (the controller sees the error and the loop stops, like
    ``quit``).
    """

    def __init__(self, client, name: str = "rocalphago-gateway",
                 version: str = "0.1"):
        self.client = client
        self.name = name
        self.version = version
        self._board = int(client.default_board)
        self._komi = None
        self._open = False

    # ------------------------------------------------------- commands

    def _ensure_game(self) -> None:
        if not self._open:
            self.client.new_game(board=self._board, komi=self._komi)
            self._open = True

    def cmd_protocol_version(self, args):
        return "2"

    def cmd_name(self, args):
        return self.name

    def cmd_version(self, args):
        return self.version

    def cmd_known_command(self, args):
        known = args and hasattr(self, f"cmd_{args[0]}")
        return "true" if known else "false"

    def cmd_list_commands(self, args):
        return "\n".join(sorted(
            m[len("cmd_"):] for m in dir(self)
            if m.startswith("cmd_")))

    def cmd_boardsize(self, args):
        size = int(args[0])
        if size not in self.client.boards:
            raise ValueError("unacceptable size")
        self._board = size
        self._open = False
        return ""

    def cmd_clear_board(self, args):
        self._open = False
        self._ensure_game()
        return ""

    def cmd_komi(self, args):
        self._komi = float(args[0])
        if self._open:
            self.client.set_komi(self._komi)
        return ""

    def cmd_play(self, args):
        self._ensure_game()
        self.client.play(args[0], args[1])
        return ""

    def cmd_genmove(self, args):
        self._ensure_game()
        return self.client.genmove(args[0])["move"]

    def cmd_quit(self, args):
        self.client.close()
        return ""

    # ------------------------------------------------------- dispatch

    def handle(self, line: str):
        """One GTP line → (reply string or None, done) -- the same
        contract as :meth:`GTPEngine.handle`."""
        from rocalphago_tpu_torch.gateway.client import (
            GatewayClosed,
            GatewayRefused,
        )

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
        except GatewayRefused as e:
            retry = ("" if e.retry_after_s is None
                     else f", retry in {e.retry_after_s}s")
            return f"?{cmd_id} gateway {e.code}{retry}\n\n", False
        except GatewayClosed as e:
            # the wire is gone: report once and end the session
            return f"?{cmd_id} gateway connection lost: {e}\n\n", True
        except Exception as e:  # noqa: BLE001 -- GTP reports all errors
            return f"?{cmd_id} {e}\n\n", False
        sep = " " if result else ""
        return f"={cmd_id}{sep}{result}\n\n", cmd == "quit"


def run_bridge(bridge, instream=None, outstream=None):
    """Blocking GTP loop over a :class:`GatewayBridge` (the
    ``--connect`` path of :func:`main`)."""
    instream = instream or sys.stdin
    outstream = outstream or sys.stdout
    for line in instream:
        reply, done = bridge.handle(line)
        if reply is not None:
            outstream.write(reply)
            outstream.flush()
        if done:
            break
    return bridge


def make_player(args):
    """Build the requested agent from saved model specs (on
    ``args.device``: the card unless it names another device)."""
    from rocalphago_tpu_torch.search.players import build_player

    try:
        return build_player(
            args.player, args.policy, value_path=args.value,
            rollout_path=args.rollout, temperature=args.temperature,
            playouts=args.playouts, leaf_batch=args.leaf_batch,
            lmbda=args.lmbda, symmetric=args.symmetric,
            device_rollout=args.device_rollout, device=args.device)
    except ValueError as e:
        raise SystemExit(str(e))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="GTP engine over the PyTorch port's players")
    ap.add_argument("--policy",
                    help="policy model JSON spec (the reference's format; "
                         "required unless --connect)")
    ap.add_argument("--connect", metavar="HOST:PORT", default=None,
                    help="bridge GTP to a network play gateway instead of "
                         "loading models: no model, no device; a gateway "
                         "shed is a clean GTP error with the retry hint")
    ap.add_argument("--value", help="value model JSON spec (mcts, "
                    "device-mcts, gumbel-mcts, --serve)")
    ap.add_argument("--rollout", help="rollout model JSON spec (mcts; "
                    "default: the policy rolls out)")
    ap.add_argument("--player", default="greedy",
                    choices=("greedy", "probabilistic", "mcts",
                             "device-mcts", "gumbel-mcts"))
    ap.add_argument("--temperature", type=float, default=0.1)
    ap.add_argument("--lmbda", type=float, default=0.5,
                    help="mcts leaf value mix: (1 - λ)·value + λ·rollout")
    ap.add_argument("--playouts", type=int, default=100,
                    help="playouts (simulations) per move (mcts, "
                         "device-mcts, gumbel-mcts, --serve)")
    ap.add_argument("--leaf-batch", type=int, default=8,
                    help="mcts playouts per leaf wave")
    ap.add_argument("--symmetric", action="store_true",
                    help="ensemble evaluations over the 8 board "
                         "symmetries (greedy, probabilistic, mcts)")
    ap.add_argument("--device-rollout", action="store_true",
                    help="mcts rollouts wholly on the device, one run a "
                         "wave, instead of on host rules")
    ap.add_argument("--metrics", default=None,
                    help="JSONL path for degradation, stall and span "
                         "events (the serving metrics.jsonl)")
    ap.add_argument("--genmove-timeout", type=float, default=None,
                    help="abandon a silent search after this many "
                         "seconds and go on to the policy rung (the "
                         "watchdog's hang protection; default off)")
    ap.add_argument("--no-resilient", action="store_true",
                    help="the raw engine: a player error is a ? error "
                         "reply (a forfeit under most controllers)")
    ap.add_argument("--serve", action="store_true",
                    help="serve-backed player: this engine's game is one "
                         "session of a serve pool (the shared batching "
                         "evaluator, admission control, pool stats on the "
                         "probes); needs --value")
    ap.add_argument("--serve-slo-ms", type=float, default=None,
                    help="per-genmove SLO of the serve pool in ms (the "
                         "anytime answer on expiry; default off)")
    ap.add_argument("--serve-sizes", default=None,
                    help="comma list of board sizes served from one "
                         "multi-size pool (e.g. 9,13,19; implies --serve "
                         "and needs FCN heads): boardsize then re-routes "
                         "the session")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run on "
                         "the CPU)")
    a = ap.parse_args(argv)
    if a.connect:
        # the bridge path: no models, no device, just the wire. The
        # resilient client rides out drains and sheds (reconnect and
        # replay, backoff honoring retry_after_s)
        from rocalphago_tpu_torch.gateway.client import (
            GatewayRefused,
            ResilientGatewayClient,
        )

        host, _, port = a.connect.rpartition(":")
        if not host or not port.isdigit():
            ap.error("--connect wants HOST:PORT")
        try:
            client = ResilientGatewayClient(host, int(port))
        except GatewayRefused as e:
            retry = ("" if e.retry_after_s is None
                     else f" (retry in {e.retry_after_s}s)")
            raise SystemExit(f"gateway refused: {e}{retry}")
        except OSError as e:
            raise SystemExit(f"cannot reach gateway {a.connect}: {e}")
        try:
            run_bridge(GatewayBridge(client))
        finally:
            client.close()
        return
    if not a.policy:
        ap.error("--policy is required (unless --connect)")
    metrics = None
    if a.metrics:
        from rocalphago_tpu_torch.io.metrics import MetricsLogger

        metrics = MetricsLogger(a.metrics, echo=False)
        # genmove and rung spans join the serving metrics
        trace.configure(metrics)
    pool = session = None
    if a.serve or a.serve_sizes:
        from rocalphago_tpu_torch.models.nn_util import NeuralNetBase

        if not a.value:
            raise SystemExit("--serve needs a --value model")
        policy = NeuralNetBase.load_model(a.policy, device=a.device)
        value = NeuralNetBase.load_model(a.value, device=a.device)
        slo_s = a.serve_slo_ms / 1e3 if a.serve_slo_ms is not None else None
        kwargs = dict(n_sim=a.playouts, metrics=metrics,
                      hang_timeout_s=a.genmove_timeout, slo_s=slo_s)
        if a.serve_sizes:
            from rocalphago_tpu_torch.multisize import MultiSizePool

            sizes = tuple(int(s) for s in a.serve_sizes.split(",")
                          if s.strip())
            try:
                pool = MultiSizePool(value, policy, sizes=sizes, **kwargs)
            except ValueError as e:
                raise SystemExit(str(e))
        else:
            from rocalphago_tpu_torch.serve.sessions import ServePool

            pool = ServePool(value, policy, **kwargs)
        pool.warm()
        # the session arrives ladder-wrapped; the engine adopts it
        session = pool.open_session(resilient=not a.no_resilient)
        player = session.player
    else:
        player = make_player(a)
    try:
        run_gtp(player, metrics=metrics, resilient=not a.no_resilient,
                hang_timeout_s=a.genmove_timeout, serve_pool=pool,
                serve_session=session)
    finally:
        if pool is not None:
            pool.close()
        # the end-of-session registry snapshot, as the trainers write it
        obs_registry.log_to(metrics)
        if metrics is not None:
            trace.configure(None)
            metrics.close()


if __name__ == "__main__":
    main(sys.argv[1:])
