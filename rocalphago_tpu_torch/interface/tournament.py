"""Head-to-head evaluation: the port of ``interface/tournament.py``.

Two configured agents play each other, colours alternating per game;
results stream to stderr, the tally to stdout as JSON and every game to
an optional JSONL log that :mod:`rocalphago_tpu_torch.interface.elo`
reads::

    python -m rocalphago_tpu_torch.interface.tournament \\
        gumbel-mcts:policy.json:value.json device-mcts:policy.json:value.json \\
        --games 20 --board 9 --playouts 100 --log games.jsonl [--device cpu]

A player is ``kind:policy.json[:value.json[:rollout.json]]`` with the
kinds of :func:`~rocalphago_tpu_torch.search.players.build_player` (the
rollout net for ``mcts``; ``--device-rollout`` plays its rollouts on
the device). The players run on the card unless ``--device`` names
another device.
"""

from __future__ import annotations

import argparse
import json
import sys

from rocalphago_tpu_torch.engine import pygo


class GameCrash(Exception):
    """A player failed mid-game (a raising ``get_move`` or a move the
    rules reject). Carries the side that crashed, so the tournament can
    score the forfeit and play on."""

    def __init__(self, color: int, cause: BaseException):
        self.color = color
        self.cause = cause
        side = "black" if color == pygo.BLACK else "white"
        super().__init__(
            f"{side} crashed: {type(cause).__name__}: {cause}")


def play_match(black, white, size: int = 19, komi: float = 7.5,
               move_limit: int = 722, handicap: int = 0):
    """One game; returns +1 (black win), -1 (white win), 0 (draw).

    ``handicap`` places that many Black stones on the GTP fixed star
    points before play (White moves first). A raising player, or one
    whose move the rules reject, aborts the game with
    :class:`GameCrash` naming the side."""
    from rocalphago_tpu_torch.interface.gtp import fixed_handicap_points
    from rocalphago_tpu_torch.search.players import reset_player

    state = pygo.GameState(size=size, komi=komi)
    if handicap:
        state.place_handicaps(fixed_handicap_points(size, handicap))
    players = {pygo.BLACK: black, pygo.WHITE: white}
    for player in players.values():
        reset_player(player)
    while not state.is_end_of_game and state.turns_played < move_limit:
        mover = state.current_player
        try:
            move = players[mover].get_move(state)
            state.do_move(move)
        except Exception as e:  # noqa: BLE001 — scored as a forfeit
            raise GameCrash(mover, e) from e
    return state.get_winner()


def run_tournament(player_a, player_b, games: int, size: int = 19,
                   komi: float = 7.5, move_limit: int = 722,
                   log=None, names=("A", "B"),
                   handicap: int = 0) -> dict:
    """``games`` games, colours alternating; returns the tally.

    The tally is kept by player index and mapped to ``names`` only for
    display (two distinct labels, neither ``draw``). A game a player
    crashes out of (:class:`GameCrash`) is a forfeit: the crashing side
    loses, the log entry records it, and the tournament plays on.
    Win rates are over decided games; draws are counted apart."""
    if len(set(names)) != 2 or "draw" in names:
        raise ValueError(
            f"names must be two distinct labels, neither 'draw'; "
            f"got {names!r}")
    tally = [0, 0, 0]                 # wins A, wins B, draws
    forfeits = [0, 0]                 # games A / B crashed out of
    for g in range(games):
        a_is_black = g % 2 == 0
        black, white = (player_a, player_b) if a_is_black \
            else (player_b, player_a)
        black_name, white_name = (names if a_is_black
                                  else names[::-1])
        forfeit = None
        try:
            w = play_match(black, white, size=size, komi=komi,
                           move_limit=move_limit, handicap=handicap)
        except GameCrash as e:
            w = -e.color              # the crashing side forfeits
            forfeit = {"side": ("black" if e.color == pygo.BLACK
                                else "white"),
                       "error": f"{type(e.cause).__name__}: "
                                f"{e.cause}"}
        idx = 2 if w == 0 else (0 if (w == pygo.BLACK) == a_is_black
                                else 1)
        tally[idx] += 1
        if forfeit is not None:
            forfeits[1 - idx] += 1    # idx is the winner; the loser crashed
        winner = "draw" if idx == 2 else names[idx]
        entry = {"game": g, "black": black_name, "white": white_name,
                 "winner": winner}
        if forfeit is not None:
            entry["forfeit"] = forfeit
        if log:
            log.write(json.dumps(entry) + "\n")
            log.flush()
        note = (f" (forfeit by {forfeit['side']}: {forfeit['error']})"
                if forfeit else "")
        print(f"game {g}: {black_name}(B) vs {white_name}(W) -> "
              f"{winner}{note}", file=sys.stderr)
    decided = max(tally[0] + tally[1], 1)
    return {"games": games,
            "wins": {names[0]: tally[0], names[1]: tally[1],
                     "draw": tally[2]},
            "forfeits": {names[0]: forfeits[0],
                         names[1]: forfeits[1]},
            "win_rate_a": tally[0] / decided,
            "win_rate_b": tally[1] / decided}


def _build_player(spec: str, temperature: float, playouts: int,
                  board: int, device=None, device_rollout: bool = False):
    """``kind:policy.json[:value.json[:rollout.json]]`` → agent at
    ``board``: nets saved at another size re-board through ``at_board``
    when their heads are FCN; a size-locked net is refused up front
    instead of failing with a shape error mid-game."""
    from rocalphago_tpu_torch.search.players import build_player, player_board

    parts = spec.split(":")
    try:
        player = build_player(parts[0], parts[1],
                              parts[2] if len(parts) > 2 else None,
                              parts[3] if len(parts) > 3 else None,
                              temperature=temperature, playouts=playouts,
                              device_rollout=device_rollout, device=device,
                              board=board)
    except (ValueError, IndexError) as e:
        raise SystemExit(f"bad player spec {spec!r}: {e}")
    net_board = player_board(player)
    if net_board is not None and net_board != board:
        raise SystemExit(
            f"player {spec!r} nets are built for board {net_board}, but "
            f"the tournament is --board {board}")
    return player


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Agent-vs-agent evaluation tournament")
    ap.add_argument("player_a",
                    help="kind:policy.json[:value.json[:rollout.json]]")
    ap.add_argument("player_b",
                    help="kind:policy.json[:value.json[:rollout.json]]")
    ap.add_argument("--games", type=int, default=20)
    ap.add_argument("--board", type=int, default=19)
    ap.add_argument("--komi", type=float, default=None,
                    help="area-scoring komi (default: the board size's "
                         "standard, 7.5 at 13x13 and up, 7.0 below)")
    ap.add_argument("--move-limit", type=int, default=722)
    ap.add_argument("--handicap", type=int, default=0,
                    help="Black stones on the fixed star points before "
                         "every game (0 = even; colours still alternate, "
                         "so each player takes the stones in half the "
                         "games)")
    ap.add_argument("--temperature", type=float, default=0.67)
    ap.add_argument("--playouts", type=int, default=100)
    ap.add_argument("--device-rollout", action="store_true",
                    help="mcts rollouts wholly on the device, one run a "
                         "wave, instead of on host rules")
    ap.add_argument("--log", default=None, help="JSONL game log path")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run on "
                         "the CPU)")
    a = ap.parse_args(argv)
    if a.komi is None:
        from rocalphago_tpu_torch.engine.torchgo import default_komi

        a.komi = default_komi(a.board)
    if a.handicap:
        from rocalphago_tpu_torch.interface.gtp import fixed_handicap_points

        try:
            fixed_handicap_points(a.board, a.handicap)
        except ValueError as e:
            raise SystemExit(f"--handicap {a.handicap}: {e}")
    pa = _build_player(a.player_a, a.temperature, a.playouts, a.board,
                       a.device, a.device_rollout)
    pb = _build_player(a.player_b, a.temperature, a.playouts, a.board,
                       a.device, a.device_rollout)
    log = open(a.log, "w") if a.log else None
    try:
        tally = run_tournament(pa, pb, a.games, size=a.board,
                               komi=a.komi, move_limit=a.move_limit,
                               log=log, handicap=a.handicap)
    finally:
        if log:
            log.close()
    print(json.dumps(tally))
    return tally


if __name__ == "__main__":
    main(sys.argv[1:])
