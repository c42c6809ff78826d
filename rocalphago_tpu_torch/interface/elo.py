"""Elo ratings from tournament game logs (Bradley–Terry MLE): the port
of ``interface/elo.py``, a copy (it touches no device).

The AlphaGo paper reports strengths on the Elo scale. Feed this one or
more JSONL logs written by
``rocalphago_tpu_torch.interface.tournament --log`` (lines of
``{"game": n, "black": name, "white": name, "winner": name|"draw"}``)
and it fits a Bradley–Terry model by minorization–maximization and
reports ratings in Elo points.

Conventions:
- a draw counts as half a win for each player (the standard reduction;
  Go draws only occur at integer komi or move-limit adjournments);
- ratings are translation-invariant, so they are anchored: the
  ``--anchor`` player (default: alphabetically first) is pinned to
  ``--anchor-elo`` (default 0);
- players connected by no game path to the anchor cannot be placed on
  the same scale — they are reported with ``"elo": null`` rather than
  a fabricated number.

CLI:
    python -m rocalphago_tpu_torch.interface.elo games1.jsonl games2.jsonl \
        [--anchor NAME] [--anchor-elo E] [--bootstrap N]

``--bootstrap N`` adds percentile-bootstrap 95% rating intervals from
N game resamples — small-sample Elo is noisy, and the tool says so
with numbers.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import sys


def wilson_lower_bound(wins: float, n: int, z: float = 1.96) -> float:
    """Lower edge of the Wilson score interval for a binomial win
    rate: the smallest true rate plausibly consistent (at confidence
    ``z``; default 95%) with ``wins`` observed wins in ``n`` decided
    games. The reference's zero-loop evaluator gate promotes only when
    this bound clears 0.5: a 64-game 0.59 point estimate has a ~±0.12
    interval. ``n <= 0`` returns 0.0 (no evidence, no promotion).
    Fractional wins (draw = half) are fine.
    """
    if n <= 0:
        return 0.0
    p = min(max(wins / n, 0.0), 1.0)
    z2 = z * z
    center = p + z2 / (2.0 * n)
    margin = z * math.sqrt(p * (1.0 - p) / n + z2 / (4.0 * n * n))
    return max(0.0, (center - margin) / (1.0 + z2 / n))


def read_games(paths) -> list[dict]:
    """Parse tournament JSONL logs; skips malformed lines."""
    games = []
    for path in paths:
        try:
            f = open(path)
        except OSError as e:
            raise SystemExit(f"cannot read game log {path}: {e}")
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    g = json.loads(line)
                except ValueError:
                    continue
                if (isinstance(g, dict)
                        and {"black", "white", "winner"} <= g.keys()):
                    games.append(g)
    return games


def pair_counts(games):
    """-> (wins[a][b] = fractional wins of a over b, players set)."""
    wins: dict = collections.defaultdict(lambda: collections.defaultdict(float))
    players: set = set()
    for g in games:
        b, w, won = g["black"], g["white"], g["winner"]
        players.update((b, w))
        if won == "draw":
            wins[b][w] += 0.5
            wins[w][b] += 0.5
        elif won in (b, w):
            loser = w if won == b else b
            wins[won][loser] += 1.0
    return wins, players


def _components(players, wins):
    """Connected components of the played-against graph."""
    adj = collections.defaultdict(set)
    for a in wins:
        for b in wins[a]:
            adj[a].add(b)
            adj[b].add(a)
    seen, comps = set(), []
    for p in sorted(players):
        if p in seen:
            continue
        comp, stack = set(), [p]
        while stack:
            q = stack.pop()
            if q in comp:
                continue
            comp.add(q)
            stack.extend(adj[q] - comp)
        seen |= comp
        comps.append(comp)
    return comps


def bradley_terry(players, wins, iters: int = 200,
                  tol: float = 1e-10) -> dict:
    """MM fit of BT strengths p_i (Hunter 2004); -> {player: p}.

    Each player's strength update is
        p_i <- W_i / sum_j n_ij / (p_i + p_j)
    where W_i is i's total (fractional) wins and n_ij the games played
    between i and j. A player with zero wins (or zero losses) has no
    finite MLE; a half-game virtual draw against every opponent played
    regularizes (standard practice, keeps orderings).
    """
    players = sorted(players)
    n = collections.defaultdict(float)
    for a in wins:
        for b, w in wins[a].items():
            n[(a, b)] += w
            n[(b, a)] += w
    reg_wins = collections.defaultdict(float)
    opponents = collections.defaultdict(set)
    for (a, b), cnt in list(n.items()):
        if cnt > 0:
            opponents[a].add(b)
    for a in players:
        for b in opponents[a]:
            reg_wins[a] += wins[a][b] + 0.25   # + virtual half-draw
            n[(a, b)] = wins[a][b] + wins[b][a] + 0.5

    p = {a: 1.0 for a in players}
    for _ in range(iters):
        delta = 0.0
        for a in players:
            if not opponents[a]:
                continue
            denom = sum(n[(a, b)] / (p[a] + p[b])
                        for b in opponents[a])
            new = reg_wins[a] / denom if denom > 0 else p[a]
            delta = max(delta, abs(new - p[a]))
            p[a] = new
        # renormalize (geometric mean 1) for numeric stability
        logs = [math.log(v) for v in p.values() if v > 0]
        shift = math.exp(sum(logs) / len(logs)) if logs else 1.0
        for a in p:
            p[a] /= shift
        if delta < tol:
            break
    return p


def elo_table(games, anchor: str | None = None,
              anchor_elo: float = 0.0) -> dict:
    """games -> {"players": {name: {elo, games, wins, losses, draws}},
    "anchor": name}. Elo = 400·log10(p) shifted so anchor lands on
    ``anchor_elo``; players not connected to the anchor get null."""
    wins, players = pair_counts(games)
    if not players:
        return {"players": {}, "anchor": None}
    if anchor is not None and anchor not in players:
        # a typo'd anchor silently re-anchoring the whole table is
        # worse than an error
        raise ValueError(f"anchor {anchor!r} appears in no game; "
                         f"players: {sorted(players)}")
    p = bradley_terry(players, wins)
    anchor = anchor if anchor is not None else sorted(players)[0]
    comps = _components(players, wins)
    anchored = next(c for c in comps if anchor in c)

    raw = {a: 400.0 * math.log10(v) if v > 0 else None
           for a, v in p.items()}
    shift = anchor_elo - raw[anchor] if raw[anchor] is not None else 0.0

    tally = collections.defaultdict(lambda: [0, 0, 0])  # w, l, d
    for g in games:
        b, w, won = g["black"], g["white"], g["winner"]
        if won == "draw":
            tally[b][2] += 1
            tally[w][2] += 1
        elif won in (b, w):
            loser = w if won == b else b
            tally[won][0] += 1
            tally[loser][1] += 1

    out = {}
    for a in sorted(players):
        elo = (round(raw[a] + shift, 1)
               if a in anchored and raw[a] is not None else None)
        out[a] = {"elo": elo, "games": sum(tally[a]),
                  "wins": tally[a][0], "losses": tally[a][1],
                  "draws": tally[a][2]}
    return {"players": out, "anchor": anchor}


def bootstrap_ci(games, anchor=None, anchor_elo: float = 0.0,
                 n_boot: int = 200, seed: int = 0,
                 pct: tuple = (2.5, 97.5)) -> dict:
    """Percentile bootstrap over games: ``{player: [lo, hi] | None}``.

    Resamples the game list with replacement ``n_boot`` times and
    refits; a player whose rating is null (disconnected from the
    anchor) in any resample — or who drops out of a resample entirely
    — contributes no sample there, and gets null bounds if fewer than
    half the COMPLETED resamples (those whose table fit — resamples
    that drop the anchor entirely are skipped and don't count) rate
    them. Small-sample Elo is NOISY; the
    point of this is to say so with numbers."""
    import random

    rng = random.Random(seed)
    # resolve the anchor ONCE from the full game set: with
    # anchor=None each resample would otherwise pick its own
    # alphabetically-first player, mixing rating scales across
    # resamples and corrupting the intervals
    _, players = pair_counts(games)
    if anchor is None and players:
        anchor = sorted(players)[0]
    samples: dict = {}
    # resamples whose table fit, the null-CI threshold's denominator:
    # skipped resamples must not count against always-rated players on
    # sparse logs
    completed = 0
    for _ in range(n_boot):
        resample = rng.choices(games, k=len(games))
        try:
            t = elo_table(resample, anchor, anchor_elo)
        except ValueError:      # anchor absent from this resample
            continue
        completed += 1
        for name, row in t["players"].items():
            if row["elo"] is not None:
                samples.setdefault(name, []).append(row["elo"])

    def pick(vals, q):
        vals = sorted(vals)
        i = q / 100.0 * (len(vals) - 1)
        lo, hi = int(math.floor(i)), int(math.ceil(i))
        return vals[lo] + (vals[hi] - vals[lo]) * (i - lo)

    out = {}
    # the honest-interval floor scales down with the request: a
    # smoke-test n_boot=5 where all 5 resamples
    # complete should yield (noisy) bounds, not silent nulls — the
    # floor only nulls when resamples were LOST to anchor dropout
    floor = min(10, n_boot)
    for name, vals in samples.items():
        # below the floor: too few surviving resamples for ANY honest
        # interval — a "95% CI" from 1-2 points would carry the same
        # authority as a real one
        if completed < floor or len(vals) < completed / 2:
            out[name] = None
        else:
            out[name] = [round(pick(vals, pct[0]), 1),
                         round(pick(vals, pct[1]), 1)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Elo ratings from tournament JSONL logs")
    ap.add_argument("logs", nargs="+", help="tournament --log files")
    ap.add_argument("--anchor", default=None,
                    help="player pinned to --anchor-elo "
                         "(default: alphabetically first)")
    ap.add_argument("--anchor-elo", type=float, default=0.0)
    ap.add_argument("--bootstrap", type=int, default=0, metavar="N",
                    help="add [2.5%%, 97.5%%] percentile-bootstrap "
                         "rating intervals from N game resamples")
    a = ap.parse_args(argv)
    games = read_games(a.logs)
    try:
        table = elo_table(games, a.anchor, a.anchor_elo)
        if a.bootstrap and games:
            ci = bootstrap_ci(games, a.anchor, a.anchor_elo,
                              n_boot=a.bootstrap)
            for name, row in table["players"].items():
                row["elo_ci95"] = ci.get(name)
    except ValueError as e:
        raise SystemExit(str(e))
    print(json.dumps(table, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
