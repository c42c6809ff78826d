"""Batched self-play on the card → SGF records: the port of the
reference's ``interface/selfplay_cli.py``.

    python -m rocalphago_tpu_torch.interface.selfplay_cli \\
        --policy results/zero_r5/target_compare/puct/policy.json \\
        --games 16 --chunk 20 --out build/selfplay [--device cpu]

plays ``--games`` lockstep games with a saved policy (against itself or
``--opponent``), or with ``--search-sims`` and ``--value`` every move
from a PUCT search on the card (``--gumbel``: the Gumbel root search,
playing each ply's halving winner), then writes one SGF per game and a
``summary.json``. It runs on the card unless ``--device`` names another
device, and raises when no card is there.

The summary carries the registry's snapshot (this CLI writes no
``metrics.jsonl``): ``selfplay_game_plies`` (one observation per game,
from the game lengths the summary reads anyway), ``selfplay_games_total``
and ``selfplay_games_per_min``, beside the runners' own metrics. Fault
barriers: ``selfplay_cli.pre_play``, ``post_play`` and ``post_sgf``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from rocalphago_tpu_torch.data import sgf
from rocalphago_tpu_torch.engine import pygo, torchgo
from rocalphago_tpu_torch.models import NeuralNetBase
from rocalphago_tpu_torch.obs import registry as obs_registry
from rocalphago_tpu_torch.runtime import faults
from rocalphago_tpu_torch.runtime.atomic import atomic_write_json


def result_strings(cfg, final_states) -> list:
    """SGF RE values ("B+7.5" area-margin form) per game."""
    b, w = torchgo.area_scores(cfg, final_states)
    b = b.cpu().numpy().astype(np.float64)
    w = w.cpu().numpy().astype(np.float64)
    out = []
    for bi, wi in zip(b, w):
        if bi > wi:
            out.append(f"B+{bi - wi:g}")
        elif wi > bi:
            out.append(f"W+{wi - bi:g}")
        else:
            out.append("0")
    return out


def games_to_sgf(cfg, result, out_dir: str, prefix: str = "selfplay",
                 black_name: str = "policy-a", white_name: str = "policy-b",
                 app: str = "rocalphago_tpu_torch") -> list:
    """Write one SGF per game of a ``SelfplayResult``; ``app`` goes to
    the records' ``AP``."""
    os.makedirs(out_dir, exist_ok=True)
    actions = result.actions.cpu().numpy()      # [T, B]
    live = result.live.cpu().numpy()            # [T, B]
    n = cfg.num_points
    res = result_strings(cfg, result.final)
    paths = []
    for g in range(actions.shape[1]):
        moves = []
        for t in range(actions.shape[0]):
            if not live[t, g]:
                break
            a = int(actions[t, g])
            color = pygo.BLACK if t % 2 == 0 else pygo.WHITE
            moves.append((color, None if a >= n else divmod(a, cfg.size)))
        game = sgf.from_moves(cfg.size, cfg.komi, moves, result=res[g])
        game.properties["PB"] = black_name
        game.properties["PW"] = white_name
        path = os.path.join(out_dir, f"{prefix}-{g:05d}.sgf")
        with open(path, "w") as f:
            f.write(sgf.render(game, app=app))
        paths.append(path)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Play batched self-play games on the card, save SGFs")
    ap.add_argument("--policy", required=True, help="policy model JSON")
    ap.add_argument("--opponent", default=None,
                    help="optional second policy JSON (default: self)")
    ap.add_argument("--games", type=int, default=16)
    ap.add_argument("--out", required=True)
    ap.add_argument("--max-moves", type=int, default=500)
    ap.add_argument("--temperature", type=float, default=0.67)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-sgf", action="store_true",
                    help="summary only (skip SGF files)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="plies per segment, stopping once every game "
                         "has ended (policy mode; 0 = every ply up to "
                         "--max-moves in one run), or simulations per "
                         "chunk with --search-sims (0 = 8)")
    ap.add_argument("--search-sims", type=int, default=0,
                    help="play every move from a search of this "
                         "many simulations on the card instead of "
                         "sampling the raw policy (requires --value; "
                         "incompatible with --opponent)")
    ap.add_argument("--value", default=None,
                    help="value model JSON (with --search-sims)")
    ap.add_argument("--gumbel", action="store_true",
                    help="with --search-sims: Gumbel root search "
                         "(sequential halving) instead of PUCT; plays "
                         "each ply's halving winner, so --temperature "
                         "does not apply")
    ap.add_argument("--m-root", type=int, default=16,
                    help="Gumbel root candidate count; lower it at "
                         "small --search-sims (every halving phase "
                         "visits each survivor at least once)")
    ap.add_argument("--dirichlet-alpha", type=float, default=0.0,
                    help="root-noise Dir(α) for PUCT search self-play "
                         "(0 = off; incompatible with --gumbel)")
    ap.add_argument("--noise-frac", type=float, default=0.25,
                    help="root-noise mix fraction ε")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run on "
                         "the CPU)")
    a = ap.parse_args(argv)
    if a.gumbel and not a.search_sims:
        raise SystemExit("--gumbel requires --search-sims")
    if a.dirichlet_alpha and not a.search_sims:
        raise SystemExit("--dirichlet-alpha requires --search-sims")
    if a.dirichlet_alpha and a.gumbel:
        raise SystemExit("--dirichlet-alpha is PUCT-mode root noise; "
                         "--gumbel explores via the gumbel draw")
    if a.games % 2 and not a.search_sims:
        # search self-play plays one net for both colours: no colour
        # split, so an odd batch is fine there
        raise SystemExit("--games must be even (colour split)")

    net = NeuralNetBase.load_model(a.policy, device=a.device)
    opp = (NeuralNetBase.load_model(a.opponent, device=a.device)
           if a.opponent else net)
    cfg, dev = net.cfg, net.device
    if a.search_sims:
        if not a.value:
            raise SystemExit("--search-sims requires --value")
        if a.opponent:
            raise SystemExit("--search-sims is self-play with one net "
                             "(no --opponent)")
        from rocalphago_tpu_torch.search.device_mcts import (
            make_mcts_selfplay,
        )
        from rocalphago_tpu_torch.search.selfplay import _finish

        value = NeuralNetBase.load_model(a.value, device=a.device)
        mcts_run = make_mcts_selfplay(
            cfg, net.feature_list, value.feature_list, net.module,
            value.module, batch=a.games, max_moves=a.max_moves,
            n_sim=a.search_sims, temperature=a.temperature,
            sim_chunk=a.chunk or 8, gumbel=a.gumbel, m_root=a.m_root,
            dirichlet_alpha=a.dirichlet_alpha, noise_frac=a.noise_frac,
            device=dev)

        def run(generator):
            final, actions, live = mcts_run(
                generator, np.random.default_rng(a.seed))
            return _finish(cfg, final, actions, live)
    elif a.chunk:
        from rocalphago_tpu_torch.search.selfplay import (
            make_selfplay_chunked,
        )

        runner = make_selfplay_chunked(
            cfg, net.feature_list, net.module, opp.module, batch=a.games,
            max_moves=a.max_moves, chunk=a.chunk,
            temperature=a.temperature, device=dev)

        # stop once every game has ended by two passes; the skipped tail
        # is zero-padded with live False, which the SGF writer reads as
        # the game's end
        def run(generator):
            return runner(generator, stop_when_done=True)
    else:
        from rocalphago_tpu_torch.search.selfplay import make_selfplay

        run = make_selfplay(cfg, net.feature_list, net.module, opp.module,
                            batch=a.games, max_moves=a.max_moves,
                            temperature=a.temperature, device=dev)

    faults.barrier("selfplay_cli.pre_play")
    t0 = time.monotonic()
    result = run(torch.Generator(device=dev).manual_seed(a.seed))
    winners = result.winners.cpu().numpy()
    dt = max(time.monotonic() - t0, 1e-9)
    faults.barrier("selfplay_cli.post_play")

    num_moves = result.num_moves.cpu().numpy()
    ply_h = obs_registry.histogram("selfplay_game_plies",
                                   edges=obs_registry.COUNT_EDGES)
    for moves in num_moves:
        ply_h.observe(float(moves))
    obs_registry.counter("selfplay_games_total").inc(a.games)
    games_per_min = a.games * 60.0 / dt
    obs_registry.gauge("selfplay_games_per_min").set(games_per_min)
    summary = {
        "games": a.games,
        "black_wins": int((winners > 0).sum()),
        "white_wins": int((winners < 0).sum()),
        "draws": int((winners == 0).sum()),
        "mean_moves": float(num_moves.mean()),
        "games_per_min": round(games_per_min, 3),
        "wall_s": round(dt, 3),
    }
    os.makedirs(a.out, exist_ok=True)
    if not a.no_sgf:
        paths = games_to_sgf(
            cfg, result, a.out, black_name=os.path.basename(a.policy),
            white_name=os.path.basename(a.opponent or a.policy))
        summary["sgf_files"] = len(paths)
        faults.barrier("selfplay_cli.post_sgf")
    summary["registry"] = obs_registry.snapshot()
    atomic_write_json(os.path.join(a.out, "summary.json"), summary)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
