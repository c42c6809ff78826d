"""Progressive-size zero curriculum: one FCN checkpoint, trained small
to large. The port of ``training/curriculum.py``.

The FCN heads make the params board-size-free, so the nets a 9×9 zero
run produces apply at 13×13 unchanged. This module runs the whole zero
loop (:func:`~.zero.run_training`: self-play, replay, gate,
checkpoints, actor/learner) at each board size in turn, handing the
finished params to the next stage through
:meth:`~..models.nn_util.NeuralNetBase.at_board`. Only the params
cross stages; each stage starts a fresh optimizer.

Layout: ``out_dir/stageNN_bSS/`` is a complete zero ``out_dir``
(resumable, gated, exported); the curriculum's own stream is
``out_dir/metrics.jsonl`` (``curriculum_stage`` and
``curriculum_transfer`` events, the spans ``curriculum.stage`` and
``curriculum.transfer``) and ``out_dir/curriculum.json`` holds the
summary. Each stage's run points the process's trace sink at its own
stream; the curriculum points it back before the stage's span closes.
Flags this parser does not own go to every stage's ``run_training`` as
they are; ``--device`` goes to both.

``--transfer-games N`` plays the final policy against a fresh net of
the same architecture at the final board size, raw policy, and claims
a transfer only on a Wilson 95% lower bound ≥ 0.5 over decided games
(:meth:`~.zero.ZeroGate.decide`).

Usage::

    python -m rocalphago_tpu_torch.training.curriculum \\
        policy.json value.json out_dir --stages 9:30,13:20,19:10 \\
        --sims 64 --game-batch 8 --transfer-games 64
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time

from rocalphago_tpu_torch.device import resolve_device
from rocalphago_tpu_torch.engine.torchgo import default_komi
from rocalphago_tpu_torch.obs import trace


def parse_stages(spec: str) -> list:
    """``"9:30,13:20,19:10"`` → ``[(9, 30), (13, 20), (19, 10)]``
    (board size : zero iterations)."""
    stages = []
    for part in spec.split(","):
        m = re.fullmatch(r"\s*(\d+)\s*:\s*(\d+)\s*", part)
        if not m:
            raise ValueError(
                f"bad stage {part!r} in --stages {spec!r} "
                "(want SIZE:ITERATIONS, e.g. 9:30,13:20)")
        board, iters = int(m.group(1)), int(m.group(2))
        if board < 2 or iters < 1:
            raise ValueError(
                f"bad stage {part!r}: board >= 2, iterations >= 1")
        stages.append((board, iters))
    if not stages:
        raise ValueError("--stages needs at least one SIZE:ITERATIONS")
    return stages


def stage_inputs(policy_json: str, value_json: str, board: int,
                 out_dir: str, device=None) -> tuple:
    """The previous stage's exported nets re-boarded to ``board`` and
    saved as this stage's input specs; ``at_board`` refuses size-locked
    (dense or bias head) nets."""
    from rocalphago_tpu_torch.models.nn_util import NeuralNetBase

    os.makedirs(out_dir, exist_ok=True)
    out = []
    for path, name in ((policy_json, "policy"), (value_json, "value")):
        net = NeuralNetBase.load_model(path, device=device).at_board(board)
        spec = os.path.join(out_dir, f"{name}.json")
        net.save_model(spec, os.path.join(out_dir,
                                          f"{name}.flax.msgpack"))
        out.append(spec)
    return tuple(out)


def transfer_match(policy_json: str, board: int, games: int,
                   temperature: float, move_limit: int, seed: int,
                   device=None) -> dict:
    """The curriculum's final policy (re-boarded to ``board``) against a
    fresh net of the same architecture, through :meth:`ZeroGate.match`'s
    raw-policy runner; ``transfer`` is True only when its decided-game
    win rate carries a Wilson 95% lower bound ≥ 0.5."""
    import torch

    from rocalphago_tpu_torch.models.nn_util import NeuralNetBase
    from rocalphago_tpu_torch.training.zero import ZeroGate, _seed_of

    net = NeuralNetBase.load_model(policy_json,
                                   device=device).at_board(board)
    fresh = type(net)(net.feature_list, board=board, seed=seed,
                      device=net.device, dtype=net.module.dtype,
                      **net.spec_kwargs)
    cfg = dataclasses.replace(net.cfg, komi=default_komi(board))
    gate = ZeroGate(cfg, net.feature_list, pool_dir="", games=games,
                    threshold=0.5, temperature=temperature,
                    move_limit=move_limit, write=False, device=net.device)
    gen = torch.Generator(device=net.device)
    gen.manual_seed(_seed_of(seed ^ 0x7A45))
    result = gate.match(net.module, fresh.module, gen)
    transfer, lb = gate.decide(result)
    return {"board": board, "games": games, "transfer": bool(transfer),
            "wilson_lb": round(float(lb), 4), **result}


def run_curriculum(argv=None) -> dict:
    """The CLI; returns the summary ``curriculum.json`` records. Stage
    flags pass through to every stage (the per-stage ``--iterations``
    and ``--seed`` are appended last, so the curriculum's win)."""
    from rocalphago_tpu_torch.io.metrics import MetricsLogger
    from rocalphago_tpu_torch.training.zero import run_training

    ap = argparse.ArgumentParser(
        description="Progressive-size zero curriculum over one FCN "
                    "checkpoint (unknown flags go to every stage's "
                    "training.zero run)")
    ap.add_argument("policy_json")
    ap.add_argument("value_json")
    ap.add_argument("out_dir")
    ap.add_argument("--stages", required=True,
                    help="comma list of SIZE:ITERATIONS (e.g. "
                         "9:30,13:20,19:10)")
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed; stage i trains with seed + i")
    ap.add_argument("--transfer-games", type=int, default=0,
                    help="after the last stage: the curriculum policy "
                         "against a fresh net at the final board, N "
                         "games raw policy, Wilson-gated (0 = skip)")
    ap.add_argument("--transfer-temperature", type=float, default=1.0)
    ap.add_argument("--transfer-move-limit", type=int, default=240)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a, passthrough = ap.parse_known_args(argv)
    stages = parse_stages(a.stages)
    resolve_device(a.device)        # no card: raise before writing
    if a.device is not None:
        passthrough = [*passthrough, "--device", a.device]

    os.makedirs(a.out_dir, exist_ok=True)
    metrics = MetricsLogger(os.path.join(a.out_dir, "metrics.jsonl"))
    metrics.log("curriculum_start", stages=[list(s) for s in stages],
                cmd=" ".join(sys.argv))
    trace.configure(metrics)
    prev_policy, prev_value = a.policy_json, a.value_json
    stage_rows = []
    summary: dict = {}
    try:
        for i, (board, iters) in enumerate(stages):
            stage_dir = os.path.join(a.out_dir, f"stage{i:02d}_b{board}")
            p_in, v_in = stage_inputs(prev_policy, prev_value, board,
                                      os.path.join(stage_dir, "init"),
                                      device=a.device)
            t0 = time.time()
            with trace.span("curriculum.stage", stage=i, board=board,
                            iterations=iters):
                final = run_training([p_in, v_in, stage_dir, *passthrough,
                                      "--iterations", str(iters),
                                      "--seed", str(a.seed + i)])
                # the stage's run pointed the sink at its own stream:
                # point it back before this span closes
                trace.configure(metrics)
            row = {"stage": i, "board": board, "iterations": iters,
                   "duration_s": round(time.time() - t0, 3),
                   "out_dir": stage_dir, **final}
            metrics.log("curriculum_stage", **row)
            stage_rows.append(row)
            prev_policy = os.path.join(stage_dir, "policy.json")
            prev_value = os.path.join(stage_dir, "value.json")
        summary = {"stages": stage_rows, "final_policy": prev_policy,
                   "final_value": prev_value}
        if a.transfer_games > 0:
            board = stages[-1][0]
            with trace.span("curriculum.transfer", board=board,
                            games=a.transfer_games):
                tr = transfer_match(prev_policy, board, a.transfer_games,
                                    a.transfer_temperature,
                                    a.transfer_move_limit,
                                    a.seed + len(stages), device=a.device)
            metrics.log("curriculum_transfer", **tr)
            summary["transfer"] = tr
        with open(os.path.join(a.out_dir, "curriculum.json"), "w") as f:
            json.dump(summary, f, indent=2)
    finally:
        metrics.close()
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    run_curriculum(sys.argv[1:])
