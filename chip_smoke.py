#!/usr/bin/env python3
"""Drive the PyTorch port (``rocalphago_tpu_torch``) on one CUDA card
and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. card: name and power limit (``nvidia-smi``), kernel build time (the
   three sources, one ``nvcc`` each, in parallel);
2. tree kernel vs its plain version: search trees grown at 9×9 and
   19×19, batch 1, 7 and 64, with terminal nodes, forced first edges, a
   slab that fills, the main path's slab (batch 1, 200 nodes, 100
   simulations) and roots moved down the tree -- every descent's node
   and action and every backup's slabs bit-exact;
3. labels kernel vs its plain version: 19×19 boards from seeded random
   play (0, 60 and 200 moves), serpentine snakes at 9, 13, 19 and 25,
   random boards at 7, 9, 13, 25 and 32, and region boards (9 where
   empty, 0 elsewhere, as area scoring sends them) at 9, 19 and 32 --
   bit-exact;
4. chase kernel vs its plain version: lanes harvested from real encodes
   of ladder-heavy and random 19×19 positions, seeded random entries
   and disabled lanes; 1, 6 and 7 lanes with disabled lanes among live
   ones; lanes at 7, 9, 13, 25 and 32 with ladders to every edge --
   verdicts and read cores bit-exact;
5. encode: 19×19 positions encoded on the card equal the CPU encode
   (plain versions) bit for bit;
6. forward: the full-width policy and value nets (19×19, 48 and 49
   planes, 12 layers × 128 filters, the value net's FCN head, fresh
   seeded weights), float32 with TF32 off, card vs CPU within
   ``FORWARD_ATOL``/``FORWARD_RTOL``, at batch 8 and 256;
7. greedy GTP, slice 1's path: the policy saved as a spec, loaded by the
   GTP player factory (``build_player``: the card, bfloat16), and a
   scripted session through ``run_gtp`` with a ladder on the board and
   ``GENMOVES`` genmoves for both colours; every reply a legal vertex,
   no illegal move from the player, and the labels and chase kernels
   launched during it (launch counts reset just before, read just
   after);
8. device search: 8 roots searched together at full width (float32)
   give the visits each gets alone; a chunk of simulations at batch 1
   and 8 (bfloat16) runs under ``torch.cuda.set_sync_debug_mode
   ("error")``, so makes no device→host sync;
9. device-search GTP, this slice's main path: both nets saved as specs
   and loaded by ``build_player("device-mcts", ...)``, a scripted
   session of ``SEARCH_GENMOVES`` genmoves at 100 simulations, then
   ``TIMED_GENMOVES`` under ``time_settings 0 1 1`` (the deadline
   armed); every reply a legal vertex, and the labels, chase and tree
   kernels launched during it (counts reset just before, read just
   after);
10. timings with CUDA events at the main path's shapes (one state per
    genmove or simulation) and at batch 8 and 256, beside each plain
    version and each kernel's roofline bound; the greedy genmove p50;
    the device-search genmove p50 and simulations per second, the
    stages of a simulation, and a profile of one chunk; the tree kernel
    held against its plain version once more on the tree the GTP
    session's last search left and on each tree it is timed on;
11. policy self-play, this slice's headline path: 19×19, two fresh
    12 × 128 bf16 policies, batch 256, up to 300 plies in segments of
    10, stopping when every game is over. An untimed segment; a segment
    under ``set_sync_debug_mode("error")``; the timed run (games per
    minute under the reference's metric name, board-plies/s, mean game
    length, the pipeline's ``host_gap_frac``; chase and labels launched,
    counts reset just before and read just after); its first 8 games
    replayed on the CPU port (every action sensible there, the same
    live rows, boards, done flags and winners); ``winner`` on the card
    against ``host_winners``; the chase kernel on the lanes of one of
    its batch-256 encodes and the labels kernel on its final region
    boards, bit-exact and timed; the stages of a ply and a profile of a
    segment;
12. search self-play: the device-search player's nets, batch 8, 32
    simulations a move, Dirichlet noise (α 0.03, ε 0.25), forced
    playouts (k 2), recorded targets, 8 plies (plies/s, simulations/s;
    every target sums to 1; all three kernels launched); the tree kernel
    with forced playouts bit-exact against its plain version and timed
    on a grown batch-8 slab and on a batch-256 slab grown from phase
    11's positions (that one also with ``forced_k`` 0, the PUCT walk);
13. the self-play CLI (``python -m
    rocalphago_tpu_torch.interface.selfplay_cli``) on the committed 9×9
    nets, policy mode and search mode, into ``build/smoke_selfplay``;
    every SGF parses with the port's reader and replays legally;
14. the supervised training path at full width, in ``build/smoke_sl``:
    the converter's CLI entry (``rocalphago_tpu_torch.data.convert``)
    on the committed 19×19 games of ``results/sl19_r5/sgf`` (48 planes;
    the manifest counts every game and one position per non-pass move;
    labels and chase launched, counts reset just before and read just
    after; positions/s), its first 2 games converted again by the CPU
    port, bit for bit; the SL trainer's CLI entry on a fresh seeded
    12 × 128 bf16 policy saved as a spec (minibatch 16, symmetries on,
    2 epochs of 50 steps: finite losses, every artifact, the exported
    ``model.json`` answering GTP genmoves legally); exact resume (killed
    after epoch 0, and after step 25 with a checkpoint every 10, both
    resumed through the CLI to the straight run's params bit for bit);
    the evaluator's ``top1`` equal to the trainer's ``test_accuracy``;
    the value trainer on a seeded 512-position outcome corpus (12 ×
    128 FCN bf16; finite MSEs, the export, the evaluator's MSE); the
    train step at minibatch 16 and 256 with CUDA events (parts, the
    MFU share, a profile of 20 steps) and the cost of deterministic
    cuDNN at 256.

The kernel line's launches are phases 11, 12 and 14's conversion
together, its times those at self-play's shapes (chase at 1,536 lanes,
labels at 256 region boards, the tree at batch 8). The last three lines are the card (as
``nvidia-smi`` prints it), the kernel table as JSON, and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

SIZE = 19
SEED = 20261017
GENMOVES = 12            # per colour
SEARCH_GENMOVES = 6      # device-search genmoves at 100 simulations
TIMED_GENMOVES = 4       # then under time_settings 0 1 1
SEARCH_CHECK_SIMS = 16   # simulations of the batched-vs-alone check
CHUNK = 8                # simulations per chunk (the player's default)
SP_BATCH = 256           # policy self-play: games in lockstep
SP_MAX_MOVES = 300       # the reference's headline game length
SP_CHUNK = 10            # plies per segment
SP_REPLAY = 8            # games of the card run replayed on the CPU
SS_BATCH, SS_SIMS, SS_PLIES = 8, 32, 8     # search self-play
SS_ALPHA, SS_EPS, SS_FORCED_K = 0.03, 0.25, 2.0
SS_TREE256_SIMS = 16     # simulations of the batch-256 tree timed
CLI_TIMEOUT_S = 300
PUCT_DIR = os.path.join("results", "zero_r5", "target_compare", "puct")
FORWARD_ATOL = 1e-3      # float32 card vs CPU, TF32 off: summation
FORWARD_RTOL = 1e-4      # order only, over 12 layers of 1,152-term dots
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
SCALAR_OPS_PER_S = 67e12           # float32 outside the tensor cores
# The bounds' work is the reference's, whatever kernel implements it.
# Chase: integer operations per board point per rung of the reference's
# read (rocalphago_tpu/features/ladders.py::_chase): the liberty table
# (4 neighbour reads, the dedup of 4 roots, the empty test, ~20), the
# prey mask and its liberty points (~10), and per chaser option, two a
# rung: _place (~10), _escaper_response_full's own masks (five
# dilations, the merged chaser group, the gained roots, the atari and
# target masks, ~60) and its two try_moves (two root masks, empty2,
# comp, two dilations, two reductions, ~60); _relabel_place's ~10 for
# each ply is inside the rounding. Counted over the rungs chase_plain
# reports for the run's lanes.
CHASE_OPS_PER_POINT_RUNG = 300
# Labels: per point per hook-and-jump sweep of the reference's fill
# (4 hooks, a jump, the change test), over the sweeps labels_sweeps
# counts for the run's boards.
LABELS_OPS_PER_POINT_SWEEP = 6
BF16_FLOPS_PER_S = 989e12          # H100 SXM data sheet, dense bf16
SL_DIR = os.path.join("build", "smoke_sl")
SL_GAMES = os.path.join("results", "sl19_r5", "sgf")
SL_CPU_GAMES = 2         # games the CPU port converts again
SL_EPOCH_LENGTH = 50     # steps per epoch of the SL runs (2 epochs)
SL_KILL_AFTER = 25       # steps before the mid-epoch kill
SL_TIMED_BATCHES = (16, 256)
VALUE_POSITIONS = 512    # the value trainer's seeded outcome corpus
VALUE_STEPS = 10
QUEUED_STEPS = 3         # ~750 launches at minibatch 256 (see sl_timings)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------- inputs


def random_positions(pygo, count: int, moves, seed: int, size: int = SIZE):
    """Seeded random play: uniform random empty points, own eyes
    skipped, illegal tries dropped; ``moves[i % len(moves)]`` plies."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        st = pygo.GameState(size=size, komi=7.5)
        target = moves[i % len(moves)]
        tries = 0
        while st.turns_played < target and tries < 4 * target:
            tries += 1
            empty = np.flatnonzero(st.board.reshape(-1) == 0)
            mv = divmod(int(empty[rng.integers(len(empty))]), size)
            if st.is_eye(mv, st.current_player):
                continue
            try:
                st.do_move(mv)
            except pygo.IllegalMove:
                continue
        out.append(st)
    return out


def ladder_positions(pygo, count: int, seed: int, size: int = SIZE,
                     turn: bool = False):
    """Ladder-heavy boards: standard ladder seeds along the
    anti-diagonal (each white stone flanked on three sides, black to
    move; six of them at 19x19), plus a few seeded random stones that
    break some paths. The ladders run down and right, to the last row
    and column; ``turn=True`` mirrors board ``i`` by ``i % 4`` so that
    they run to every edge."""
    rng = np.random.default_rng(seed)
    seeds = [(r, size - 2 - r) for r in range(1, size - 1, 3)
             if size - 2 - r >= 1]
    out = []
    for i in range(count):
        flip_r, flip_c = turn and i % 2 == 1, turn and i % 4 >= 2

        def at(r, c):
            return (size - 1 - r if flip_r else r,
                    size - 1 - c if flip_c else c)

        st = pygo.GameState(size=size, komi=7.5)
        for r, c in seeds:
            st.do_move(at(r - 1, c), pygo.BLACK)
            st.do_move(at(r, c), pygo.WHITE)
            st.do_move(at(r, c - 1), pygo.BLACK)
            st.do_move(at(r + 1, c - 1), pygo.BLACK)
        for _ in range(i % 5):
            mv = tuple(int(v) for v in rng.integers(0, size, 2))
            if st.board[mv] == 0 and st.is_legal(mv):
                st.do_move(mv, pygo.WHITE if rng.random() < 0.5
                           else pygo.BLACK)
        st.current_player = pygo.BLACK if i % 2 == 0 else pygo.WHITE
        out.append(st)
    return out


def serpentine(size: int) -> np.ndarray:
    """A one-wide boustrophedon snake: one group whose label has to
    travel the longest path a board allows."""
    b = np.zeros((size, size), np.int8)
    for x in range(size):
        if x % 2 == 0:
            b[x, :] = 1
        else:
            b[x, size - 1 if (x // 2) % 2 == 0 else 0] = 1
    return b.reshape(-1)


# ----------------------------------------------------------------- timing


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls
    after a warm-up call. ``queued=True`` first parks the card on a
    spin kernel long enough for the host to queue every call, so the
    events time the kernels back to back on the device and not the
    host's launch overhead (for kernels that are shorter than their
    launch); the plain versions sync with the host inside and are
    timed as they run."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:     # ~2 GHz: at least twice the time it takes to queue
        torch.cuda._sleep(int(min(4e9, 4e9 * host_s * reps + 1e6)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    """Mean host milliseconds per call, synchronised: what a caller
    waits, launch overhead included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def bound(bytes_moved: float, ops: float):
    """(least milliseconds, what bounds it) on an H100 SXM."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ------------------------------------------------------------------ phases


def phase_card():
    from rocalphago_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    _build.KERNELS.build_all()
    log(f"kernel build: {_build.KERNELS.seconds:.1f} s")
    for name, out in _build.KERNELS.log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  nvcc {name}: {line.strip()}")
    for name, counts in sass_sizes(_build).items():
        log(f"  sass {name}: " + ", ".join(
            f"{fn} {k} instructions" for fn, k in counts.items()))
    return card


def sass_sizes(build) -> dict:
    """Instructions per kernel instance in each built library (the code a
    launch fetches), from ``cuobjdump -sass``; empty without it."""
    tool = os.path.join(os.path.dirname(build.KernelLibraries.nvcc()),
                        "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = {}
    for name in build.SOURCES:
        sass = subprocess.run([tool, "-sass", build.KERNELS._target(name)[1]],
                              capture_output=True, text=True,
                              timeout=120).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                m = re.search(r"ILi(\d+)E", line)
                fn = ("generic" if not m or m.group(1) == "0"
                      else f"size {m.group(1)}")
                counts[fn] = 0
            elif fn and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S.*;", line):
                counts[fn] += 1
        out[name] = counts
    return out


def phase_labels(pygo, dev):
    from rocalphago_tpu_torch.ops import labels as L

    sts = random_positions(pygo, 1026, (0, 60, 200), SEED)
    boards = np.stack([np.asarray(s.board, np.int8).reshape(-1)
                       for s in sts])
    cases = [(SIZE, boards)]
    for size in (9, 13, 19, 25):
        snake = serpentine(size)
        cases.append((size, np.stack([snake, -snake,
                                      np.ones_like(snake)])))
    # random boards at the other sizes; 7 and 32 take the kernel's
    # generic instance, and 33 boards are no multiple of the boards per
    # block
    for i, size in enumerate((7, 9, 13, 25, 32)):
        sts = random_positions(pygo, 30, (0, size * size // 3,
                                          size * size // 2), SEED + 40 + i,
                               size)
        snake = serpentine(size)
        cases.append((size, np.stack(
            [np.asarray(s.board, np.int8).reshape(-1) for s in sts]
            + [snake, -snake, np.ones_like(snake)])))
    # region boards, as area scoring labels them: 9 where the point is
    # empty, 0 elsewhere (so the empty regions are the groups)
    regions = []
    for i, size in enumerate((9, 19, 32)):
        sts = random_positions(pygo, 33, (0, size * size // 4,
                                          size * size // 2,
                                          size * size * 3 // 4),
                               SEED + 50 + i, size)
        b = np.stack([np.asarray(s.board, np.int8).reshape(-1)
                      for s in sts])
        cases.append((size, np.where(b == 0, 9, 0).astype(np.int8)))
        regions.append(size)
    worst = 0
    for size, b in cases:
        t = torch.as_tensor(b, device=dev)
        got = L.labels(t, size)
        want = L.labels_plain(t, size)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        check(torch.equal(got, want),
              f"labels kernel differs from plain at size {size}: "
              f"{int((got != want).sum())} points")
        worst = max(worst, err)
    log(f"labels: {len(boards)} 19x19 boards, serpentines at 9/13/19/25, "
        "33 boards each at 7/9/13/25/32, and 33 region boards (9 and 0) "
        f"each at {regions} bit-exact vs plain")
    return worst


class LaneRecorder:
    """Wraps ``ops.chase.chase`` to keep every lane an encode sends."""

    def __init__(self, chase_mod):
        self.mod = chase_mod
        self.inner = chase_mod.chase
        self.lanes = []

    def __enter__(self):
        def record(boards, labels, prey, size, depth=40,
                   collect_core=False):
            self.lanes.append((boards.clone(), labels.clone(), prey.clone()))
            return self.inner(boards, labels, prey, size, depth,
                              collect_core)

        self.mod.chase = record
        return self

    def __exit__(self, *exc):
        self.mod.chase = self.inner


def entry_lanes(pygo, torchgo, dev, count: int, seed: int,
                size: int = SIZE, moves=(40, 90, 140)):
    """Every 2-liberty group of random positions as a chase entry
    (board, carried labels, a prey point of the group)."""
    cfg = torchgo.GoConfig(size=size)
    sts = random_positions(pygo, count, moves, seed, size)
    st = torchgo.seed_labels(cfg, torchgo.from_pygo(
        cfg, sts, device=dev, with_labels=False))
    libs = torchgo.lib_counts_from_labels(cfg, st.board, st.labels)
    lab = st.labels.long()
    two = (libs.gather(1, lab) == 2) & (st.board != 0) & (
        lab == torch.arange(cfg.num_points, device=dev))
    g, p = torch.nonzero(two, as_tuple=True)
    return (st.board[g].contiguous(), st.labels[g].contiguous(),
            p.int().contiguous())


def encode_lanes(pygo, torchgo, dev, sts, size: int = SIZE):
    """The lanes one encode of ``sts`` sends to the chase."""
    from rocalphago_tpu_torch.features.api import Preprocess
    from rocalphago_tpu_torch.ops import chase as C

    cfg = torchgo.GoConfig(size=size)
    with LaneRecorder(C) as rec:
        Preprocess(cfg=cfg, device=dev).states_to_tensor(
            torchgo.seed_labels(cfg, torchgo.from_pygo(
                cfg, sts, device=dev, with_labels=False)))
    return tuple(torch.cat(x) for x in zip(*rec.lanes))


def check_chase(C, boards, labels, prey, size: int, what: str):
    """Kernel against plain on one lane set: verdicts and read cores
    bit-exact, disabled lanes False. Returns the plain verdicts."""
    got_c, got_core = C.chase(boards, labels, prey, size, 40,
                              collect_core=True)
    want_c, want_core = C.chase_plain(boards, labels, prey, size, 40,
                                      collect_core=True)
    torch.cuda.synchronize()
    check(torch.equal(got_c, want_c),
          f"chase {what}: verdicts differ on "
          f"{int((got_c != want_c).sum())} lanes")
    check(torch.equal(got_core, want_core),
          f"chase {what}: cores differ on "
          f"{int((got_core != want_core).any(1).sum())} lanes")
    check(not got_c[prey < 0].any(), f"chase {what}: a disabled lane "
          "read True")
    return want_c


def phase_chase(pygo, torchgo, dev):
    from rocalphago_tpu_torch.ops import chase as C

    sts = (ladder_positions(pygo, 24, SEED + 1)
           + random_positions(pygo, 40, (60, 120, 200), SEED + 2))
    eb, el, ep = encode_lanes(pygo, torchgo, dev, sts)
    rb, rl, rp = entry_lanes(pygo, torchgo, dev, 48, SEED + 3)
    boards = torch.cat([eb, rb, rb[:64]])
    labels = torch.cat([el, rl, rl[:64]])
    prey = torch.cat([ep, rp, torch.full((64,), -1, dtype=torch.int32,
                                         device=dev)])   # disabled lanes
    want_c = check_chase(C, boards, labels, prey, SIZE, "19x19")
    enc_live = int((ep >= 0).sum())
    check(enc_live > 0 and bool(want_c.any()) and not bool(want_c.all()),
          "the chase inputs lack live encode lanes or an outcome")
    log(f"chase: {len(prey)} lanes ({enc_live} live from encodes, "
        f"{len(rp)} random entries, 64 disabled), "
        f"{int(want_c.sum())} captured; verdicts and cores bit-exact")

    # lane counts that are no multiple of the lanes per block, with
    # disabled lanes among the live ones of a block
    live = torch.nonzero(prey >= 0)[:, 0]
    odd = []
    for k in (1, 6, 7):
        pick = live[torch.arange(k, device=dev) * 5 % len(live)]
        p = prey[pick].clone()
        p[1::3] = -1
        odd.append(int(check_chase(C, boards[pick].contiguous(),
                                   labels[pick].contiguous(), p, SIZE,
                                   f"{k} lanes").sum()))
    log(f"chase: 1, 6 and 7 lanes (lanes 1 and 4 disabled), "
        f"{odd} captured; bit-exact")

    # other board sizes (7 and 32 take the kernel's generic instance),
    # ladders to every edge, every third lane disabled
    seen = []
    for i, size in enumerate((7, 9, 13, 25, 32)):
        scale = size * size / (SIZE * SIZE)
        moves = tuple(max(4, int(m * scale)) for m in (40, 90, 140))
        sts = (ladder_positions(pygo, 8, SEED + 10 + i, size, turn=True)
               + random_positions(pygo, 16, moves, SEED + 20 + i, size))
        eb, el, ep = encode_lanes(pygo, torchgo, dev, sts, size)
        rb, rl, rp = entry_lanes(pygo, torchgo, dev, 16, SEED + 30 + i,
                                 size, moves)
        boards = torch.cat([eb, rb])
        labels = torch.cat([el, rl])
        prey = torch.cat([ep, rp])
        prey[1::3] = -1
        want_c = check_chase(C, boards, labels, prey, size,
                             f"{size}x{size}")
        check(bool((prey >= 0).any()), f"no live chase lane at {size}")
        seen.append(f"{size}x{size} {len(prey)} lanes "
                    f"{int(want_c.sum())} captured")
    log("chase: " + ", ".join(seen) + "; verdicts and cores bit-exact")
    return 0


def tree_levels(parent, root, node) -> np.ndarray:
    """Levels from each game's root down to ``node`` (a descent's
    reads), counted on the host from the ``parent`` slab."""
    parent, root = parent.cpu().numpy(), root.cpu().numpy()
    out = []
    for b, x in enumerate(node.cpu().numpy()):
        depth = 1
        while x != root[b] and parent[b, x] >= 0:
            x = parent[b, x]
            depth += 1
        out.append(depth)
    return np.asarray(out)


def grow_trees(T, dev, size: int, batch: int, max_nodes: int, sims: int,
               seed: int, forced: bool = False, c_puct: float = 5.0):
    """Grow ``batch`` search trees of ``(size² + 1)`` actions for ``sims``
    simulations, on the card through the tree kernel and on the CPU
    through its plain versions, from the same seeded priors, terminal
    flags and values; check every descent's node and action and every
    backup's slabs bit-exact. In a batch of more than one, game 0's
    root is terminal (it backs up nothing); a slab of ``max_nodes``
    smaller than ``sims`` fills. ``forced`` forces a random first edge
    on every other game; a small ``c_puct`` follows the values more and
    grows deeper trees. Returns
    the CPU slabs and the levels walked by each simulation's descent."""
    a_n = size * size + 1
    rng = np.random.default_rng(seed)
    shape = (batch, max_nodes, a_n)
    cpu = dict(prior=torch.zeros(shape), visits=torch.zeros(
        shape, dtype=torch.int32), value_sum=torch.zeros(shape),
        child=torch.full(shape, -1, dtype=torch.int32),
        done=torch.zeros((batch, max_nodes), dtype=torch.bool),
        parent=torch.full((batch, max_nodes), -1, dtype=torch.int32),
        paction=torch.zeros((batch, max_nodes), dtype=torch.int32))

    def prior_rows(k):
        # peaked priors, so that the descents go deep
        p = rng.random((k, a_n)) ** 16 * (rng.random((k, a_n)) < 0.3)
        p[:, -1] += 1e-3
        return torch.as_tensor(p / p.sum(1, keepdims=True),
                               dtype=torch.float32)

    cpu["prior"][:, 0] = prior_rows(batch)
    cpu["done"][0, 0] = batch > 1
    gpu = {k: v.to(dev) for k, v in cpu.items()}
    n_nodes = np.ones(batch, np.int64)
    root = torch.zeros(batch, dtype=torch.int32)
    levels = []
    for _ in range(sims):
        ra = torch.full((batch,), -1, dtype=torch.int32)
        if forced:
            ra[1::2] = torch.as_tensor(rng.integers(0, a_n, batch // 2),
                                       dtype=torch.int32)
        args = [cpu[k] for k in ("prior", "visits", "value_sum", "child",
                                 "done")]
        want = T.descend_plain(*args, root, ra, c_puct)
        got = T.descend(*[gpu[k] for k in ("prior", "visits", "value_sum",
                                           "child", "done")],
                        root.to(dev), ra.to(dev), c_puct)
        check(torch.equal(got[0].cpu(), want[0])
              and torch.equal(got[1].cpu(), want[1]),
              f"tree descend differs at {size}x{size}, batch {batch}")
        node, action = want
        levels.append(tree_levels(cpu["parent"], root, node))
        rows = prior_rows(batch)
        term = torch.as_tensor(rng.random(batch) < 0.1)
        start_n, start_a = node.clone(), action.clone()
        for b in range(batch):
            nd, a = int(node[b]), int(action[b])
            if a < 0:
                start_n[b] = cpu["parent"][b, nd]
                start_a[b] = cpu["paction"][b, nd]
                continue
            if n_nodes[b] >= max_nodes:
                continue
            i = int(n_nodes[b])
            n_nodes[b] += 1
            for d in (cpu, gpu):
                d["prior"][b, i] = rows[b].to(d["prior"].device)
                d["done"][b, i] = bool(term[b])
                d["parent"][b, i] = nd
                d["paction"][b, i] = a
                d["child"][b, nd, a] = i
        values = torch.as_tensor(rng.uniform(-1, 1, batch),
                                 dtype=torch.float32)
        T.backup_plain(cpu["visits"], cpu["value_sum"], cpu["parent"],
                       cpu["paction"], start_n, start_a, values)
        T.backup(gpu["visits"], gpu["value_sum"], gpu["parent"],
                 gpu["paction"], start_n.to(dev), start_a.to(dev),
                 values.to(dev))
        for k in ("visits", "value_sum"):
            check(torch.equal(gpu[k].cpu(), cpu[k]),
                  f"tree backup: {k} differs at {size}x{size}, batch "
                  f"{batch}")
    check(batch == 1 or int(cpu["visits"][0].sum()) == 0,
          "a terminal root backed up")
    return cpu, np.stack(levels)


def phase_tree(dev):
    """Tree kernel against its plain version on grown trees: 9×9 and
    19×19, batch 1, 7 and 64, terminal nodes, a forced first edge, a
    slab that fills, the main path's slab (batch 1, 200 nodes, 100
    simulations), and descents from roots moved down the tree."""
    from rocalphago_tpu_torch.ops import tree as T

    seen = []
    for size in (9, 19):
        for batch, m, sims in ((1, 64, 48), (1, 200, 100), (7, 48, 64),
                               (64, 24, 40)):
            for forced, c_puct in ((False, 5.0), (True, 0.5)):
                cpu, levels = grow_trees(T, dev, size, batch, m, sims,
                                         SEED + size + batch + forced,
                                         forced, c_puct)
            # roots moved to a random expanded node of each game
            root = torch.as_tensor(
                [int(np.random.default_rng(b).integers(
                    0, max(1, int((cpu["parent"][b] >= 0).sum()) + 1)))
                 for b in range(batch)], dtype=torch.int32)
            free = torch.full((batch,), -1, dtype=torch.int32)
            args = [cpu[k] for k in ("prior", "visits", "value_sum",
                                     "child", "done")]
            want = T.descend_plain(*args, root, free, 5.0)
            got = T.descend(*[x.to(dev) for x in args], root.to(dev),
                            free.to(dev), 5.0)
            check(torch.equal(got[0].cpu(), want[0])
                  and torch.equal(got[1].cpu(), want[1]),
                  f"tree descend from moved roots differs at {size}")
            seen.append(f"{size}x{size} batch {batch} slab {m} "
                        f"({int((cpu['parent'] >= 0).sum())} nodes, "
                        f"deepest {int(levels.max())} levels)")
    log("tree: descend and backup bit-exact vs plain at every simulation: "
        + ", ".join(seen))
    return 0


def phase_encode(pygo, torchgo, dev):
    from rocalphago_tpu_torch.features.api import Preprocess

    cfg = torchgo.GoConfig(size=SIZE)
    sts = (random_positions(pygo, 240, (10, 50, 100, 160, 220), SEED + 4)
           + ladder_positions(pygo, 16, SEED + 5))
    gpu = Preprocess(cfg=cfg, device=dev)
    cpu = Preprocess(cfg=cfg, device="cpu")
    for i in range(0, len(sts), 64):
        chunk = sts[i:i + 64]
        g = gpu.states_to_tensor(torchgo.seed_labels(cfg, torchgo.from_pygo(
            cfg, chunk, device=dev, with_labels=False)))
        c = cpu.states_to_tensor(torchgo.seed_labels(cfg, torchgo.from_pygo(
            cfg, chunk, device="cpu", with_labels=False)))
        check(g.shape == (len(chunk), SIZE, SIZE, 48), f"shape {g.shape}")
        check(torch.equal(g.cpu(), c),
              f"card encode differs from CPU encode in chunk {i // 64}")
    log(f"encode: {len(sts)} 19x19 positions, card == CPU bit for bit")


def phase_forward(torchgo, dev):
    from rocalphago_tpu_torch.models import CNNPolicy, CNNValue

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    for cls, planes_n, what in ((CNNPolicy, 48, "policy logit"),
                                (CNNValue, 49, "value")):
        gpu = cls(board=SIZE, layers=12, filters_per_layer=128,
                  seed=SEED, device=dev, dtype=torch.float32)
        cpu = cls(board=SIZE, layers=12, filters_per_layer=128,
                  seed=SEED, device="cpu", dtype=torch.float32)
        for batch in (8, 256):
            planes = torch.as_tensor((rng.random(
                (batch, SIZE, SIZE, planes_n)) < 0.3).astype(np.float32))
            g = gpu.forward(planes.to(dev)).cpu()
            c = cpu.forward(planes)
            check(bool(torch.isfinite(g).all()), f"non-finite {what}s")
            err = float((g - c).abs().max())
            check(torch.allclose(g, c, atol=FORWARD_ATOL,
                                 rtol=FORWARD_RTOL),
                  f"{what} forward batch {batch}: max abs err {err}")
            log(f"forward: {what}s, batch {batch}, 12x128 fp32 (TF32 off), "
                f"card vs CPU max abs err {err:.3g} (max |{what}| "
                f"{float(c.abs().max()):.3g})")


class Timed(io.StringIO):
    """Input stream that stamps when each line is handed out."""

    def __init__(self, text):
        super().__init__(text)
        self.stamps = []

    def __iter__(self):
        while line := self.readline():
            self.stamps.append(time.monotonic())
            yield line


def model_specs(dev):
    """The full-width nets saved as specs (fresh weights from the seed):
    the 19×19 ``CNNPolicy`` and the ``CNNValue`` with its FCN head."""
    from rocalphago_tpu_torch.models import CNNPolicy, CNNValue

    model_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "smoke_model")
    os.makedirs(model_dir, exist_ok=True)
    specs = (os.path.join(model_dir, "policy19.json"),
             os.path.join(model_dir, "value19.json"))
    CNNPolicy(board=SIZE, layers=12, filters_per_layer=128, seed=SEED,
              device=dev).save_model(specs[0])
    CNNValue(board=SIZE, layers=12, filters_per_layer=128, seed=SEED + 1,
             device=dev).save_model(specs[1])
    return specs


def phase_gtp(dev, counters):
    from rocalphago_tpu_torch.interface.gtp import run_gtp, vertex_to_move
    from rocalphago_tpu_torch.search.players import build_player

    # the user's route: a saved spec, loaded by the GTP entry's player
    # factory on its default device (the card) and working type (bf16)
    player = build_player("greedy", model_specs(dev)[0])
    net = player.policy
    check(net.device.type == "cuda" and net.module.dtype == torch.bfloat16,
          f"the GTP player runs on {net.device} in {net.module.dtype}")
    # a ladder: white (D4) flanked on three sides, black to move
    setup = ["boardsize 19", "clear_board", "komi 7.5", "play b C4",
             "play w D4", "play b D3", "play w Q16", "play b E3"]
    moves = [f"genmove {c}" for _ in range(GENMOVES) for c in "bw"]
    script = "\n".join(setup + moves + ["final_score", "quit"]) + "\n"

    instream, out = Timed(script), io.StringIO()
    for c in counters:
        c.launches = 0
    engine = run_gtp(player, instream, out)
    torch.cuda.synchronize()
    launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
    replies = [r for r in out.getvalue().split("\n\n") if r.strip()]
    check(len(replies) == len(setup) + len(moves) + 2,
          f"{len(replies)} replies to {len(setup) + len(moves) + 2} "
          "commands")
    for cmd, reply in zip(setup + moves, replies):
        check(reply.startswith("="), f"{cmd!r} -> {reply!r}")
    for reply in replies[len(setup):len(setup) + len(moves)]:
        move = vertex_to_move(reply[1:].strip(), SIZE)
        check(move is not None, f"genmove passed: {reply!r}")
    check(engine.illegal_from_player == 0,
          f"illegal_from_player = {engine.illegal_from_player}")
    for name, n in launches.items():
        check(n > 0, f"the {name} kernel was not launched by the genmoves")
    stamps = instream.stamps
    g0 = len(setup)
    lat = sorted(stamps[i + 1] - stamps[i] for i in range(g0, g0 + len(moves)))
    p50 = lat[len(lat) // 2] * 1e3
    log(f"gtp: {len(moves)} genmoves on the 19x19 12x128 bf16 net, all "
        f"legal vertices, illegal_from_player 0; launches {launches}; "
        f"genmove p50 {p50:.1f} ms (max {lat[-1] * 1e3:.1f} ms)")

    # where a genmove's time goes, stage by stage on the final position
    from rocalphago_tpu_torch.engine import torchgo

    st, cfg = engine.state, net.cfg
    parts = {"host sensible moves": lambda: st.get_legal_moves(
        include_eyes=False)}
    state = torchgo.seed_labels(cfg, torchgo.from_pygo(
        cfg, [st], device=dev, with_labels=False))
    planes = net.preprocess.states_to_tensor(state)
    parts["from_pygo + labels"] = lambda: torchgo.seed_labels(
        cfg, torchgo.from_pygo(cfg, [st], device=dev, with_labels=False))
    parts["encode (48 planes)"] = lambda: net.preprocess.states_to_tensor(
        state)
    parts["forward (bucket 8)"] = lambda: net.forward(
        net._pad_bucket(planes)[0])
    log("genmove stages [" + ", ".join(
        f"{k} {wall_ms(f, 10):.2f} ms" for k, f in parts.items()) + "]")
    return launches, p50


def phase_timings(pygo, torchgo, dev, card):
    """Kernel, plain and bound times at the main path's shapes (batch
    1 per genmove: one board for labels, ``chase_slots`` lanes for the
    chase) and at batch 8 and 256."""
    from rocalphago_tpu_torch.features.api import Preprocess
    from rocalphago_tpu_torch.ops import chase as C
    from rocalphago_tpu_torch.ops import labels as L

    cfg = torchgo.GoConfig(size=SIZE)
    n = cfg.num_points
    pre = Preprocess(cfg=cfg, device=dev)
    rows = {}
    for batch in (1, 8, 256):
        sts = (ladder_positions(pygo, max(1, batch // 8), SEED + 6)
               + random_positions(pygo, batch - max(1, batch // 8),
                                  (60, 120, 180), SEED + 7 + batch))
        st = torchgo.from_pygo(cfg, sts, device=dev, with_labels=False)
        boards = st.board
        with LaneRecorder(C) as rec:
            pre.states_to_tensor(torchgo.seed_labels(cfg, st))
        cb, cl, cp = rec.lanes[0]

        lab_ms = cuda_ms(lambda: L.labels(boards, SIZE), 200, queued=True)
        lab_wall = wall_ms(lambda: L.labels(boards, SIZE), 200)
        lab_plain = cuda_ms(lambda: L.labels_plain(boards, SIZE), 5)
        sweeps = labels_sweeps(boards)
        lab_bound = bound(boards.numel() * 5,
                          sweeps * boards.numel()
                          * LABELS_OPS_PER_POINT_SWEEP)
        ch_ms = cuda_ms(lambda: C.chase(cb, cl, cp, SIZE), 200, queued=True)
        ch_wall = wall_ms(lambda: C.chase(cb, cl, cp, SIZE), 200)
        ch_plain = cuda_ms(lambda: C.chase_plain(cb, cl, cp, SIZE), 3)
        _, rungs = C.chase_plain(cb, cl, cp, SIZE, return_rungs=True)
        ch_bound = bound(cb.numel() * 5 + cp.numel() * 5,
                         int(rungs.sum()) * n * CHASE_OPS_PER_POINT_RUNG)
        d = int(torch.argmax(rungs))
        deep_ms = cuda_ms(lambda: C.chase(cb[d:d + 1], cl[d:d + 1],
                                          cp[d:d + 1], SIZE), 100,
                          queued=True)
        rows[batch] = dict(labels=(lab_ms, lab_plain, lab_bound),
                           chase=(ch_ms, ch_plain, ch_bound),
                           lanes=len(cp), live=int((cp >= 0).sum()),
                           rungs=int(rungs.sum()))
        log(f"timing batch {batch} [{card}]: labels [{batch},{n}] kernel "
            f"{lab_ms:.4f} ms (host wall per call {lab_wall:.4f} ms), "
            f"plain {lab_plain:.3f} ms, bound "
            f"{lab_bound[0]:.6f} ms ({lab_bound[1]}, {sweeps} sweeps); "
            f"chase {len(cp)} lanes ({rows[batch]['live']} live, "
            f"{rows[batch]['rungs']} rungs) kernel {ch_ms:.4f} ms (host "
            f"wall per call {ch_wall:.4f} ms), plain "
            f"{ch_plain:.3f} ms, bound {ch_bound[0]:.6f} ms "
            f"({ch_bound[1]}); deepest lane {int(rungs[d])} rungs, "
            f"{deep_ms:.4f} ms alone")
    return rows


def searcher(pol, val, n_sim: int, max_nodes=None):
    from rocalphago_tpu_torch.search.device_mcts import make_device_mcts

    return make_device_mcts(pol.cfg, pol.feature_list, val.feature_list,
                            pol.module, val.module, n_sim=n_sim,
                            max_nodes=max_nodes)


def bridged(torchgo, cfg, sts, dev):
    return torchgo.seed_labels(cfg, torchgo.from_pygo(
        cfg, sts, device=dev, with_labels=False))


def phase_batched_search(pygo, torchgo, dev):
    """8 roots searched together give the visits each gets alone: the
    full-width nets in float32 (TF32 off; bfloat16 rounds differently at
    batch 1 and 8, and its ties would be broken by that), 16
    simulations."""
    from rocalphago_tpu_torch.models import CNNPolicy, CNNValue

    pol = CNNPolicy(board=SIZE, layers=12, filters_per_layer=128,
                    seed=SEED, device=dev, dtype=torch.float32)
    val = CNNValue(board=SIZE, layers=12, filters_per_layer=128,
                   seed=SEED + 1, device=dev, dtype=torch.float32)
    search = searcher(pol, val, SEARCH_CHECK_SIMS)
    sts = (random_positions(pygo, 6, (0, 30, 80, 130, 180, 230), SEED + 8)
           + ladder_positions(pygo, 2, SEED + 9))
    together, _ = search(bridged(torchgo, pol.cfg, sts, dev))
    alone = torch.cat([search(bridged(torchgo, pol.cfg, [st], dev))[0]
                       for st in sts])
    torch.cuda.synchronize()
    check(bool((together.sum(1) == SEARCH_CHECK_SIMS).all()),
          f"batched search ran {together.sum(1).tolist()} simulations")
    check(torch.equal(together, alone),
          "a batch of 8 roots searched together differs from each root "
          f"alone in {int((together != alone).any(1).sum())} roots")
    log(f"search: 8 roots at 19x19 full width (fp32), {SEARCH_CHECK_SIMS} "
        "simulations, visits batched == alone on every root "
        f"({int((together > 0).sum())} visited root edges)")


def phase_sync_free(pygo, torchgo, dev, pol, val):
    """One chunk of simulations makes no device→host sync: run under
    ``torch.cuda.set_sync_debug_mode("error")`` at batch 1 and 8, full
    width, bfloat16. Returns the batch-8 tree."""
    search = searcher(pol, val, CHUNK)
    tree = None
    for batch in (1, 8):
        sts = random_positions(pygo, batch, (20, 90, 160, 230),
                               SEED + 10 + batch)
        tree = search.init(bridged(torchgo, pol.cfg, sts, dev))
        search.simulate(tree)        # warm: cached tables, cuDNN
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(CHUNK):
                search.simulate(tree)
        except RuntimeError as e:
            raise SmokeFailure(f"a host sync inside a chunk (batch "
                               f"{batch}): {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        visits, _ = search.root_stats(tree)
        check(bool((visits.sum(1) == CHUNK + 1).all()),
              f"sync-free chunk: visits {visits.sum(1).tolist()}")
    log(f"search: a chunk of {CHUNK} simulations at batch 1 and 8 "
        "(19x19, full width, bf16) ran with no device->host sync")
    return tree


def phase_search_gtp(player, counters):
    """The main path: the device-search player that the GTP player
    factory built from the saved specs, a scripted session at 100
    simulations a move, then moves under ``time_settings 0 1 1`` (the
    deadline armed)."""
    from rocalphago_tpu_torch.interface.gtp import run_gtp, vertex_to_move

    for net in (player.policy, player.value):
        check(net.device.type == "cuda" and net.module.dtype == torch.bfloat16,
              f"the device-search nets run on {net.device} in "
              f"{net.module.dtype}")
    check(player.value.module.head == "fcn" and player.n_sim == 100,
          "the device-search player is not the FCN / 100-playout default")
    setup = ["boardsize 19", "clear_board", "komi 7.5", "play b C4",
             "play w D4", "play b D3", "play w Q16", "play b E3"]
    searched = [f"genmove {'wb'[i % 2]}" for i in range(SEARCH_GENMOVES)]
    timed = [f"genmove {'wb'[i % 2]}" for i in range(TIMED_GENMOVES)]
    script = "\n".join(setup + searched + ["time_settings 0 1 1"] + timed
                       + ["final_score", "quit"]) + "\n"
    runs = []
    inner = player.get_move

    def recorded(state):
        move = inner(state)
        runs.append((player.last_n_sim, player.last_deadline_hit,
                     player.reuses))
        return move

    player.get_move = recorded
    instream, out = Timed(script), io.StringIO()
    for c in counters:
        c.launches = 0
    engine = run_gtp(player, instream, out)
    torch.cuda.synchronize()
    launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
    player.get_move = inner
    replies = [r for r in out.getvalue().split("\n\n") if r.strip()]
    cmds = setup + searched + ["time_settings 0 1 1"] + timed
    check(len(replies) == len(cmds) + 2,
          f"{len(replies)} replies to {len(cmds) + 2} commands")
    for cmd, reply in zip(cmds, replies):
        check(reply.startswith("="), f"{cmd!r} -> {reply!r}")
        if cmd.startswith("genmove"):
            check(vertex_to_move(reply[1:].strip(), SIZE) is not None,
                  f"genmove passed: {reply!r}")
    check(engine.illegal_from_player == 0,
          f"illegal_from_player = {engine.illegal_from_player}")
    for name, n in launches.items():
        check(n > 0, f"the {name} kernel was not launched by the "
              "device-search genmoves")
    check([r[0] for r in runs[:SEARCH_GENMOVES]] == [100] * SEARCH_GENMOVES,
          f"simulations per searched move: {[r[0] for r in runs]}")
    stamps = instream.stamps
    g0 = len(setup)
    lat = [stamps[i + 1] - stamps[i] for i in range(g0, g0 + SEARCH_GENMOVES)]
    p50 = sorted(lat)[len(lat) // 2] * 1e3
    # the first search pays the value net's first launches; the rate
    # is over the others
    sims_per_s = (sum(r[0] for r in runs[1:SEARCH_GENMOVES])
                  / sum(lat[1:]))
    t0 = g0 + SEARCH_GENMOVES + 1
    tlat = [stamps[i + 1] - stamps[i] for i in range(t0, t0 + TIMED_GENMOVES)]
    log(f"device-search gtp: {SEARCH_GENMOVES} genmoves at 100 simulations "
        f"on the 19x19 12x128 bf16 policy and FCN value nets, all legal "
        f"vertices; launches {launches}; genmove p50 {p50:.1f} ms (each "
        f"{[round(x * 1e3, 1) for x in lat]} ms), {sims_per_s:.1f} "
        f"simulations/s; reuses {runs[SEARCH_GENMOVES - 1][2]}")
    log(f"device-search gtp under time_settings 0 1 1: simulations "
        f"{[r[0] for r in runs[SEARCH_GENMOVES:]]}, deadline hit "
        f"{[r[1] for r in runs[SEARCH_GENMOVES:]]}, genmove ms "
        f"{[round(x * 1e3, 1) for x in tlat]}")
    return dict(launches=launches, p50=p50, sims_per_s=sims_per_s,
                player=player, state=engine.state)


def sim_stages(torchgo, search, tree, reps: int):
    """Host milliseconds of each stage of a simulation, synchronised
    after every stage (the stages of ``DeviceMCTS.simulate``)."""
    from rocalphago_tpu_torch.ops import tree as T
    from rocalphago_tpu_torch.search import device_mcts as D
    from rocalphago_tpu_torch.features.planes import encode
    from rocalphago_tpu_torch.search.selfplay import sensible_mask

    cfg = search.cfg
    free = torch.full_like(tree.n_nodes, -1)
    sums: dict = {}

    def lap(name, t):
        torch.cuda.synchronize()
        now = time.perf_counter()
        sums[name] = sums.get(name, 0.0) + (now - t) * 1e3
        return now

    with torch.no_grad():
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            node, action = T.descend(tree.prior, tree.visits,
                                     tree.value_sum, tree.child,
                                     tree.states.done, tree.root, free,
                                     search.c_puct)
            t = lap("descend (tree kernel)", t)
            parent = D._state_at(tree.states, node)
            safe = torch.where(action >= 0, action, cfg.num_points)
            stepped = torchgo.step(cfg, parent, safe)
            expanding = action >= 0
            leaf = torchgo.where_rows(expanding, stepped, parent)
            t = lap("step", t)
            gd = torchgo.group_data(cfg, leaf.board, labels=leaf.labels)
            planes = encode(cfg, leaf, search.value_features, gd=gd)
            sens = sensible_mask(cfg, leaf, gd)
            t = lap("analysis + encode (chase kernel)", t)
            logits = search.policy_fn(planes[..., :search.n_policy_planes])
            masked = torch.where(sens, logits,
                                 torch.finfo(logits.dtype).min)
            board_p = torch.softmax(masked, dim=-1)
            t = lap("policy forward + softmax", t)
            values = search.value_fn(planes).float()
            t = lap("value forward", t)
            term = D._terminal_value(cfg, leaf)
            t = lap("terminal scoring (labels kernel)", t)
            any_sens = sens.any(dim=-1, keepdim=True)
            priors = torch.cat([torch.where(any_sens, board_p, 0.0),
                                torch.where(any_sens, 0.0, 1.0)], -1)
            values = torch.where(leaf.done, term, values)
            search.apply_sim(tree, D.SimStep(node, safe.int(), expanding,
                                             leaf), priors, values)
            lap("apply + backup (tree kernel)", t)
    return {k: v / reps for k, v in sums.items()}


def check_tree_walks(tree, c_puct: float, what: str, forced_k: float = 0.0):
    """One descent of ``tree`` and one backup of the path it found,
    through the tree kernel and through its plain versions on the same
    card tensors: node, action and both backed-up slabs bit-exact.
    Returns the descent's arguments, the backup's (on copies of the
    slabs) and the node reached."""
    from rocalphago_tpu_torch.ops import tree as T

    b = tree.prior.shape[0]
    free = torch.full_like(tree.n_nodes, -1)
    args = (tree.prior, tree.visits, tree.value_sum, tree.child,
            tree.states.done, tree.root, free, c_puct, forced_k)
    node, action = T.descend(*args)
    want = T.descend_plain(*args)
    check(torch.equal(node, want[0]) and torch.equal(action, want[1]),
          f"tree descend differs from plain on {what}")
    ar = torch.arange(b, device=node.device)
    start = torch.where(action >= 0, node,
                        tree.parent[ar, node.long()]).contiguous()
    start_a = torch.where(action >= 0, action,
                          tree.paction[ar, node.long()]).contiguous()
    values = torch.linspace(-1, 1, b, dtype=torch.float32,
                            device=node.device)
    back = (tree.visits.clone(), tree.value_sum.clone(), tree.parent,
            tree.paction, start, start_a, values)
    plain = (tree.visits.clone(), tree.value_sum.clone()) + back[2:]
    T.backup(*back)
    T.backup_plain(*plain)
    check(torch.equal(back[0], plain[0]) and torch.equal(back[1], plain[1]),
          f"tree backup differs from plain on {what}")
    return args, back, node


def tree_timing(tree, c_puct: float, what: str, forced_k: float = 0.0):
    """(kernel ms, plain ms, (bound ms, by), levels) of one descent and
    one backup of the path it found, on the card, for a tree (checked
    against the plain versions first)."""
    from rocalphago_tpu_torch.ops import tree as T

    b, _, a = tree.prior.shape
    args, back, node = check_tree_walks(tree, c_puct, what, forced_k)
    ms = (cuda_ms(lambda: T.descend(*args), 200, queued=True)
          + cuda_ms(lambda: T.backup(*back), 200, queued=True))
    plain = (cuda_ms(lambda: T.descend_plain(*args), 5)
             + cuda_ms(lambda: T.backup_plain(*back), 5))
    levels = tree_levels(tree.parent, tree.root, node)
    # descend: each level reads one node's prior, visits and value_sum
    # rows, its child pointer and done flag; backup: each level reads
    # and writes one visit count and value sum and reads parent/paction
    bytes_moved = int(levels.sum()) * (a * 12 + 5 + 16 + 8) + b * 24
    return ms, plain, bound(bytes_moved, int(levels.sum()) * a * 12), levels


def phase_search_timings(torchgo, dev, card, main, tree8):
    """Where a device-search move's time goes: the stages of a
    simulation at the main path's shape (one game), the kernel count and
    device time of a chunk (profiler), and the tree kernel's time beside
    its bound at batch 1 and 8."""
    player, state = main["player"], main["state"]
    cfg, search = player._searcher_for(float(state.komi))
    tree = search.init(bridged(torchgo, cfg, [state], dev))
    for _ in range(24):
        search.simulate(tree)
    stages = sim_stages(torchgo, search, tree, 16)
    log(f"simulation stages at batch 1 [{card}], host ms with a sync after "
        "each: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; sum {sum(stages.values()):.2f} ms")
    prof = profile_device(lambda: search.simulate(tree), CHUNK,
                          f"one chunk of {CHUNK} simulations at batch 1",
                          "simulation")
    # the tree the GTP session's last search left (subtree reuse
    # carries it), at the shape the session launched the kernel on
    carried = player._carry[3]
    check_tree_walks(carried, search.c_puct, "the GTP session's tree")
    tree_ms, tree_plain, tree_bound, levels = tree_timing(
        tree, search.c_puct, "the main path's slab")
    t8 = tree_timing(tree8, search.c_puct, "the batch-8 chunk's tree")
    log(f"tree kernel: descend and backup bit-exact vs plain on the GTP "
        f"session's tree ({int(carried.n_nodes.sum())} of "
        f"{carried.prior.shape[1]} nodes) and the trees timed below")
    log(f"tree kernel [{card}]: batch 1 ({int(tree.n_nodes.sum())} nodes, "
        f"{int(levels.sum())} levels) descend + backup {tree_ms:.4f} ms, "
        f"plain {tree_plain:.3f} ms, bound {tree_bound[0]:.6f} ms "
        f"({tree_bound[1]}); batch 8 ({int(t8[3].sum())} levels) "
        f"{t8[0]:.4f} ms, plain {t8[1]:.3f} ms, bound {t8[2][0]:.6f} ms")
    return dict(stages=stages, profile=prof,
                tree=(tree_ms, tree_plain, tree_bound))


def profile_device(step_fn, units: int, what: str, unit: str):
    """Kernel launches and device busy time per ``unit`` over ``units``
    calls of ``step_fn``, from ``torch.profiler``; None where the trace
    shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            step_fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3
    if not kernels or busy <= 0:
        log("profiler: no device time in the trace; launches not measured")
        return None
    out = dict(launches=len(kernels) / units, busy_ms=busy / units,
               wall_ms=wall / units)
    out["idle"] = 1 - out["busy_ms"] / out["wall_ms"]
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    log(f"profiler, {what}: {out['launches']:.0f} kernels per {unit}, "
        f"device busy {out['busy_ms']:.3f} of {out['wall_ms']:.2f} ms "
        f"(idle share {out['idle']:.3f}, the profiler on); top: "
        + ", ".join(f"{e.key[:40]} x{e.count // units} "
                    f"{e.device_time_total / 1e3 / units:.3f} ms"
                    for e in top[:6]))
    return out


# ------------------------------------------------------------ self-play


def ply_stages(torchgo, ply, states, t: int, generator, reps: int):
    """Host milliseconds of each stage of one self-play ply (the stages
    of ``Ply.__call__``), synchronised after every stage."""
    from rocalphago_tpu_torch.features.planes import encode
    from rocalphago_tpu_torch.search import selfplay as S

    cfg = ply.cfg
    sums: dict = {}

    def lap(name, t0):
        torch.cuda.synchronize()
        now = time.perf_counter()
        sums[name] = sums.get(name, 0.0) + (now - t0) * 1e3
        return now

    swap = t % 2 == 1
    half = ply.batch // 2
    with torch.no_grad():
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gd = torchgo.group_data(cfg, states.board, labels=states.labels)
            t0 = lap("analysis", t0)
            planes = encode(cfg, states, ply.features, gd=gd)
            t0 = lap("encode (chase kernel)", t0)
            rolled = S._half_swap(planes, swap)
            logits = S._half_swap(torch.cat(
                [ply.policy_a(rolled[:half]), ply.policy_b(rolled[half:])]),
                swap)
            t0 = lap("two forwards", t0)
            sens = S.sensible_mask(cfg, states, gd)
            masked = torch.where(sens, logits / ply.temperature,
                                 torch.finfo(logits.dtype).min)
            action = ply.sample(masked, sens, generator)
            t0 = lap("mask + sample", t0)
            ply.advance(states, action, gd)
            lap("step", t0)
    return {k: v / reps for k, v in sums.items()}


def replay_on_cpu(torchgo, cfg, features, actions, live, played):
    """Replay a card run's actions ``[T, B]`` on the CPU port (plain
    versions): every action of a ply the card played (``played[t]``;
    the rest are the zero padding after every game ended) sensible
    there, the same ``live`` rows. Returns the CPU's final states."""
    from rocalphago_tpu_torch.search import selfplay as S

    n = cfg.num_points
    b = actions.shape[1]
    ply = S.Ply(cfg, features, None, None, b, 1.0)
    st = torchgo.new_states(cfg, b, device="cpu")
    for t in range(actions.shape[0]):
        gd = torchgo.group_data(cfg, st.board, labels=st.labels)
        sens = S.sensible_mask(cfg, st, gd)
        a = actions[t]
        at = sens.gather(1, a.clamp(max=n - 1).long()[:, None])[:, 0]
        ok = torch.where(a < n, at, ~sens.any(dim=1))
        check(not played[t] or bool(ok.all()),
              f"replay ply {t}: a card action is not sensible on the CPU")
        st, lv = ply.advance(st, a, gd)
        check(torch.equal(lv, live[t]), f"replay ply {t}: live differs")
    return st


def kernel_row(fn, plain_fn, bytes_moved, ops, reps: int = 100):
    """(kernel ms, plain ms, (bound ms, by)) of one kernel call on the
    card, CUDA events around back-to-back launches."""
    return (cuda_ms(fn, reps, queued=True), cuda_ms(plain_fn, 3),
            bound(bytes_moved, ops))


def phase_policy_selfplay(torchgo, dev, card, counters):
    """Policy self-play at full width, this slice's headline: 19×19,
    two fresh 12 × 128 bf16 policies, batch 256, up to 300 plies in
    segments of 10, stopping when every game is over. One untimed run of
    a segment, one segment with no device→host sync, then the timed
    run, its first games replayed on the CPU, its winners scored on the
    host, the chase and labels kernels held against their plain
    versions on its lanes and region boards, a stage breakdown and a
    profile of a ply."""
    from rocalphago_tpu_torch.features import DEFAULT_FEATURES
    from rocalphago_tpu_torch.models import CNNPolicy
    from rocalphago_tpu_torch.ops import chase as C
    from rocalphago_tpu_torch.ops import labels as L
    from rocalphago_tpu_torch.runtime.pipeline import ChunkPipeline
    from rocalphago_tpu_torch.search import selfplay as S

    cfg = torchgo.GoConfig(size=SIZE)
    n = cfg.num_points
    nets = [CNNPolicy(board=SIZE, layers=12, filters_per_layer=128,
                      seed=SEED + 20 + i, device=dev) for i in range(2)]
    for net in nets:
        check(net.device.type == "cuda"
              and net.module.dtype == torch.bfloat16,
              f"a self-play net runs on {net.device} in {net.module.dtype}")
    args = (cfg, DEFAULT_FEATURES, nets[0].module, nets[1].module, SP_BATCH)
    gen = torch.Generator(device=dev)
    warm = S.make_selfplay_chunked(*args, max_moves=SP_CHUNK,
                                   chunk=SP_CHUNK, device=dev)(
        gen.manual_seed(SEED))
    torch.cuda.synchronize()
    run = S.make_selfplay_chunked(*args, max_moves=SP_MAX_MOVES,
                                  chunk=SP_CHUNK, device=dev)

    # one segment with no device->host sync, on the warm run's games
    states = warm.final
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(SP_CHUNK, 2 * SP_CHUNK):
            states, _, _ = run.ply(states, gen, t)
    except RuntimeError as e:
        raise SmokeFailure(f"a host sync inside a self-play segment: "
                           f"{e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"policy self-play: a segment of {SP_CHUNK} plies at batch "
        f"{SP_BATCH} ran with no device->host sync")

    # the timed run: the path's launches counted from zero
    pipe = ChunkPipeline(dev)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    res = run(gen.manual_seed(SEED + 1), stop_when_done=True, pipeline=pipe)
    winners = res.winners.cpu()
    wall = time.perf_counter() - t0
    launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
    num_moves = res.num_moves.cpu()
    check(res.actions.shape == (SP_MAX_MOVES, SP_BATCH),
          f"self-play actions {tuple(res.actions.shape)}")
    for name, k in launches.items():
        check(k > 0, f"the {name} kernel was not launched by self-play")
    games_per_min = SP_BATCH * 60.0 / wall
    board_plies = int(num_moves.sum())
    plies_run = int(res.live.any(dim=1).sum())
    log(f"policy self-play [{card}]: {SP_BATCH} games, 19x19 12x128 bf16, "
        f"{plies_run} plies in {wall:.2f} s: selfplay_19x19_games_per_min "
        f"(the port's) {games_per_min:.2f}, {board_plies / wall:.1f} "
        f"board-plies/s, {plies_run / wall:.2f} plies/s, mean game "
        f"{float(num_moves.float().mean()):.1f} plies "
        f"({int(res.final.done.sum())} of {SP_BATCH} games over), "
        f"host_gap_frac {pipe.host_gap_frac:.4f}; launches {launches}")

    # the card's result, replayed on the CPU and scored on the host
    cpu = replay_on_cpu(torchgo, cfg, DEFAULT_FEATURES,
                        res.actions[:, :SP_REPLAY].cpu(),
                        res.live[:, :SP_REPLAY].cpu(),
                        res.live.any(dim=1).tolist())
    for name in ("board", "done", "turn", "labels"):
        check(torch.equal(getattr(res.final, name)[:SP_REPLAY].cpu(),
                          getattr(cpu, name)),
              f"replayed games: {name} differs from the card's")
    check(torch.equal(winners[:SP_REPLAY], torchgo.winner(cfg, cpu)),
          "replayed games: winners differ")
    host = S.host_winners(cfg, res.final.board)
    check(np.array_equal(host, winners.numpy()),
          f"winner on the card differs from host_winners in "
          f"{int((host != winners.numpy()).sum())} games")
    log(f"policy self-play: the first {SP_REPLAY} games replayed on the CPU "
        "(every action sensible there; the live rows, so num_moves, and "
        f"boards, done flags and winners equal); winners of all {SP_BATCH} "
        "== host_winners")

    # the kernels at this path's shapes: lanes of a real batch-256 encode
    # and the final boards' empty regions
    final = res.final
    with LaneRecorder(C) as rec:
        run.ply.logits(final, plies_run)
    cb, cl, cp = rec.lanes[0]
    want_c = check_chase(C, cb, cl, cp, SIZE, f"self-play {len(cp)} lanes")
    _, rungs = C.chase_plain(cb, cl, cp, SIZE, return_rungs=True)
    chase_row = kernel_row(
        lambda: C.chase(cb, cl, cp, SIZE), lambda: C.chase_plain(
            cb, cl, cp, SIZE), cb.numel() * 5 + cp.numel() * 5,
        int(rungs.sum()) * n * CHASE_OPS_PER_POINT_RUNG)
    regions = torch.where(final.board == 0, 9, 0).to(torch.int8)
    check(torch.equal(L.labels(regions, SIZE), L.labels_plain(regions, SIZE)),
          "labels kernel differs from plain on the self-play regions")
    labels_row = kernel_row(
        lambda: L.labels(regions, SIZE), lambda: L.labels_plain(
            regions, SIZE), regions.numel() * 5,
        labels_sweeps(regions) * regions.numel()
        * LABELS_OPS_PER_POINT_SWEEP)
    log(f"self-play kernels [{card}]: chase {len(cp)} lanes "
        f"({int((cp >= 0).sum())} live, {int(want_c.sum())} captured, "
        f"{int(rungs.sum())} rungs) bit-exact, {chase_row[0]:.4f} ms, plain "
        f"{chase_row[1]:.3f} ms, bound {chase_row[2][0]:.6f} ms "
        f"({chase_row[2][1]}); labels on {SP_BATCH} region boards "
        f"bit-exact, {labels_row[0]:.4f} ms, plain {labels_row[1]:.3f} ms, "
        f"bound {labels_row[2][0]:.6f} ms ({labels_row[2][1]})")

    stages = ply_stages(torchgo, run.ply, final, plies_run, gen, 3)
    log(f"self-play ply stages at batch {SP_BATCH} [{card}], host ms with a "
        "sync after each: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in stages.items())
        + f"; sum {sum(stages.values()):.2f} ms")
    holder = [final, plies_run]

    def one_ply():
        holder[0], _, _ = run.ply(holder[0], gen, holder[1])
        holder[1] += 1

    prof = profile_device(one_ply, SP_CHUNK,
                          f"a segment of {SP_CHUNK} plies at batch "
                          f"{SP_BATCH}", "ply")
    return dict(launches=launches, games_per_min=games_per_min,
                wall=wall, final=final, stages=stages, profile=prof,
                chase=chase_row, labels=labels_row)


def phase_search_selfplay(torchgo, dev, card, counters, player, states256):
    """Search self-play: the full-width policy and FCN value nets the
    device-search player loaded, batch 8, 32 simulations a move in
    chunks of 8, Dirichlet root noise, forced playouts, recorded
    targets, 8 plies. Then the tree kernel with forced playouts against
    its plain version on a grown batch-8 slab and on a batch-256 slab
    grown from the policy self-play's positions, both timed."""
    from rocalphago_tpu_torch.search.device_mcts import (
        make_device_mcts,
        make_mcts_selfplay,
    )

    pol, val = player.policy, player.value
    cfg = pol.cfg
    run = make_mcts_selfplay(
        cfg, pol.feature_list, val.feature_list, pol.module, val.module,
        batch=SS_BATCH, max_moves=SS_PLIES, n_sim=SS_SIMS, sim_chunk=CHUNK,
        record_visits=True, dirichlet_alpha=SS_ALPHA, noise_frac=SS_EPS,
        forced_k=SS_FORCED_K, device=dev)
    # untimed: the searcher's first launches
    run.search_ply(torchgo.new_states(cfg, SS_BATCH, device=dev))
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    t0 = time.perf_counter()
    final, actions, live, targets = run(gen, np.random.default_rng(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
    for name, k in launches.items():
        check(k > 0, f"the {name} kernel was not launched by search "
              "self-play")
    plies = actions.shape[0]
    check(plies == SS_PLIES and targets.shape == (
        SS_PLIES, SS_BATCH, cfg.num_points + 1)
        and targets.dtype == torch.float32,
        f"search self-play: {plies} plies, targets "
        f"{tuple(targets.shape)} {targets.dtype}")
    sums = targets.sum(-1)[live]
    check(bool(((sums - 1).abs() < 1e-5).all()),
          f"a recorded target does not sum to 1: {sums.tolist()}")
    log(f"search self-play [{card}]: batch {SS_BATCH}, {SS_SIMS} "
        f"simulations a move, forced_k {SS_FORCED_K}, Dir({SS_ALPHA}) "
        f"eps {SS_EPS}, {plies} plies in {wall:.2f} s: "
        f"{plies / wall:.3f} plies/s, {plies * SS_SIMS / wall:.1f} "
        f"simulations/s ({plies * SS_SIMS * SS_BATCH / wall:.1f} game "
        f"simulations/s); every target sums to 1; launches {launches}")

    # the tree kernel with forced playouts on grown slabs
    gamma = torch.as_tensor(np.random.default_rng(SEED + 3).gamma(
        SS_ALPHA, size=(SS_BATCH, cfg.num_points + 1)),
        dtype=torch.float32).to(dev)
    tree8 = run.add_root_noise(run.search.init(final), gamma)
    tree8, _ = run.search.run_sims_chunked(tree8, CHUNK, owned=True)
    t8 = tree_timing(tree8, run.search.c_puct, "a batch-8 self-play slab",
                     SS_FORCED_K)
    search256 = make_device_mcts(
        cfg, pol.feature_list, val.feature_list, pol.module, val.module,
        n_sim=SS_TREE256_SIMS, forced_k=SS_FORCED_K)
    tree256 = search256.init(states256)
    tree256, _ = search256.run_sims_chunked(tree256, CHUNK, owned=True)
    t256 = tree_timing(tree256, search256.c_puct,
                       "a batch-256 self-play slab", SS_FORCED_K)
    p256 = tree_timing(tree256, search256.c_puct,
                       "a batch-256 self-play slab, plain PUCT")
    log(f"tree kernel, forced_k {SS_FORCED_K} [{card}]: bit-exact vs plain; "
        f"batch 8 ({int(tree8.n_nodes.sum())} nodes, {int(t8[3].sum())} "
        f"levels) descend + backup {t8[0]:.4f} ms, plain {t8[1]:.3f} ms, "
        f"bound {t8[2][0]:.6f} ms; batch 256 ({int(tree256.n_nodes.sum())} "
        f"nodes, {int(t256[3].sum())} levels) {t256[0]:.4f} ms, plain "
        f"{t256[1]:.3f} ms, bound {t256[2][0]:.6f} ms ({t256[2][1]}); "
        f"the same slab with forced_k 0 ({int(p256[3].sum())} levels) "
        f"{p256[0]:.4f} ms, plain {p256[1]:.3f} ms, bound "
        f"{p256[2][0]:.6f} ms")
    return dict(launches=launches, wall=wall, plies=plies,
                tree8=t8[:3], tree256=t256[:3])


def phase_selfplay_cli(pygo):
    """The self-play CLI as a user runs it, on the committed 9×9 nets:
    policy mode and search mode, into ``build/``; every SGF parses back
    with the port's reader and replays legally on the rules oracle."""
    from rocalphago_tpu_torch.data import sgf

    root = os.path.dirname(os.path.abspath(__file__))
    policy = os.path.join(root, PUCT_DIR, "policy.json")
    value = os.path.join(root, PUCT_DIR, "value.json")
    for mode, games, extra in (
            ("policy", 16, ["--chunk", "20"]),
            ("search", 4, ["--search-sims", "16", "--value", value,
                           "--max-moves", "20", "--dirichlet-alpha",
                           "0.03"])):
        out = os.path.join(root, "build", "smoke_selfplay", mode)
        shutil.rmtree(out, ignore_errors=True)
        cmd = [sys.executable, "-m",
               "rocalphago_tpu_torch.interface.selfplay_cli", "--policy",
               policy, "--games", str(games), "--out", out, "--seed",
               str(SEED)] + extra
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=CLI_TIMEOUT_S)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"selfplay_cli ({mode}) exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        check(summary["sgf_files"] == games,
              f"selfplay_cli ({mode}) wrote {summary.get('sgf_files')} SGFs")
        lengths = []
        for g in range(games):
            with open(os.path.join(out, f"selfplay-{g:05d}.sgf")) as f:
                game = sgf.parse(f.read())
            st = pygo.GameState(size=game.size, komi=game.komi)
            for color, move in game.moves:
                check(st.is_legal(move), f"selfplay_cli ({mode}) game {g}: "
                      f"illegal {move}")
                st.do_move(move, color)
            lengths.append(len(game.moves))
        check(float(np.mean(lengths)) == summary["mean_moves"],
              f"selfplay_cli ({mode}): SGF lengths {lengths} against "
              f"mean_moves {summary['mean_moves']}")
        log(f"selfplay_cli {mode}: {summary} ({wall:.1f} s with start-up); "
            f"every SGF parses and replays legally")


# ------------------------------------------------------ supervised path


def sl_argv(spec, corpus, out, epochs=2, *extra):
    """The SL trainer's command line for this phase's runs (minibatch
    16, symmetries on: the reference's defaults)."""
    return [spec, corpus, out, "--epoch-length", str(SL_EPOCH_LENGTH),
            "--epochs", str(epochs), "--seed", str(SEED), *extra]


def final_params(out: str, step: int) -> dict:
    """The params of ``out``'s checkpoint at ``step``."""
    path = os.path.join(out, "checkpoints", str(step), "state.pt")
    return torch.load(path, map_location="cpu", weights_only=True)["params"]


def same_params(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def sl_convert(root: str, work: str, counters):
    """The converter CLI on the committed 19×19 games, the launches of
    both kernels counted from zero; its first games converted again by
    the CPU port, bit for bit."""
    from rocalphago_tpu_torch.data import convert, sgf
    from rocalphago_tpu_torch.data.pipeline import ShardedDataset

    games = os.path.join(root, SL_GAMES)
    files = sorted(f for f in os.listdir(games) if f.endswith(".sgf"))
    moves = non_pass = 0
    for f in files:
        with open(os.path.join(games, f)) as fh:
            g = sgf.parse(fh.read())
        moves += len(g.moves)
        non_pass += sum(m is not None for _, m in g.moves)
    corpus = os.path.join(work, "corpus")
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    out = convert.run_game_converter(["--directory", games, "--outfile",
                                      corpus])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
    with open(f"{corpus}-manifest.json") as f:
        manifest = json.load(f)
    check(manifest["num_games"] == len(files) and not manifest["errors"],
          f"converted {manifest['num_games']} of {len(files)} games: "
          f"{manifest['errors']}")
    check(manifest["num_positions"] == non_pass == out["num_positions"],
          f"{manifest['num_positions']} positions from {non_pass} non-pass "
          "moves")
    check(manifest["planes"] == 48 and manifest["board_size"] == SIZE,
          f"manifest {manifest['planes']} planes at {manifest['board_size']}")
    for name, k in launches.items():
        check(k > 0, f"the {name} kernel was not launched by the converter")
    log(f"convert: {len(files)} games, {moves} moves ({moves - non_pass} "
        f"passes), {manifest['num_positions']} positions in "
        f"{manifest['num_shards']} shards, {wall:.2f} s with the shard "
        f"writes, {manifest['num_positions'] / wall:.1f} positions/s; "
        f"launches {launches}")

    cpu = convert.GameConverter(device="cpu")
    ds = ShardedDataset(corpus)
    row = 0
    t0 = time.perf_counter()
    for f in files[:SL_CPU_GAMES]:
        with open(os.path.join(games, f)) as fh:
            states, actions = cpu.convert_game(fh.read())
        got = ds.gather(np.arange(row, row + len(actions)))
        check(np.array_equal(got[0], states) and np.array_equal(
            got[1], actions), f"{f}: the card's planes differ from the CPU's")
        row += len(actions)
    log(f"convert: the first {SL_CPU_GAMES} games ({row} positions) "
        f"converted on the CPU equal the card's bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")
    sl_kernels(games, files[0])
    return corpus, launches, manifest["num_positions"] / wall


def sl_kernels(games: str, first: str):
    """Both kernels at the converter's shapes: the boards and the lanes
    of the first encode batch of the first game (256 positions, 4 chase
    slots each), against their plain versions and timed."""
    from rocalphago_tpu_torch.data import convert
    from rocalphago_tpu_torch.ops import chase as C
    from rocalphago_tpu_torch.ops import labels as L

    boards, inner = [], L.labels

    def record(b, size):
        boards.append(b.clone())
        return inner(b, size)

    L.labels = record
    try:
        with LaneRecorder(C) as rec, open(os.path.join(games, first)) as f:
            convert.GameConverter().convert_game(f.read())
    finally:
        L.labels = inner
    b = boards[0]
    n = b.shape[1]
    check(torch.equal(L.labels(b, SIZE), L.labels_plain(b, SIZE)),
          "labels kernel differs from plain on the converter's boards")
    lab = kernel_row(lambda: L.labels(b, SIZE),
                     lambda: L.labels_plain(b, SIZE), b.numel() * 5,
                     labels_sweeps(b) * b.numel()
                     * LABELS_OPS_PER_POINT_SWEEP)
    cb, cl, cp = rec.lanes[0]
    want = check_chase(C, cb, cl, cp, SIZE, f"converter {len(cp)} lanes")
    _, rungs = C.chase_plain(cb, cl, cp, SIZE, return_rungs=True)
    ch = kernel_row(lambda: C.chase(cb, cl, cp, SIZE),
                    lambda: C.chase_plain(cb, cl, cp, SIZE),
                    cb.numel() * 5 + cp.numel() * 5,
                    int(rungs.sum()) * n * CHASE_OPS_PER_POINT_RUNG)
    log(f"converter kernels: labels on {b.shape[0]} boards bit-exact, "
        f"{lab[0]:.4f} ms, plain {lab[1]:.3f} ms, bound {lab[2][0]:.6f} ms "
        f"({lab[2][1]}); chase {len(cp)} lanes ({int((cp >= 0).sum())} "
        f"live, {int(want.sum())} captured, {int(rungs.sum())} rungs) "
        f"bit-exact, {ch[0]:.4f} ms, plain {ch[1]:.3f} ms, bound "
        f"{ch[2][0]:.6f} ms ({ch[2][1]})")


def sl_train(dev, work: str, corpus: str):
    """The SL trainer's CLI at full width, then its export answering a
    GTP genmove; returns the spec and the straight run's directory."""
    from rocalphago_tpu_torch.interface.gtp import run_gtp, vertex_to_move
    from rocalphago_tpu_torch.models import CNNPolicy
    from rocalphago_tpu_torch.search.players import build_player
    from rocalphago_tpu_torch.training import sl

    spec = os.path.join(work, "policy.json")
    CNNPolicy(board=SIZE, layers=12, filters_per_layer=128, seed=SEED + 40,
              device=dev).save_model(spec)
    out = os.path.join(work, "straight")
    t0 = time.perf_counter()
    sl.run_training(sl_argv(spec, corpus, out))
    wall = time.perf_counter() - t0
    check(torch.backends.cudnn.deterministic
          and not torch.backends.cudnn.benchmark,
          "the trainer left cuDNN non-deterministic")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    epochs = [e for e in events if e["event"] == "epoch"]
    check(len(epochs) == 2, f"{len(epochs)} epoch records")
    for e in epochs:
        for k in ("train_loss", "val_loss", "train_accuracy"):
            check(e.get(k) is not None and np.isfinite(e[k]),
                  f"epoch {e['epoch']}: {k} = {e.get(k)}")
    for name in ("metadata.json", "metrics.jsonl", "shuffle.npz",
                 "model.json", "weights.00000.flax.msgpack",
                 "weights.00001.flax.msgpack"):
        check(os.path.exists(os.path.join(out, name)), f"no {name}")
    with open(os.path.join(out, "metadata.json")) as f:
        meta = json.load(f)
    check(np.isfinite(meta["test_accuracy"]), "no test accuracy")
    log(f"sl: {2 * SL_EPOCH_LENGTH} steps at minibatch 16 on the 19x19 "
        f"12x128 bf16 policy, symmetries on, {wall:.1f} s with two "
        f"validations; train loss {epochs[0]['train_loss']:.4f} -> "
        f"{epochs[1]['train_loss']:.4f}, val accuracy "
        f"{epochs[1]['val_accuracy']:.4f}, test accuracy "
        f"{meta['test_accuracy']:.4f}, {epochs[1]['positions_per_s']:.1f} "
        f"positions/s in the loop")

    player = build_player("greedy", os.path.join(out, "model.json"))
    check(player.policy.device.type == "cuda", "the export loads off the card")
    replies = io.StringIO()
    engine = run_gtp(player, io.StringIO(
        "boardsize 19\nclear_board\nplay b D4\ngenmove w\ngenmove b\nquit\n"),
        replies)
    answers = [r for r in replies.getvalue().split("\n\n") if r.strip()]
    for reply in answers[3:5]:
        check(reply.startswith("=") and vertex_to_move(
            reply[1:].strip(), SIZE) is not None, f"genmove -> {reply!r}")
    check(engine.illegal_from_player == 0, "the export played illegally")
    log(f"sl: the exported model.json answers genmove over GTP: "
        f"{answers[3][1:].strip()}, {answers[4][1:].strip()}")
    return spec, out, meta


def sl_resume(work: str, spec: str, corpus: str, straight: str):
    """Exact resume on the card: killed after epoch 0, and killed after
    step 25 with a checkpoint every 10, both resumed through the CLI and
    ending on the straight run's bits."""
    from rocalphago_tpu_torch.training import sl

    end = 2 * SL_EPOCH_LENGTH
    want = final_params(straight, end)
    out = os.path.join(work, "killed_epoch")
    sl.run_training(sl_argv(spec, corpus, out, 1))
    sl.run_training(sl_argv(spec, corpus, out))
    check(same_params(want, final_params(out, end)),
          "killed after epoch 0 and resumed: params differ from the "
          "straight run's")

    out = os.path.join(work, "killed_step")
    cfg = sl.SLConfig(model_json=spec, train_data=corpus, out_dir=out,
                      epochs=2, epoch_length=SL_EPOCH_LENGTH, seed=SEED,
                      save_every=10)
    trainer = sl.SLTrainer(cfg)
    step, calls = trainer._train_step, [0]

    def killing_step(state, planes, actions):
        if calls[0] == SL_KILL_AFTER:
            raise KeyboardInterrupt("killed")
        calls[0] += 1
        return step(state, planes, actions)

    trainer._train_step = killing_step
    try:
        trainer.run()
        check(False, "the killed run did not stop")
    except KeyboardInterrupt:
        pass
    check(trainer.ckpt.latest_step() == 20,
          f"latest checkpoint {trainer.ckpt.latest_step()} after the kill")
    del trainer
    sl.run_training(sl_argv(spec, corpus, out, 2, "--save-every", "10"))
    check(same_params(want, final_params(out, end)),
          f"killed after step {SL_KILL_AFTER} and resumed: params differ "
          "from the straight run's")
    log(f"sl resume: killed after epoch 0, and after step {SL_KILL_AFTER} "
        "with a checkpoint every 10 steps; both resumed runs end on the "
        "straight run's params bit for bit")


def sl_evaluate(corpus: str, straight: str, meta: dict):
    """The evaluator's CLI on the straight run's export and test split;
    at the trainer's minibatch, so both forwards see the same batch
    shapes (cuDNN picks its algorithm per shape; in bf16 another
    summation order can flip a near-tied argmax)."""
    from rocalphago_tpu_torch.training import evaluate

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        evaluate.main([os.path.join(straight, "model.json"), corpus,
                       "--split", "test", "--shuffle-npz",
                       os.path.join(straight, "shuffle.npz"),
                       "--minibatch", "16"])
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    err = abs(res["top1"] - meta["test_accuracy"])
    check(err <= 1e-6, f"evaluate top1 {res['top1']} against the trainer's "
          f"test_accuracy {meta['test_accuracy']}")
    log(f"evaluate: top1 {res['top1']:.6f} on {res['positions']} test "
        f"positions, the trainer's test_accuracy to {err:.1e}")


def sl_value(dev, work: str):
    """The value trainer's CLI at full width on a seeded outcome corpus
    in the converter's layout, its export, and the evaluator's MSE."""
    from rocalphago_tpu_torch.features import VALUE_FEATURES
    from rocalphago_tpu_torch.models import CNNValue, NeuralNetBase
    from rocalphago_tpu_torch.training import evaluate, value

    rng = np.random.default_rng(SEED + 50)
    prefix = os.path.join(work, "outcomes")
    states = (rng.random((VALUE_POSITIONS, SIZE, SIZE, 49)) < 0.2).astype(
        np.uint8)
    z = rng.choice([-1, 1], VALUE_POSITIONS).astype(np.int32)
    np.savez_compressed(f"{prefix}-00000.npz", states=states, actions=z)
    with open(f"{prefix}-manifest.json", "w") as f:
        json.dump({"board_size": SIZE, "komi": 7.5, "planes": 49,
                   "feature_list": list(VALUE_FEATURES),
                   "targets": "outcome", "shard_counts": [VALUE_POSITIONS],
                   "num_positions": VALUE_POSITIONS}, f)
    spec = os.path.join(work, "value.json")
    CNNValue(board=SIZE, layers=12, filters_per_layer=128, seed=SEED + 41,
             device=dev).save_model(spec)
    out = os.path.join(work, "value")
    t0 = time.perf_counter()
    res = value.run_training([spec, prefix, out, "--epochs", "1",
                              "--epoch-length", str(VALUE_STEPS),
                              "--seed", str(SEED)])
    wall = time.perf_counter() - t0
    for k in ("train_mse", "val_mse", "test_mse"):
        check(np.isfinite(res[k]), f"value {k} = {res[k]}")
    net = NeuralNetBase.load_model(os.path.join(out, "model.json"))
    v = net.forward(torch.as_tensor(states[:8], device=dev).float())
    check(v.shape == (8,) and bool(torch.isfinite(v).all()),
          "the value export's forward")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ev = evaluate.main([os.path.join(out, "model.json"), prefix,
                            "--split", "test", "--shuffle-npz",
                            os.path.join(out, "shuffle.npz")])
    check(np.isfinite(ev["mse"]), f"evaluate mse {ev['mse']}")
    log(f"value: {VALUE_STEPS} steps at minibatch 32 on the 19x19 12x128 "
        f"bf16 FCN value net ({wall:.1f} s), train mse "
        f"{res['train_mse']:.4f}, test mse {res['test_mse']:.4f}; "
        f"evaluate mse {ev['mse']:.4f} on {ev['positions']} positions")


def conv_flops(module) -> tuple[float, float]:
    """(forward, forward + backward) FLOPs per position of the net's
    convolutions: 2·k²·Cin·Cout per point forward; backward twice that,
    less the first layer's input gradient, which no one needs."""
    convs = [m for m in module.modules() if isinstance(m, torch.nn.Conv2d)]
    fwd = [2.0 * m.weight.numel() * SIZE * SIZE for m in convs]
    return sum(fwd), 3 * sum(fwd) - fwd[0]


def spread_ms(fn, queued: bool = False, repeats: int = 5, reps: int = 30):
    """(median, min, max) of ``repeats`` :func:`cuda_ms` readings."""
    xs = sorted(cuda_ms(fn, reps, queued) for _ in range(repeats))
    return xs[len(xs) // 2], xs[0], xs[-1]


def sl_timings(dev, card):
    """The SL train step at minibatch 16 and 256: CUDA events around the
    step as it runs (median of 5 readings of 30 steps) and with the
    card parked until the host has queued every step (the card's time
    alone), around its parts, positions/s, the MFU share against the
    dense bf16 peak, a profile of 20 steps, and the cost of
    deterministic cuDNN at 256 on the card's time alone (deterministic,
    not, not, deterministic, three times over). The card's time alone
    queues only ``QUEUED_STEPS`` steps behind the spin: a deeper queue
    can fill the driver's launch queue, and then the host's pace comes
    back into the reading."""
    from rocalphago_tpu_torch.models import CNNPolicy
    from rocalphago_tpu_torch.training import sl
    from rocalphago_tpu_torch.training.symmetries import (
        random_transform_batch,
    )

    net = CNNPolicy(board=SIZE, layers=12, filters_per_layer=128,
                    seed=SEED + 42, device=dev)
    module = net.module
    fwd_flops, step_flops = conv_flops(module)
    cfg = sl.SLConfig()
    opt, lr_at = sl.make_optimizer(cfg, module.parameters())
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = sl.TrainState(module, opt, gen)
    step = sl.make_train_step(module, opt, lr_at, SIZE, True)
    rng = np.random.default_rng(SEED + 60)
    out = {}
    for b in SL_TIMED_BATCHES:
        host = torch.as_tensor(rng.random((b, SIZE, SIZE, 48)) < 0.2,
                               dtype=torch.uint8).pin_memory()
        host_a = torch.as_tensor(rng.integers(0, SIZE * SIZE, b),
                                 dtype=torch.int32).pin_memory()
        planes, actions = host.to(dev), host_a.to(dev)
        pf = planes.float()

        def fwd_bwd():
            opt.zero_grad(set_to_none=True)
            sl.policy_loss_fn(module, pf, actions)[0].backward()

        fwd_bwd()
        parts = {
            "h2d": lambda: (host.to(dev, non_blocking=True),
                            host_a.to(dev, non_blocking=True)),
            "symmetry": lambda: random_transform_batch(gen, pf, actions,
                                                       SIZE),
            "fwd+bwd": fwd_bwd,
            "optimizer": lambda: sl.apply_update(opt, 1e-9),
        }
        parts = {k: spread_ms(f)[0] for k, f in parts.items()}

        def run_step():
            step(state, planes, actions)

        ms, lo, hi = spread_ms(run_step)
        alone = spread_ms(run_step, queued=True, reps=QUEUED_STEPS)[0]
        wall = wall_ms(run_step, 30)
        prof = profile_device(run_step, 20,
                              f"SL train step at minibatch {b}", "step")
        mfu = b * step_flops / (ms * 1e-3) / BF16_FLOPS_PER_S
        out[b] = dict(ms=ms, wall=wall, parts=parts, prof=prof, mfu=mfu,
                      alone=alone)
        log(f"sl step, minibatch {b}: {ms:.3f} ms on the card (median; "
            f"{lo:.3f}-{hi:.3f}; {wall:.3f} ms host-synchronised; the "
            f"card's time alone {alone:.3f} ms), {b / ms * 1e3:.1f} "
            f"positions/s; parts (medians) [" + ", ".join(
                f"{k} {v:.3f} ms" for k, v in parts.items())
            + f"]; MFU share {mfu:.4f}, on the card's time alone "
            f"{mfu * ms / alone:.4f} ({step_flops / 1e9:.3f} GFLOP a "
            f"position forward + backward, {fwd_flops / 1e9:.3f} forward, "
            f"against {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s) on {card}")
    b = SL_TIMED_BATCHES[-1]
    host = torch.as_tensor(rng.random((b, SIZE, SIZE, 48)) < 0.2,
                           dtype=torch.uint8, device=dev)
    acts = torch.as_tensor(rng.integers(0, SIZE * SIZE, b), device=dev)
    det = {True: [], False: []}
    for flag in (True, False, False, True) * 3:
        torch.backends.cudnn.deterministic = flag
        det[flag].append(cuda_ms(lambda: step(state, host, acts),
                                 QUEUED_STEPS, queued=True))
    torch.backends.cudnn.deterministic = True
    on, off = (float(np.median(det[f])) for f in (True, False))
    log(f"sl step, minibatch {b}, the card's time alone: deterministic "
        f"cuDNN " + " / ".join(f"{x:.3f}" for x in det[True]) + " ms, not "
        + " / ".join(f"{x:.3f}" for x in det[False]) + " ms; cost of the "
        f"medians {on / off - 1:+.3f} on {card}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(f"card after the step timings (SM clock, power, temperature): "
        f"{smi.stdout.strip()}")
    check(all(np.isfinite(v["ms"]) for v in out.values()), "timings")
    return out


def phase_supervised(dev, card, counters):
    """The supervised training path at full width (phase 14)."""
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, SL_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    corpus, launches, rate = sl_convert(root, work, counters)
    spec, straight, meta = sl_train(dev, work, corpus)
    sl_resume(work, spec, corpus, straight)
    sl_evaluate(corpus, straight, meta)
    sl_value(dev, work)
    timings = sl_timings(dev, card)
    log(f"supervised phase: {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "positions_per_s": rate,
            "timings": timings}


def labels_sweeps(boards: torch.Tensor) -> int:
    """Sweeps the hook-and-jump fill needs on these boards (the same
    iteration the kernel runs, counted on the plain version's loop)."""
    from rocalphago_tpu_torch.engine.torchgo import neighbors_for, pad_points

    n = boards.shape[1]
    nbrs = neighbors_for(SIZE, boards.device)
    stone = boards != 0
    links = ((pad_points(boards, 0)[:, nbrs] == boards[:, :, None])
             & stone[:, :, None] & (nbrs < n))
    lab = torch.where(stone, torch.arange(n, device=boards.device), n)
    for sweep in range(1, n + 1):
        hook = torch.where(links, pad_points(lab, n)[:, nbrs], n)
        new = torch.minimum(lab, hook.min(dim=2).values)
        new = torch.minimum(new, pad_points(new, n).gather(1, new))
        if torch.equal(new, lab):
            return sweep
        lab = new
    return n


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from rocalphago_tpu_torch.engine import pygo, torchgo
        from rocalphago_tpu_torch.ops import chase as C
        from rocalphago_tpu_torch.ops import labels as L
        from rocalphago_tpu_torch.ops import tree as T
        from rocalphago_tpu_torch.search.players import build_player
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.monotonic()
    card = phase_card()
    err = {"tree": phase_tree(dev),
           "labels": phase_labels(pygo, dev),
           "chase": phase_chase(pygo, torchgo, dev)}
    phase_encode(pygo, torchgo, dev)
    phase_forward(torchgo, dev)
    greedy_launches, p50 = phase_gtp(dev, (L, C))
    phase_batched_search(pygo, torchgo, dev)
    specs = model_specs(dev)
    player = build_player("device-mcts", specs[0], value_path=specs[1])
    tree8 = phase_sync_free(pygo, torchgo, dev, player.policy, player.value)
    main_path = phase_search_gtp(player, (L, C, T))
    rows = phase_timings(pygo, torchgo, dev, card)
    search_rows = phase_search_timings(torchgo, dev, card, main_path, tree8)
    rows[1]["tree"] = search_rows["tree"]
    sp = phase_policy_selfplay(torchgo, dev, card, (L, C))
    ss = phase_search_selfplay(torchgo, dev, card, (L, C, T), player,
                               sp["final"])
    phase_selfplay_cli(pygo)
    sv = phase_supervised(dev, card, (L, C))
    # the launches of the paths of PRs 4 and 5: policy self-play
    # (labels, chase), search self-play (all three) and the converter
    # (labels, chase); the kernels timed at self-play's shapes
    launches = {k: sp["launches"].get(k, 0) + ss["launches"][k]
                + sv["launches"].get(k, 0) for k in ss["launches"]}
    shapes = {"labels": sp["labels"], "chase": sp["chase"],
              "tree": ss["tree8"]}
    kernels = []
    for name, src, replaces in (
            ("labels", "rocalphago_tpu_torch/csrc/labels.cu",
             "rocalphago_tpu/ops/labels.py:154"),
            ("chase", "rocalphago_tpu_torch/csrc/chase.cu",
             "rocalphago_tpu/ops/chase.py:342"),
            ("tree", "rocalphago_tpu_torch/csrc/tree.cu",
             "rocalphago_tpu/search/device_mcts.py:322 and :370 "
             "(lax.while_loop, not a Pallas kernel)")):
        ms, plain_ms, (bound_ms, bound_by) = shapes[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None})
    log(f"device-search session "
        f"launches {main_path['launches']}; policy self-play launches "
        f"{sp['launches']}; search self-play launches {ss['launches']}")
    log(f"selfplay_19x19_games_per_min (the port's) {sp['games_per_min']:.2f} "
        f"at batch {SP_BATCH} on {card}")
    log(f"device-search genmove p50 {main_path['p50']:.2f} ms at 100 "
        f"simulations, {main_path['sims_per_s']:.1f} simulations/s on "
        f"{card}")
    log(f"greedy session launches {greedy_launches}; converter launches "
        f"{sv['launches']}")
    log(f"SGF conversion {sv['positions_per_s']:.1f} positions/s; SL train "
        "step " + ", ".join(
            f"{t['ms']:.3f} ms at minibatch {b} ({b / t['ms'] * 1e3:.1f} "
            f"positions/s, MFU share {t['mfu']:.4f})"
            for b, t in sv["timings"].items()) + f" on {card}")
    log(f"genmove p50 {p50:.2f} ms on {card}; smoke took "
        f"{time.monotonic() - t0:.0f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
