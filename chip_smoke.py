#!/usr/bin/env python3
"""Drive the PyTorch port (``rocalphago_tpu_torch``) on one CUDA card
and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. card: name and power limit (``nvidia-smi``), kernel build time;
2. labels kernel vs its plain version: 19×19 boards from seeded random
   play (0, 60 and 200 moves) plus serpentine snakes at 9, 19 and 25 --
   bit-exact;
3. chase kernel vs its plain version: lanes harvested from real encodes
   of ladder-heavy and random 19×19 positions, seeded random entries
   and disabled lanes -- verdicts and read cores bit-exact;
4. encode: 19×19 positions encoded on the card equal the CPU encode
   (plain versions) bit for bit;
5. forward: the full-width policy (19×19, 48 planes, 12 layers × 128
   filters, fresh seeded weights), float32 with TF32 off, card vs CPU
   within ``FORWARD_ATOL``/``FORWARD_RTOL``, at batch 8 and 256;
6. GTP, the main path: that net saved as a spec, loaded by the GTP
   player factory (``build_player``: the card, bfloat16), and a scripted
   session through ``run_gtp`` with a ladder on the board and
   ``GENMOVES`` genmoves for both colours; every reply a legal vertex,
   no illegal move from the player, and both kernels launched during it
   (launch counts reset just before, read just after);
7. timings with CUDA events at the main path's shapes (one state per
   genmove) and at batch 8 and 256, beside each plain version and each
   kernel's roofline bound; p50 genmove latency.

The last three lines are the card (as ``nvidia-smi`` prints it), the
kernel table as JSON, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SIZE = 19
SEED = 20261017
GENMOVES = 12            # per colour
FORWARD_ATOL = 1e-3      # float32 card vs CPU, TF32 off: summation
FORWARD_RTOL = 1e-4      # order only, over 12 layers of 1,152-term dots
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
SCALAR_OPS_PER_S = 67e12           # float32 outside the tensor cores
# integer operations per board point per rung of the chase kernel,
# counted from csrc/chase.cu (liberty table ~20, prey mask and liberties
# ~10, per option: place ~10, escaper response ~60, two try_moves ~60)
CHASE_OPS_PER_POINT_RUNG = 300
LABELS_OPS_PER_POINT_SWEEP = 6      # 4 hooks, a jump, the change test


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


def ladder_positions(pygo, count: int, seed: int):
    """Ladder-heavy 19×19 boards: six standard ladder seeds along the
    anti-diagonal (each white stone flanked on three sides, black to
    move), plus a few seeded random stones that break some paths."""
    rng = np.random.default_rng(seed)
    seeds = [(1, 16), (4, 13), (7, 10), (10, 7), (13, 4), (16, 1)]
    out = []
    for i in range(count):
        st = pygo.GameState(size=SIZE, komi=7.5)
        for r, c in seeds:
            st.do_move((r - 1, c), pygo.BLACK)
            st.do_move((r, c), pygo.WHITE)
            st.do_move((r, c - 1), pygo.BLACK)
            st.do_move((r + 1, c - 1), pygo.BLACK)
        for _ in range(i % 5):
            mv = tuple(int(v) for v in rng.integers(0, SIZE, 2))
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
    return card


def phase_labels(pygo, dev):
    from rocalphago_tpu_torch.ops import labels as L

    sts = random_positions(pygo, 1026, (0, 60, 200), SEED)
    boards = np.stack([np.asarray(s.board, np.int8).reshape(-1)
                       for s in sts])
    cases = [(SIZE, boards)]
    for size in (9, 19, 25):
        snake = serpentine(size)
        cases.append((size, np.stack([snake, -snake,
                                      np.ones_like(snake)])))
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
    log(f"labels: {len(boards)} 19x19 boards + serpentines at 9/19/25 "
        "bit-exact vs plain")
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


def entry_lanes(pygo, torchgo, dev, count: int, seed: int):
    """Every 2-liberty group of random positions as a chase entry
    (board, carried labels, a prey point of the group)."""
    cfg = torchgo.GoConfig(size=SIZE)
    sts = random_positions(pygo, count, (40, 90, 140), seed)
    st = torchgo.seed_labels(cfg, torchgo.from_pygo(
        cfg, sts, device=dev, with_labels=False))
    libs = torchgo.lib_counts_from_labels(cfg, st.board, st.labels)
    lab = st.labels.long()
    two = (libs.gather(1, lab) == 2) & (st.board != 0) & (
        lab == torch.arange(cfg.num_points, device=dev))
    g, p = torch.nonzero(two, as_tuple=True)
    return (st.board[g].contiguous(), st.labels[g].contiguous(),
            p.int().contiguous())


def phase_chase(pygo, torchgo, dev):
    from rocalphago_tpu_torch.features.api import Preprocess
    from rocalphago_tpu_torch.ops import chase as C

    cfg = torchgo.GoConfig(size=SIZE)
    pre = Preprocess(cfg=cfg, device=dev)
    sts = (ladder_positions(pygo, 24, SEED + 1)
           + random_positions(pygo, 40, (60, 120, 200), SEED + 2))
    with LaneRecorder(C) as rec:
        pre.states_to_tensor(torchgo.seed_labels(cfg, torchgo.from_pygo(
            cfg, sts, device=dev, with_labels=False)))
    eb = torch.cat([b for b, _, _ in rec.lanes])
    el = torch.cat([lab for _, lab, _ in rec.lanes])
    ep = torch.cat([p for _, _, p in rec.lanes])
    rb, rl, rp = entry_lanes(pygo, torchgo, dev, 48, SEED + 3)
    boards = torch.cat([eb, rb, rb[:64]])
    labels = torch.cat([el, rl, rl[:64]])
    prey = torch.cat([ep, rp, torch.full((64,), -1, dtype=torch.int32,
                                         device=dev)])   # disabled lanes
    got_c, got_core = C.chase(boards, labels, prey, SIZE, 40,
                              collect_core=True)
    want_c, want_core = C.chase_plain(boards, labels, prey, SIZE, 40,
                                      collect_core=True)
    torch.cuda.synchronize()
    check(torch.equal(got_c, want_c),
          f"chase verdicts differ on {int((got_c != want_c).sum())} lanes")
    check(torch.equal(got_core, want_core),
          f"chase cores differ on "
          f"{int((got_core != want_core).any(1).sum())} lanes")
    check(not got_c[-64:].any(), "a disabled lane read True")
    enc_live = int((ep >= 0).sum())
    check(enc_live > 0 and bool(want_c.any()) and not bool(want_c.all()),
          "the chase inputs lack live encode lanes or an outcome")
    log(f"chase: {len(prey)} lanes ({enc_live} live from encodes, "
        f"{len(rp)} random entries, 64 disabled), "
        f"{int(want_c.sum())} captured; verdicts and cores bit-exact")
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
    from rocalphago_tpu_torch.models.policy import CNNPolicy

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = CNNPolicy(board=SIZE, layers=12, filters_per_layer=128,
                    seed=SEED, device=dev, dtype=torch.float32)
    cpu = CNNPolicy(board=SIZE, layers=12, filters_per_layer=128,
                    seed=SEED, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(SEED)
    for batch in (8, 256):
        planes = torch.as_tensor(
            (rng.random((batch, SIZE, SIZE, 48)) < 0.3).astype(np.float32))
        g = gpu.forward(planes.to(dev)).cpu()
        c = cpu.forward(planes)
        check(bool(torch.isfinite(g).all()), "non-finite logits")
        err = float((g - c).abs().max())
        check(torch.allclose(g, c, atol=FORWARD_ATOL, rtol=FORWARD_RTOL),
              f"forward batch {batch}: max abs err {err}")
        log(f"forward: batch {batch}, 12x128 fp32 (TF32 off), card vs CPU "
            f"max abs err {err:.3g} (max |logit| "
            f"{float(c.abs().max()):.3g})")


def phase_gtp(dev, counters):
    from rocalphago_tpu_torch.interface.gtp import run_gtp, vertex_to_move
    from rocalphago_tpu_torch.models.policy import CNNPolicy
    from rocalphago_tpu_torch.search.players import build_player

    # the user's route: a saved spec, loaded by the GTP entry's player
    # factory on its default device (the card) and working type (bf16)
    model_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "smoke_model")
    os.makedirs(model_dir, exist_ok=True)
    spec = os.path.join(model_dir, "policy19.json")
    CNNPolicy(board=SIZE, layers=12, filters_per_layer=128, seed=SEED,
              device=dev).save_model(spec)
    player = build_player("greedy", spec)
    net = player.policy
    check(net.device.type == "cuda" and net.module.dtype == torch.bfloat16,
          f"the GTP player runs on {net.device} in {net.module.dtype}")
    # a ladder: white (D4) flanked on three sides, black to move
    setup = ["boardsize 19", "clear_board", "komi 7.5", "play b C4",
             "play w D4", "play b D3", "play w Q16", "play b E3"]
    moves = [f"genmove {c}" for _ in range(GENMOVES) for c in "bw"]
    script = "\n".join(setup + moves + ["final_score", "quit"]) + "\n"

    class Timed(io.StringIO):
        """Input stream that stamps when each line is handed out."""

        def __init__(self, text):
            super().__init__(text)
            self.stamps = []

        def __iter__(self):
            while line := self.readline():
                self.stamps.append(time.monotonic())
                yield line

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
            f"({ch_bound[1]})")
    return rows


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
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.monotonic()
    card = phase_card()
    err = {"labels": phase_labels(pygo, dev),
           "chase": phase_chase(pygo, torchgo, dev)}
    phase_encode(pygo, torchgo, dev)
    phase_forward(torchgo, dev)
    launches, p50 = phase_gtp(dev, (L, C))
    rows = phase_timings(pygo, torchgo, dev, card)
    kernels = []
    for name, src, replaces in (
            ("labels", "rocalphago_tpu_torch/csrc/labels.cu",
             "rocalphago_tpu/ops/labels.py:154"),
            ("chase", "rocalphago_tpu_torch/csrc/chase.cu",
             "rocalphago_tpu/ops/chase.py:342")):
        ms, plain_ms, (bound_ms, bound_by) = rows[1][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None})
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
