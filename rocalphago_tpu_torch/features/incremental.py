"""Incremental 48-plane encoding: the port of ``features/incremental.py``.

Sequential callers (the device search's root, self-play's plies,
``Preprocess.advance``) encode successive positions, and almost all of
a position's ladder read is the previous position's. An
:class:`EncodeCache` carried from one encode to the next keeps every
ladder lane's outcome -- the opening's verdict (live chase needed or
decided directly) and, where a chase ran, its verdict -- beside the
lane's read footprint (its read core expanded by
:func:`~.ladders._chase_read_regions`) and the board when it was
recorded. :func:`encode_step` recomputes the cheap planes as the
scratch encode does and re-reads a ladder lane only where its cached
outcome cannot be proven unchanged:

* tier 1, coarse: the one-ply churn ``board != cache.board`` packed
  into one bit per ``REGION_BLOCK``² block of cells (:func:`_region_bits`)
  clears every entry whose footprint's blocks saw no churn;
* tier 2, exact: the other entries compare the current board with
  their record-time board on their footprint cells. A match is
  consulted as if untouched; a mismatch goes dormant (not dead), and
  revives when the board drifts back.

The planes are bit-identical to :func:`~.planes.encode` at every call,
warm or cold, and so is the whole cache carry to the reference's
(``tests/test_torch_incremental.py``). A cold cache has no valid entry,
so every lane refreshes and every live chase runs: the scratch read
plus the bookkeeping.

Batched and branch-free. Every field has a leading game axis, and one
call encodes a batch (:func:`init_cache` is a batch of one). The
reference gates four blocks behind device-side branches (the cell test,
the openings' none/compact/full switch, the pooled chase, the footprint
expansion); eager PyTorch would pay a device→host read for each, so the
port computes each block always and masks it, the reference's
``refresh_slots=0`` trace:

* openings run full-width, gated to the refresh lanes -- the rows of a
  compacted opening are the same lanes' rows of the full one, and the
  record width stays :data:`REFRESH_SLOTS` either way;
* the chase is one launch of :func:`~..ops.chase.chase` over every
  game's ``chase_slots`` lanes with ``collect_core=True``; lanes that
  need no chase go in disabled (prey ``-1``), and the opening's core is
  ORed into the chase's core after. The kernel reads each lane to full
  depth in one go where the reference reads 2 rungs lockstep and
  resumes; the resumed core is the same union of rungs;
* the cell test and the expansion are computed and masked: a skipped
  reference block returns zeros that are masked or dropped anyway.

No block reads the card from the host, so a self-play segment with the
cache makes no sync. The reference's knobs (the incremental switch,
the footprint mode, the phase-1 depth) are not carried over: the port
implements their defaults, tight footprints and a full-depth chase.
The uint32 footprint keys are held in int64 (torch's uint32 has no
bitwise CUDA kernels); :func:`cache_to_numpy` hands them back as
uint32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rocalphago_tpu_torch.engine.torchgo import (
    GoConfig,
    GoState,
    neighbor_analysis,
    step,
)
from rocalphago_tpu_torch.features.ladders import (
    _candidate_lanes,
    _capture_opening,
    _chase_read_regions,
    _compact_indices,
    _escape_opening,
    _first,
    _plane,
)
from rocalphago_tpu_torch.features.planes import (
    assemble_planes,
    encode_analysis,
)
from rocalphago_tpu_torch.features.pyfeatures import DEFAULT_FEATURES
from rocalphago_tpu_torch.ops import chase as _chase_op

#: outcome-ring capacity per game (the reference's measured default: a
#: ring much smaller rotates itself dry on dense 19×19 play)
VERDICT_SLOTS = 128

#: dirty capture / escape lanes one encode records (the reference's
#: measured compaction widths; more dirty lanes count a fallback)
REFRESH_SLOTS = (8, 4)

#: the stats vector's layout (int32 per game, summed on the card and
#: read only at host boundaries: :func:`~.api.observe_incremental`)
(STAT_ENCODES, STAT_REFRESHED, STAT_CHASES, STAT_REUSED,
 STAT_INVALIDATED, STAT_FALLBACKS, STAT_FOOT_HITS, STAT_FLIPS,
 STAT_REVIVED) = range(9)
STAT_FIELDS = ("encodes", "lanes_refreshed", "chases_run",
               "verdicts_reused", "entries_invalidated",
               "refresh_fallbacks", "foot_hits", "verdict_flips",
               "entries_revived")

#: side of the square cell blocks behind the coarse footprint keys: one
#: bit per block, folded mod 32 (25 blocks at 19×19)
REGION_BLOCK = 4


class EncodeCache(NamedTuple):
    """The delta-encode carry of ``B`` games (``V`` ring entries, ``N``
    points). An entry is keyed by its lane ``(move, prey root, prey
    colour, kind)`` and holds the opening's outcome, the chase verdict
    where one ran, and its guard: the read footprint, the footprint's
    block key and the board it was recorded on."""

    board: torch.Tensor              # int8 [B, N] board at the last encode
    entry_key: torch.Tensor          # int32 [B, V] move | prey_root << 10
    #   | (prey_color + 1) << 20 | kind << 22; -1 never written
    entry_need: torch.Tensor         # bool [B, V] opening: chase needed
    entry_direct: torch.Tensor       # bool [B, V] opening: decided
    entry_verdict: torch.Tensor      # bool [B, V] chase verdict (captured)
    entry_has_verdict: torch.Tensor  # bool [B, V]
    entry_valid: torch.Tensor        # bool [B, V] written, not superseded
    entry_foot: torch.Tensor         # bool [B, V, N] read footprint
    entry_board: torch.Tensor        # int8 [B, V, N] board at record time
    entry_footmask: torch.Tensor     # int64 [B, V] footprint block key
    #   (uint32 values)
    entry_clean: torch.Tensor        # bool [B, V] footprint blocks
    #   unchurned since the last passing cell test
    entry_live: torch.Tensor         # bool [B, V] last encode's consult
    #   verdict (for the invalidated / revived counts)
    ptr: torch.Tensor                # int32 [B] ring write pointer
    stats: torch.Tensor              # int32 [B, 9] see STAT_FIELDS


def init_caches(cfg: GoConfig, batch: int, verdict_slots: int = VERDICT_SLOTS,
                device=None) -> EncodeCache:
    """``batch`` cold caches: no valid entry, an empty previous board
    (exactly right for fresh games)."""
    n, v = cfg.num_points, verdict_slots

    def zeros(*shape, dtype=torch.bool):
        return torch.zeros((batch,) + shape, dtype=dtype, device=device)

    return EncodeCache(
        board=zeros(n, dtype=torch.int8),
        entry_key=torch.full((batch, v), -1, dtype=torch.int32,
                             device=device),
        entry_need=zeros(v), entry_direct=zeros(v), entry_verdict=zeros(v),
        entry_has_verdict=zeros(v), entry_valid=zeros(v),
        entry_foot=zeros(v, n), entry_board=zeros(v, n, dtype=torch.int8),
        entry_footmask=zeros(v, dtype=torch.int64),
        entry_clean=zeros(v), entry_live=zeros(v),
        ptr=zeros(dtype=torch.int32),
        stats=zeros(len(STAT_FIELDS), dtype=torch.int32))


def init_cache(cfg: GoConfig, verdict_slots: int = VERDICT_SLOTS,
               device=None) -> EncodeCache:
    """A cold cache of one game (a batch of one)."""
    return init_caches(cfg, 1, verdict_slots, device)


def cache_from_numpy(arrays: dict, device=None) -> EncodeCache:
    """An :class:`EncodeCache` from numpy arrays by field name (the
    reference's ``EncodeCache._asdict()`` read as numpy, or
    :func:`cache_to_numpy`'s): a single game's cache (``board``
    ``[N]``) becomes a batch of one. The uint32 footprint keys become
    int64 holding the same values."""
    single = np.asarray(arrays["board"]).ndim == 1
    out = {}
    for name in EncodeCache._fields:
        a = np.asarray(arrays[name])
        if name == "entry_footmask":
            a = a.astype(np.int64)
        t = torch.as_tensor(a.copy(), device=device)
        out[name] = t[None] if single else t
    return EncodeCache(**out)


def cache_to_numpy(cache: EncodeCache, single: bool = False) -> dict:
    """The cache as numpy arrays by field name, in the reference's
    dtypes (footprint keys uint32); ``single`` drops the game axis of
    a batch of one, the reference's single-game layout."""
    out = {}
    for name, t in cache._asdict().items():
        a = t.detach().cpu().numpy()
        if name == "entry_footmask":
            a = a.astype(np.uint32)
        out[name] = a[0] if single else a
    return out


def _region_bits(cfg: GoConfig, cells: torch.Tensor) -> torch.Tensor:
    """Coarse block key (int64 holding a uint32) of cell masks ``[...,
    N]``: bit ``r`` set where any cell of block ``r`` is. Two
    footprints can interact only if their keys share a bit."""
    size = cfg.size
    per_row = -(-size // REGION_BLOCK)
    flat = torch.arange(cfg.num_points, device=cells.device)
    rid = (((flat // size) // REGION_BLOCK) * per_row
           + (flat % size) // REGION_BLOCK) % 32
    hit = torch.zeros(cells.shape[:-1] + (32,), dtype=torch.int8,
                      device=cells.device).scatter_reduce(
        -1, rid.expand(cells.shape), cells.to(torch.int8), reduce="amax")
    # the blocks are distinct bits, so the sum is the bitwise OR
    weights = torch.ones(32, dtype=torch.int64, device=cells.device) \
        << torch.arange(32, device=cells.device)
    return (hit.long() * weights).sum(dim=-1)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, j]]`` for ``x`` ``[B, K, ...]`` and ``idx``
    ``[B, J]``."""
    tail = x.shape[2:]
    at = idx.long().reshape(idx.shape + (1,) * len(tail)).expand(
        idx.shape + tail)
    return x.gather(1, at)


def _put(x: torch.Tensor, idx: torch.Tensor, src: torch.Tensor
         ) -> torch.Tensor:
    """``x`` with ``x[b, idx[b, j]] = src[b, j]``, where ``idx`` may
    point one past the end of axis 1 (``x.shape[1]``, the reference's
    ``mode="drop"``): that column is the only place duplicates meet,
    and it is cut off."""
    b, k = x.shape[:2]
    tail = x.shape[2:]
    pad = torch.cat([x, torch.zeros((b, 1) + tail, dtype=x.dtype,
                                    device=x.device)], dim=1)
    at = idx.long().reshape(idx.shape + (1,) * len(tail)).expand(
        idx.shape + tail)
    return pad.scatter(1, at, src.to(x.dtype).expand(at.shape))[:, :k]


def _open_core(state: GoState, labels, prey_root, mv, boards):
    """The openings' read core of lanes ``[B, J]``: the prey's stones,
    the move, and every cell the opening changed."""
    iota = torch.arange(state.board.shape[1], device=state.board.device)
    board = state.board[:, None, :]
    return (((labels[:, None, :] == prey_root[..., None]) & (board != 0))
            | (iota == mv[..., None]) | (boards != board))


def ladder_planes_cached(cfg: GoConfig, state: GoState, gd, legal,
                         cache: EncodeCache, depth: int = 40,
                         lanes: int = 16, chase_slots: int = 6):
    """Both ladder planes through the outcome cache: ``(ladder_capture
    [B, N], ladder_escape [B, N], cache')``. Candidates, slots and
    overflow are the scratch read's (:func:`~.ladders.ladder_planes`),
    recomputed every call, so the read covers the same lanes; a lane
    whose key matches a live entry reuses its opening and, where the
    entry holds one, its chase verdict (still taking its chase slot).
    Only the refresh lanes' openings count, and only slotted lanes with
    no verdict chase."""
    b, n = state.board.shape
    v = cache.entry_key.shape[1]
    k = 2 * lanes
    wc, we = min(REFRESH_SLOTS[0], lanes), min(REFRESH_SLOTS[1], lanes)
    rec = wc + we
    if v < rec:
        raise ValueError(f"outcome ring ({v}) must hold at least one "
                         f"encode's record width ({rec})")
    dev = state.board.device
    labels = gd.labels

    # 1. candidates, fresh every call (the scratch read's code)
    analysis = neighbor_analysis(cfg, state.board, labels)
    cap_mv, cap_pr, cap_ok = _candidate_lanes(
        cfg, state, gd, legal, prey_libs=2, prey_is_opp=True, lanes=lanes,
        analysis=analysis)
    esc_mv, esc_pr, esc_ok = _candidate_lanes(
        cfg, state, gd, legal, prey_libs=1, prey_is_opp=False, lanes=lanes,
        analysis=analysis)
    mv = torch.cat([cap_mv, esc_mv], dim=1)
    pr = torch.cat([cap_pr, esc_pr], dim=1)
    ok = torch.cat([cap_ok, esc_ok], dim=1)
    kind = (torch.arange(k, device=dev) >= lanes).long()
    pr_safe = torch.clamp(pr, max=n - 1)
    prey_root = labels.gather(1, pr_safe)
    prey_color = state.board.gather(1, pr_safe)
    lane_key = (mv | (prey_root.long() << 10)
                | ((prey_color.long() + 1) << 20) | (kind << 22)).int()

    # 2. tier 1: churn blocks against each entry's footprint key (a
    # clean entry provably still matches its record board)
    changed = state.board != cache.board
    region_hit = (cache.entry_footmask
                  & _region_bits(cfg, changed)[:, None]) != 0
    clean = cache.entry_clean & ~region_hit
    suspect = cache.entry_valid & ~clean
    foot_hits = (cache.entry_valid & region_hit).sum(dim=1)
    # tier 2: the suspects against their record board on their
    # footprint cells (always computed; only suspects read it)
    cellbad = suspect & ((state.board[:, None, :] != cache.entry_board)
                         & cache.entry_foot).any(dim=2)
    live = cache.entry_valid & ~cellbad
    invalidated = (cache.entry_live & ~live).sum(dim=1)
    revived = (live & ~cache.entry_live).sum(dim=1)

    keymatch = cache.entry_key[:, None, :] == lane_key[:, :, None]  # [B,K,V]
    match = live[:, None, :] & keymatch
    hit = match.any(dim=2) & ok
    ent = _first(match)
    c_need = cache.entry_need.gather(1, ent) & hit
    c_direct = cache.entry_direct.gather(1, ent) & hit
    c_has = cache.entry_has_verdict.gather(1, ent) & hit
    c_verdict = cache.entry_verdict.gather(1, ent)
    # a lane matching only a dormant verdict re-chases: a verdict flip
    dormant_verdict = ((cache.entry_valid & ~live
                        & cache.entry_has_verdict)[:, None, :]
                       & keymatch).any(dim=2)

    # 3. refresh: unknown opening, or a verdict gap that can still win
    # a chase slot (certain-need lanes ahead of it fill the slots else)
    certain = (hit & c_need).int()
    certain_before = certain.cumsum(dim=1) - certain
    gap = c_need & ~c_has & (certain_before < chase_slots)
    refresh = ok & (~hit | gap)
    cap_ref, esc_ref = refresh[:, :lanes], refresh[:, lanes:]

    cb, cl, cn, cd = _capture_opening(cfg, state, gd, cap_mv, cap_pr,
                                      cap_ref)
    eb, el, en, ed = _escape_opening(cfg, state, gd, esc_mv, esc_pr,
                                     esc_ref)
    boards_f = torch.cat([cb, eb], dim=1)
    labels_f = torch.cat([cl, el], dim=1)
    need_f = torch.cat([cn, en], dim=1)
    direct_f = torch.cat([cd, ed], dim=1)
    cridx = _compact_indices(cap_ref, wc, lanes)
    eridx = _compact_indices(esc_ref, we, lanes)
    ridx = torch.cat([torch.where(cridx < lanes, cridx, k),
                      torch.where(eridx < lanes, eridx + lanes, k)], dim=1)
    rvalid = ridx < k
    rsafe = torch.where(rvalid, ridx, 0)
    fellback = (cap_ref.sum(dim=1) > wc) | (esc_ref.sum(dim=1) > we)

    need = torch.where(hit, c_need, need_f) & ok
    direct = torch.where(hit, c_direct, direct_f) & ok

    # 4. slots over every need lane (hit lanes take theirs too)
    slot_idx = _compact_indices(need, chase_slots, k)         # [B, S]
    svalid = slot_idx < k
    ssafe = torch.where(svalid, slot_idx, 0)
    zero_k = torch.zeros((b, k), dtype=torch.bool, device=dev)
    covered = _put(zero_k, slot_idx, svalid)
    reused = (hit & c_has).gather(1, ssafe)
    run = svalid & ~reused

    # 5. one chase launch over every slot; lanes with a reused verdict
    # or no lane go in disabled, and the opening's core joins after
    boards_s = _rows(boards_f, ssafe)
    open_core = _open_core(state, labels, prey_root.gather(1, ssafe),
                           mv.gather(1, ssafe), boards_s)
    prey = torch.where(run, pr_safe.gather(1, ssafe), -1)
    captured, core = _chase_op.chase(
        boards_s.reshape(b * chase_slots, n).contiguous(),
        _rows(labels_f, ssafe).reshape(b * chase_slots, n).contiguous(),
        prey.reshape(-1).int().contiguous(), cfg.size, depth,
        collect_core=True)
    chased_s = captured.reshape(b, chase_slots) & run
    core_s = (core.reshape(b, chase_slots, n) | open_core) & run[..., None]
    chased = _put(zero_k, slot_idx, chased_s)
    ran = _put(zero_k, slot_idx, run)
    chase_core = _put(torch.zeros((b, k, n), dtype=torch.bool, device=dev),
                      slot_idx, core_s)

    # 6. the planes: the scratch formulas, verdicts cached or chased
    verdict = torch.where(hit & c_has, c_verdict, chased)
    captured_lane = direct[:, :lanes] | (
        need[:, :lanes] & covered[:, :lanes] & verdict[:, :lanes])
    escaped_lane = direct[:, lanes:] | (
        need[:, lanes:] & covered[:, lanes:] & ~verdict[:, lanes:])
    plane_cap = _plane(cfg, cap_mv, captured_lane & cap_ok)
    plane_esc = _plane(cfg, esc_mv, escaped_lane & esc_ok)

    # 7. record the first refresh lanes of each kind: one footprint per
    # lane over its opening and chase cores, on the encode-time board
    core_w = (_open_core(state, labels, prey_root.gather(1, rsafe),
                         mv.gather(1, rsafe), _rows(boards_f, rsafe))
              | _rows(chase_core, rsafe)) & rvalid[..., None]
    foot_w = _chase_read_regions(cfg, state.board, labels, core_w)
    footbits_w = _region_bits(cfg, foot_w)

    # entries a recorded lane re-records die first, dormant twins too
    rec_lane = _put(zero_k, ridx, torch.ones_like(rvalid))
    superseded = (keymatch & rec_lane[:, :, None]).any(dim=1)
    dest = torch.where(rvalid, (cache.ptr[:, None].long()
                                + torch.arange(rec, device=dev)) % v, v)
    n_new = rvalid.sum(dim=1)
    stats = torch.stack([
        torch.zeros_like(n_new), refresh.sum(dim=1), run.sum(dim=1),
        (svalid & reused).sum(dim=1), invalidated, fellback.long(),
        foot_hits, (run & dormant_verdict.gather(1, ssafe)).sum(dim=1),
        revived], dim=1)
    new_cache = EncodeCache(
        board=state.board,
        entry_key=_put(cache.entry_key, dest, _rows(lane_key, rsafe)),
        entry_need=_put(cache.entry_need, dest, _rows(need_f, rsafe)),
        entry_direct=_put(cache.entry_direct, dest, _rows(direct_f, rsafe)),
        entry_verdict=_put(cache.entry_verdict, dest, _rows(chased, rsafe)),
        entry_has_verdict=_put(cache.entry_has_verdict, dest,
                               _rows(ran, rsafe)),
        entry_valid=_put(cache.entry_valid & ~superseded, dest, rvalid),
        entry_foot=_put(cache.entry_foot, dest, foot_w),
        entry_board=_put(cache.entry_board, dest,
                         state.board[:, None, :].expand(b, rec, n)),
        entry_footmask=_put(cache.entry_footmask, dest, footbits_w),
        entry_clean=_put(live & ~superseded, dest, rvalid),
        entry_live=_put(live & ~superseded, dest, rvalid),
        ptr=((cache.ptr.long() + n_new) % v).int(),
        stats=cache.stats + stats.int())
    return plane_cap, plane_esc, new_cache


def encode_step(cfg: GoConfig, state: GoState, cache: EncodeCache,
                features: tuple = None, ladder_depth: int = 40,
                ladder_lanes: int = 16, ladder_chase_slots: int = 6,
                gd=None):
    """Encode ``state`` (a batch) against the cache of each game's
    previous position → ``(planes [B, size, size, F], cache')``,
    bit-identical to :func:`~.planes.encode` on the same ``gd``. The
    cheap planes are the scratch encode's code; feature sets without
    both ladder planes reuse nothing but keep the carry. Batched, it is
    also the reference's ``batched_delta_encoder`` (whose
    ``refresh_slots=0`` trace it equals, as it equals the compacted
    one)."""
    if features is None:
        features = DEFAULT_FEATURES
    gd, ci, legal = encode_analysis(cfg, state, features, gd)
    lad_kw = dict(depth=ladder_depth, lanes=ladder_lanes,
                  chase_slots=ladder_chase_slots)
    lad_cap = lad_esc = None
    if "ladder_capture" in features and "ladder_escape" in features:
        lad_cap, lad_esc, cache = ladder_planes_cached(
            cfg, state, gd, legal, cache, **lad_kw)
    else:
        cache = cache._replace(board=state.board)
    encodes = torch.zeros_like(cache.stats)
    encodes[:, STAT_ENCODES] = 1
    cache = cache._replace(stats=cache.stats + encodes)
    planes = assemble_planes(cfg, state, features, gd, ci, legal,
                             lad_cap, lad_esc, lad_kw)
    return planes, cache


def encode_delta(cfg: GoConfig, prev_state: GoState, cache: EncodeCache,
                 move: torch.Tensor, features: tuple = None,
                 **encode_kwargs):
    """Play ``move`` (int ``[B]``, ``N`` = pass) on ``prev_state`` and
    delta-encode the successors → ``(planes, cache')``: the same as
    stepping first and calling :func:`encode_step`, since the cache
    diffs boards, not moves."""
    return encode_step(cfg, step(cfg, prev_state, move), cache,
                       features=features, **encode_kwargs)
