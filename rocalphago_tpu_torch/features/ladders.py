"""Ladder reading for the ladder_capture / ladder_escape planes.

The port of ``features/ladders.py``, batched: every function takes a
leading lane (or game) dimension where the reference ``vmap``-s. The
read itself is the reference's design (candidate compaction, openings
that gate which lanes need a chase, one pooled chase for both planes,
two-ply rungs scored by the forced escaper response); the chase runs
through :func:`rocalphago_tpu_torch.ops.chase.chase`, which is the
CUDA kernel on the card. The reference's default XLA schedule reads
all slots lockstep to a shallow depth and then finishes deep lanes one
at a time; the kernel gives every lane its own loop to full depth in
one launch, which the reference pins as equal
(``TestTwoPhaseChaseEquivalence``, ``test_chase_impl_flag_produces_
identical_planes``).

The reference's knobs (shared/split gating, phase-1 depth, chase
implementation) are not carried over: the port implements their
defaults -- shared gating, per-lane chase to full depth.

Lane arrays: ``board`` int8 ``[L, N]``, ``labels`` int32 ``[L, N]``,
``lib_counts`` int32 ``[L, N + 1]``, per-lane scalars ``[L]``.
"""

from __future__ import annotations

import torch

from rocalphago_tpu_torch.engine.torchgo import (
    GoConfig,
    GoState,
    GroupData,
    _dedup_mask,
    lib_counts_from_labels,
    neighbor_analysis,
    neighbors_for,
    neighbors_padded,
    pad_points,
    relabel_after_place,
)
from rocalphago_tpu_torch.ops import chase as _chase_op


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 when none
    (``jnp.argmax`` on a bool row)."""
    n = mask.shape[-1]
    iota = torch.arange(n, device=mask.device)
    idx = torch.where(mask, iota, n).min(dim=-1).values
    return torch.where(idx == n, 0, idx)


def _at(x: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    """``x[i, pt[i]]`` for each row."""
    return x.gather(1, pt.long()[:, None])[:, 0]


def _with_point(x: torch.Tensor, pt: torch.Tensor, value) -> torch.Tensor:
    """``x`` with ``x[i, pt[i]] = value[i]`` (a new tensor)."""
    at = torch.arange(x.shape[1], device=x.device)[None, :] == pt[:, None]
    return torch.where(at, value[:, None].to(x.dtype), x)


def _dilate(cfg: GoConfig, m: torch.Tensor) -> torch.Tensor:
    """bool ``[L, N]`` → self ∪ 4-neighborhood."""
    nbrs = neighbors_for(cfg.size, m.device)
    return m | pad_points(m, False)[:, nbrs].any(dim=2)


def _roots_mask(labels: torch.Tensor, roots: torch.Tensor,
                keep: torch.Tensor) -> torch.Tensor:
    """bool ``[L, N]``: points whose label is one of the kept ``roots``
    ``[L, K]``."""
    return (labels[:, :, None] == torch.where(
        keep, roots, -2)[:, None, :]).any(dim=2)


def _place(cfg: GoConfig, board, labels, lib_counts, action, color):
    """Light move application on the pre-move analysis: resolves
    captures, flags suicide/occupied as invalid (board unchanged).
    Returns ``(board, ok [L], captured [L, N])``."""
    n = cfg.num_points
    my = neighbors_padded(cfg.size, board.device)[action.long()]
    nbr_color = pad_points(board, 0).gather(1, my)
    nbr_root = pad_points(labels.long(), n).gather(1, my)
    valid = my < n
    uniq = _dedup_mask(nbr_root)
    nbr_libs = lib_counts.gather(1, nbr_root)
    color = color[:, None]
    cap_k = valid & uniq & (nbr_color == -color) & (nbr_libs == 1)
    captured = _roots_mask(labels, nbr_root, cap_k)
    has_empty = (valid & (nbr_color == 0)).any(dim=1)
    own_safe = (valid & (nbr_color == color) & (nbr_libs >= 2)).any(dim=1)
    ok = (_at(board, action) == 0) & (has_empty | own_safe
                                      | cap_k.any(dim=1))
    new_board = _with_point(torch.where(captured, 0, board), action,
                            color[:, 0])
    return (torch.where(ok[:, None], new_board, board), ok,
            captured & ok[:, None])


def _relabel_place(cfg: GoConfig, board, labels, pt, color, cap_mask,
                   enabled):
    """Board and carried labels after placing ``color`` at ``pt`` and
    removing ``cap_mask`` (no flood fill; see
    :func:`torchgo.relabel_after_place`). Rows with ``enabled`` False
    come back unchanged."""
    labels1 = relabel_after_place(cfg, board, labels, pt, color, cap_mask)
    board1 = _with_point(torch.where(cap_mask, 0, board), pt, color)
    en = enabled[:, None]
    return (torch.where(en, board1, board),
            torch.where(en, labels1, labels))


def _escaper_response_full(cfg: GoConfig, b1, prey_color, prey_mask,
                           labels0, lib_counts0, c_pt, cap0):
    """Best forced response of a prey left in atari by the chaser's
    move at ``c_pt``: extend at its last liberty, or counter-capture an
    adjacent chasing group in atari -- all derived from the rung's
    pre-move analysis (``labels0``/``lib_counts0``) and the post-move
    board ``b1``, with no flood fill (the reference's docstring gives
    the exactness argument case by case).

    Returns ``(preyL1, libs_after_best, resp_pt, resp_cap,
    resp_made)``: the prey's liberties on ``b1``, its liberties after
    the chosen response (-1 when no legal response exists), the
    response point, the chaser stones it captures and whether a
    response was made. (The reference also returns the board after the
    response; nothing on the port's path reads it.)"""
    n = cfg.num_points
    nbrs = neighbors_padded(cfg.size, b1.device)
    chaser = (-prey_color)[:, None]
    lab0 = labels0.long()
    lab_pad0 = pad_points(lab0, n)
    b1_pad = pad_points(b1, 0)
    empty1 = b1 == 0

    dil_prey = _dilate(cfg, prey_mask)
    prey_libs1 = empty1 & dil_prey
    prey_l1 = prey_libs1.sum(dim=1)
    ext_pt = _first(prey_libs1)

    # the merged chaser group around c_pt
    cn = nbrs[c_pt.long()]
    gc_mask = _roots_mask(lab0, lab_pad0.gather(1, cn),
                          b1_pad.gather(1, cn) == chaser)
    gc_mask = gc_mask | (torch.arange(n, device=b1.device)[None, :]
                         == c_pt[:, None])
    gc_pad = pad_points(gc_mask, False)
    gc_nlibs = (empty1 & _dilate(cfg, gc_mask)).sum(dim=1)

    # chaser groups that gained a liberty from the chaser-move capture
    gained_pt = (b1 == chaser) & _dilate(cfg, cap0)
    gained_root = torch.zeros((b1.shape[0], n + 1), dtype=torch.int8,
                              device=b1.device).scatter_reduce(
        1, lab0, gained_pt.to(torch.int8), reduce="amax") > 0

    # counter-capture target: first chaser stone adjacent to the prey
    # whose group is in atari on b1
    adj_prey = (b1 == chaser) & dil_prey
    atari_pts = adj_prey & torch.where(
        gc_mask, (gc_nlibs == 1)[:, None],
        (lib_counts0.gather(1, lab0) == 1) & ~gained_root.gather(1, lab0))
    have_cap = atari_pts.any(dim=1)
    target = _first(atari_pts)
    target_mask = torch.where(
        _at(gc_mask, target)[:, None], gc_mask,
        lab0 == _at(lab0, target)[:, None])
    cap_pt = _first(empty1 & _dilate(cfg, target_mask))

    def try_move(pt, enabled):
        onehot = torch.arange(n, device=b1.device)[None, :] == pt[:, None]
        pn = nbrs[pt.long()]
        roots = lab_pad0.gather(1, pn)
        colors = b1_pad.gather(1, pn)
        is_chaser = colors == chaser
        in_gc = gc_pad.gather(1, pn)
        valid = pn < n
        # chaser groups captured by the response: adjacent, in atari
        old_cap_k = (valid & is_chaser & ~in_gc
                     & (lib_counts0.gather(1, roots) == 1)
                     & ~gained_root.gather(1, roots))
        esc_cap = _roots_mask(lab0, roots, old_cap_k)
        gc_capped = (valid & is_chaser & in_gc).any(dim=1) & (gc_nlibs == 1)
        esc_cap = esc_cap | (gc_capped[:, None] & gc_mask)
        # the played stone's cluster joins the prey only when pt is
        # itself adjacent to the prey
        merge_mask = _roots_mask(lab0, roots,
                                 valid & (colors == prey_color[:, None]))
        cluster = onehot | merge_mask
        empty2 = (empty1 & ~onehot) | esc_cap
        comp = torch.where(_at(dil_prey, pt)[:, None],
                           prey_mask | cluster, prey_mask)
        libs2 = (empty2 & _dilate(cfg, comp)).sum(dim=1)
        legal = (empty2 & _dilate(cfg, cluster)).any(dim=1)
        okm = enabled & _at(empty1, pt) & legal
        return torch.where(okm, libs2, -1), esc_cap & okm[:, None]

    l1, c1 = try_move(ext_pt, prey_l1 >= 1)
    l2, c2 = try_move(cap_pt, have_cap)
    take1 = l1 >= l2
    resp_l = torch.where(take1, l1, l2)
    return (prey_l1, resp_l, torch.where(take1, ext_pt, cap_pt),
            torch.where(take1[:, None], c1, c2), resp_l >= 0)


def _groups_touching(board, labels, region):
    """bool ``[B, W, N]``: stones of every group with a stone in
    ``region`` (bool ``[B, W, N]``), against each game's ``board`` and
    ``labels`` (``[B, N]``). The reference multiplies by a float32
    label one-hot; a max-scatter per group root and a gather back give
    the same bits without the ``[N, N + 1]`` table."""
    b, w, n = region.shape
    stones = (board != 0)[:, None, :]
    root = torch.where(stones, labels[:, None, :].long(), n).expand(b, w, n)
    touched = torch.zeros((b, w, n + 1), dtype=torch.int8,
                          device=board.device).scatter_reduce(
        2, root, (region & stones).to(torch.int8), reduce="amax")
    return (touched.gather(2, root) > 0) & stones


def _chase_read_regions(cfg: GoConfig, board, labels, cores):
    """Read footprints ``[B, W, N]`` of ``W`` read cores per game
    (bool ``[B, W, N]``) against the encode-time ``board``/``labels``
    (``[B, N]``): a sound over-approximation of every cell an opening's
    or a chase's analysis can read, radiating from its core (the
    prey's stones plus every cell the read played on or captured).
    The reference's tight footprint, step by step: ``D2 = dilate²
    (core)``; ``grp1``, whole groups with a stone in ``D2``; the
    counter-capture ring ``R2 = dilate²(grp1)``; ``grp2``, whole groups
    with a stone in ``R2 ∪ D2``; the footprint is ``D2 ∪ grp1 ∪ R2 ∪
    grp2 ∪ dilate(grp2)`` (the reference's docstring derives each
    step)."""
    b, w, n = cores.shape

    def dilate(m, k):
        m = m.reshape(b * w, n)
        for _ in range(k):
            m = _dilate(cfg, m)
        return m.reshape(b, w, n)

    region = dilate(cores, 2)
    grp1 = _groups_touching(board, labels, region)
    ring = dilate(grp1, 2)
    grp2 = _groups_touching(board, labels, ring | region)
    return region | grp1 | ring | grp2 | dilate(grp2, 1)


def _chase_read_region(cfg: GoConfig, board, labels, core):
    """:func:`_chase_read_regions` of one core per game (bool
    ``[B, N]``)."""
    return _chase_read_regions(cfg, board, labels, core[:, None, :])[:, 0]


def _compact_indices(mask: torch.Tensor, size: int, fill_value: int):
    """First ``size`` set indices of each row of a bool ``[B, M]`` mask,
    ascending, padded with ``fill_value`` -- the counterpart of
    ``jnp.nonzero(size=..., fill_value=...)``, by a cumsum rank."""
    b, m = mask.shape
    rank = mask.long().cumsum(dim=1) - 1
    pos = torch.where(mask & (rank < size), rank, size)
    out = torch.full((b, size + 1), fill_value, dtype=torch.long,
                     device=mask.device)
    src = torch.arange(m, device=mask.device).expand(b, m)
    out.scatter_(1, pos, src)     # column ``size`` collects the rest
    return out[:, :size]


def _compacted_chase(cfg: GoConfig, boards, labels, prey_pts, need_chase,
                     depth: int, slots: int):
    """Chase the lanes flagged ``need_chase`` (bool ``[B, K]``) after
    compacting them into ``slots`` per game; ``boards``/``labels``
    ``[B, K, N]``, ``prey_pts`` ``[B, K]``. Overflow beyond ``slots``
    is not read. Returns ``(captured [B, K], covered [B, K])``, where
    ``covered`` marks the lanes whose chase ran. All ``B * slots``
    lanes go to one :func:`ops.chase.chase` call."""
    b, k = need_chase.shape
    n = cfg.num_points
    slot_idx = _compact_indices(need_chase, slots, k)          # [B, S]
    valid = slot_idx < k
    safe = torch.where(valid, slot_idx, 0)
    gather = safe[:, :, None].expand(-1, -1, n)
    prey = torch.where(valid, prey_pts.gather(1, safe), -1)
    captured = _chase_op.chase(
        boards.gather(1, gather).reshape(b * slots, n).contiguous(),
        labels.gather(1, gather).reshape(b * slots, n).contiguous(),
        prey.reshape(-1).int().contiguous(), cfg.size, depth
    ).reshape(b, slots)
    out = torch.zeros((b, k + 1), dtype=torch.bool, device=boards.device)
    cov = torch.zeros_like(out)
    out.scatter_(1, slot_idx, captured & valid)
    cov.scatter_(1, slot_idx, valid)
    return out[:, :k], cov[:, :k]


def _candidate_lanes(cfg: GoConfig, state: GoState, gd: GroupData, legal,
                     prey_libs: int, prey_is_opp: bool, lanes: int,
                     analysis=None):
    """Compact the (move, prey) pairs at the ladder precondition into
    ``lanes`` per game: opponent strings at 2 liberties (capture) or
    own strings in atari (escape). Returns ``(move_pt, prey_pt,
    valid)``, each ``[B, lanes]``."""
    n = cfg.num_points
    b = state.board.shape[0]
    nbrs = neighbors_for(cfg.size, state.board.device)
    if analysis is None:
        analysis = neighbor_analysis(cfg, state.board, gd.labels)
    nbr_color, nbr_root, uniq, _ = analysis
    want = -state.turn if prey_is_opp else state.turn
    nbr_libs = gd.lib_counts.gather(1, nbr_root.reshape(b, -1)) \
        .reshape(nbr_root.shape)
    cand = (legal[:, :, None] & uniq & (nbr_color == want[:, None, None])
            & (nbr_libs == prey_libs))                        # [B, N, 4]
    flat_idx = _compact_indices(cand.reshape(b, -1), lanes, 4 * n)
    valid = flat_idx < 4 * n
    safe = torch.where(valid, flat_idx, 0)
    return safe // 4, nbrs.reshape(-1)[safe], valid


def _lanes_of(state: GoState, gd: GroupData, k: int):
    """Each game's board, labels, liberty table and player to move,
    repeated for its ``k`` lanes → lane arrays ``[B * k, ...]``."""
    def rep(x):
        return x.repeat_interleave(k, dim=0)

    return (rep(state.board), rep(gd.labels), rep(gd.lib_counts),
            rep(state.turn))


def _capture_opening(cfg: GoConfig, state: GoState, gd: GroupData,
                     move_pt, prey_pt, valid):
    """Capture opening over the candidate lanes: the chaser's first
    move, the prey's forced response, and the carried labels through
    both plies. Returns ``(boards [B,K,N], labels [B,K,N], need_chase
    [B,K], direct [B,K])``: only lanes left at exactly 2 liberties
    (a live, undecided chase) need a chase slot; ``respL <= 1`` is a
    capture decided here."""
    b, k = move_pt.shape
    n = cfg.num_points
    board, labels, libs, me = _lanes_of(state, gd, k)
    mv, pr, ok = move_pt.reshape(-1), prey_pt.reshape(-1), valid.reshape(-1)
    board1, placed, cap0 = _place(cfg, board, labels, libs, mv, me)
    prey_mask = labels == _at(labels, pr)[:, None]
    _, resp_l, resp_pt, resp_cap, resp_made = _escaper_response_full(
        cfg, board1, -me, prey_mask, labels, libs, mv, cap0)
    live = ok & placed
    need_chase = live & (resp_l == 2)
    b1r, lab1 = _relabel_place(cfg, board, labels, mv, me, cap0, live)
    b2r, lab2 = _relabel_place(cfg, b1r, lab1, resp_pt, -me, resp_cap,
                               need_chase & resp_made)
    direct = live & (resp_l <= 1)
    return (b2r.reshape(b, k, n), lab2.reshape(b, k, n),
            need_chase.reshape(b, k), direct.reshape(b, k))


def _escape_opening(cfg: GoConfig, state: GoState, gd: GroupData,
                    move_pt, prey_pt, valid):
    """Escape opening: extend the atari group at its last liberty and
    recount. Only extensions landing on exactly 2 liberties need a
    chase; ``L >= 3`` is a decided escape (``direct``)."""
    b, k = move_pt.shape
    n = cfg.num_points
    board, labels, libs, me = _lanes_of(state, gd, k)
    mv, pr, ok = move_pt.reshape(-1), prey_pt.reshape(-1), valid.reshape(-1)
    _, placed, cap0 = _place(cfg, board, labels, libs, mv, me)
    live = ok & placed
    b1r, lab1 = _relabel_place(cfg, board, labels, mv, me, cap0, live)
    libs1 = lib_counts_from_labels(cfg, b1r, lab1)
    libs_pr = torch.where(_at(b1r, pr) == me,
                          libs1.gather(1, lab1.long().gather(
                              1, pr.long()[:, None]))[:, 0], 0)
    need_chase = live & (libs_pr == 2)
    direct = live & (libs_pr >= 3)
    return (b1r.reshape(b, k, n), lab1.reshape(b, k, n),
            need_chase.reshape(b, k), direct.reshape(b, k))


def _plane(cfg: GoConfig, move_pt, value):
    """bool ``[B, N]``: OR of ``value`` scattered at ``move_pt``."""
    b = move_pt.shape[0]
    out = torch.zeros((b, cfg.num_points), dtype=torch.int8,
                      device=move_pt.device)
    return out.scatter_reduce(1, move_pt, value.to(torch.int8),
                              reduce="amax") > 0


def ladder_capture_plane(cfg: GoConfig, state: GoState, gd: GroupData,
                         legal, depth: int = 40, lanes: int = 16,
                         chase_slots: int = 6) -> torch.Tensor:
    """bool ``[B, N]``: legal moves that ladder-capture an adjacent
    two-liberty opponent group (single-plane encodes; the full encoder
    reads both planes through :func:`ladder_planes`)."""
    move_pt, prey_pt, valid = _candidate_lanes(
        cfg, state, gd, legal, prey_libs=2, prey_is_opp=True, lanes=lanes)
    b2r, lab2, need, direct = _capture_opening(cfg, state, gd, move_pt,
                                               prey_pt, valid)
    chased, _ = _compacted_chase(cfg, b2r, lab2, prey_pt, need, depth,
                                 chase_slots)
    return _plane(cfg, move_pt, (direct | (need & chased)) & valid)


def ladder_escape_plane(cfg: GoConfig, state: GoState, gd: GroupData,
                        legal, depth: int = 40, lanes: int = 16,
                        chase_slots: int = 6) -> torch.Tensor:
    """bool ``[B, N]``: legal moves that rescue an own group in atari
    from a ladder; an overflowed (unread) chase stays False."""
    move_pt, prey_pt, valid = _candidate_lanes(
        cfg, state, gd, legal, prey_libs=1, prey_is_opp=False, lanes=lanes)
    b1r, lab1, need, direct = _escape_opening(cfg, state, gd, move_pt,
                                              prey_pt, valid)
    chased, covered = _compacted_chase(cfg, b1r, lab1, prey_pt, need,
                                       depth, chase_slots)
    return _plane(cfg, move_pt,
                  (direct | (need & covered & ~chased)) & valid)


def ladder_planes(cfg: GoConfig, state: GoState, gd: GroupData, legal,
                  depth: int = 40, lanes: int = 16, chase_slots: int = 6):
    """Both ladder planes from one shared read: ``(ladder_capture [B,
    N], ladder_escape [B, N])``. Candidates are gated by the ladder
    precondition, openings gate which lanes need a chase, and the
    surviving capture and escape lanes share ``chase_slots`` slots per
    game (capture lanes first) in one chase call. Overflow beyond the
    slots reads the conservative False on both planes."""
    analysis = neighbor_analysis(cfg, state.board, gd.labels)
    cap_mv, cap_pr, cap_ok = _candidate_lanes(
        cfg, state, gd, legal, prey_libs=2, prey_is_opp=True,
        lanes=lanes, analysis=analysis)
    esc_mv, esc_pr, esc_ok = _candidate_lanes(
        cfg, state, gd, legal, prey_libs=1, prey_is_opp=False,
        lanes=lanes, analysis=analysis)
    cap_b, cap_l, cap_need, cap_direct = _capture_opening(
        cfg, state, gd, cap_mv, cap_pr, cap_ok)
    esc_b, esc_l, esc_need, esc_direct = _escape_opening(
        cfg, state, gd, esc_mv, esc_pr, esc_ok)
    chased, covered = _compacted_chase(
        cfg, torch.cat([cap_b, esc_b], dim=1),
        torch.cat([cap_l, esc_l], dim=1),
        torch.cat([cap_pr, esc_pr], dim=1),
        torch.cat([cap_need, esc_need], dim=1), depth, chase_slots)
    cap_chased, esc_chased = chased[:, :lanes], chased[:, lanes:]
    esc_cov = covered[:, lanes:]
    captured = cap_direct | (cap_need & cap_chased)
    escaped = esc_direct | (esc_need & esc_cov & ~esc_chased)
    return (_plane(cfg, cap_mv, captured & cap_ok),
            _plane(cfg, esc_mv, escaped & esc_ok))
