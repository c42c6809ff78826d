"""Batched 48-plane encoder: the port of ``features/planes.py``.

Planes come out NHWC float32 ``[B, size, size, F]``, bit-identical to
the reference's ``encode`` (``tests/test_torch_features.py``). The
capture-size / self-atari / liberties-after planes come from bitmap
algebra on the group analysis instead of simulating every candidate
move; the merged-group and captured-point bitmaps are PACKED, 32 cells
per word (bit ``c % 32`` of word ``c // 32`` is cell ``c``). The words
are uint32 in the reference; here they are int64 holding uint32 values,
masked back to 32 bits after every left shift and complement.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from rocalphago_tpu_torch.engine.torchgo import (
    GoConfig,
    GoState,
    GroupData,
    diagonals_for,
    group_data,
    legal_mask,
    neighbor_analysis,
    neighbors_for,
    pad_points,
)
from rocalphago_tpu_torch.features import ladders as _ladders
from rocalphago_tpu_torch.features.pyfeatures import DEFAULT_FEATURES

_M32 = 0xFFFFFFFF


class CandidateInfo(NamedTuple):
    """Per-candidate-move analysis (valid where the move is legal)."""

    capture_size: torch.Tensor    # int32 [B, N] opponent stones captured
    own_size_after: torch.Tensor  # int32 [B, N] own merged-group size
    libs_after: torch.Tensor      # int32 [B, N] own merged-group liberties
    legal: torch.Tensor           # bool  [B, N] board moves only


@functools.lru_cache(maxsize=None)
def _packed_consts_np(size: int):
    n = size * size
    w = (n + 31) // 32
    cells = np.arange(n)
    word = cells // 32
    bit = np.int64(1) << (cells % 32).astype(np.int64)
    eye = np.zeros((n, w), np.int64)
    eye[cells, word] = bit
    notcol0 = np.zeros((w,), np.int64)
    notcol_last = np.zeros((w,), np.int64)
    for c in cells:
        if c % size != 0:
            notcol0[c // 32] |= np.int64(1) << np.int64(c % 32)
        if c % size != size - 1:
            notcol_last[c // 32] |= np.int64(1) << np.int64(c % 32)
    return word, bit, eye, notcol0, notcol_last


@functools.lru_cache(maxsize=None)
def _packed_consts(size: int, device: str):
    """(word index [N], bit value [N], packed identity rows [N, W],
    not-col-0 [W], not-col-last [W]) as int64 tensors on ``device``."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in _packed_consts_np(size))


def _packed_shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """Shift packed bitstreams ``[..., W]`` toward HIGHER cell indices
    by ``k`` bits (negative = lower), zero-filled; ``0 < |k| < 32``."""
    zero = torch.zeros_like(x[..., :1])
    if k > 0:
        prev = torch.cat([zero, x[..., :-1]], dim=-1)
        return ((x << k) | (prev >> (32 - k))) & _M32
    nxt = torch.cat([x[..., 1:], zero], dim=-1)
    return ((x >> -k) | (nxt << (32 + k))) & _M32


def _packed_dilate(size: int, x: torch.Tensor) -> torch.Tensor:
    """Packed 4-neighborhood dilation: N/S by ±size bits, E/W by ±1
    with the row edges masked."""
    *_, notcol0, notcol_last = _packed_consts(size, str(x.device))
    return (x | _packed_shift(x, size) | _packed_shift(x, -size)
            | (_packed_shift(x, 1) & notcol0)
            | (_packed_shift(x, -1) & notcol_last))


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit value held in an int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def candidate_info(cfg: GoConfig, state: GoState,
                   gd: GroupData) -> CandidateInfo:
    """Exact capture/merge/liberty analysis of every candidate move,
    on packed bitmaps built straight from ``gd.labels``."""
    n = cfg.num_points
    board = state.board
    b = board.shape[0]
    me = state.turn[:, None, None]
    empty = board == 0
    word, bitval, eye_p, _, _ = _packed_consts(cfg.size, str(board.device))
    w = eye_p.shape[-1]

    nbr_color, nbr_root, uniq, _ = neighbor_analysis(cfg, board, gd.labels)
    flat_root = nbr_root.reshape(b, -1)
    nbr_libs = gd.lib_counts.gather(1, flat_root).reshape(b, n, 4)
    nbr_sizes = gd.sizes.gather(1, flat_root).reshape(b, n, 4)
    own_k = uniq & (nbr_color == me)
    cap_k = uniq & (nbr_color == -me) & (nbr_libs == 1)
    capture_size = (cap_k * nbr_sizes).sum(dim=2)
    own_size_after = 1 + (own_k * nbr_sizes).sum(dim=2)

    # packed member rows per group (row N = the empty sentinel = 0);
    # distinct bits of a word never collide, so add is bitwise-or
    member_p = torch.zeros((b, (n + 1) * w), dtype=torch.int64,
                           device=board.device)
    member_p.scatter_add_(1, gd.labels.long() * w + word,
                          torch.where(~empty, bitval, 0))
    member_p = member_p.reshape(b, n + 1, w)
    member_p[:, n] = 0
    nbr_member_p = member_p.gather(
        1, flat_root[:, :, None].expand(-1, -1, w)).reshape(b, n, 4, w)
    own_sel = torch.where(own_k[..., None], nbr_member_p, 0)
    cap_sel = torch.where(cap_k[..., None], nbr_member_p, 0)
    merged = (eye_p | own_sel[:, :, 0] | own_sel[:, :, 1]
              | own_sel[:, :, 2] | own_sel[:, :, 3])           # [B, N, W]
    cap_pts = (cap_sel[:, :, 0] | cap_sel[:, :, 1] | cap_sel[:, :, 2]
               | cap_sel[:, :, 3])

    empty_p = torch.zeros((b, w), dtype=torch.int64, device=board.device)
    empty_p.scatter_add_(1, word.expand(b, -1),
                         torch.where(empty, bitval, 0))
    new_empty = (empty_p[:, None, :] & (~eye_p & _M32)) | cap_pts
    dilated = _packed_dilate(cfg.size, merged)
    libs_after = _popcount32(dilated & new_empty).sum(dim=2)

    legal = legal_mask(cfg, state, gd)[:, :n]
    return CandidateInfo(capture_size.int(), own_size_after.int(),
                         libs_after.int(), legal)


def true_eyes(cfg: GoConfig, state: GoState,
              owner: torch.Tensor) -> torch.Tensor:
    """bool ``[B, N]``: empty points that are true eyes of ``owner``
    ``[B]`` (the diagonal rule of ``pygo.GameState.is_eye``)."""
    n = cfg.num_points
    nbrs = neighbors_for(cfg.size, state.board.device)
    diags = diagonals_for(cfg.size, state.board.device)
    board_pad = pad_points(state.board, 0)
    owner = owner[:, None, None]
    eyeish = (state.board == 0) & ((board_pad[:, nbrs] == owner)
                                   | (nbrs >= n)).all(dim=2)
    valid_d = diags < n
    bad = (valid_d & (board_pad[:, diags] == -owner)).sum(dim=2)
    off_board = 4 - valid_d.sum(dim=1)
    return eyeish & torch.where(off_board > 0, bad == 0, bad <= 1)


def _one_hot8(value: torch.Tensor, lo: int,
              active: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` int → ``[B, N, 8]`` one-hot of ``clip(value - lo, 0,
    7)``, zeroed where ``active`` is False."""
    idx = torch.clamp(value - lo, 0, 7).long()
    return F.one_hot(idx, 8).float() * active[..., None].float()


def needs_candidates(features: tuple) -> bool:
    """Whether these features need :func:`candidate_info`."""
    return any(f in ("capture_size", "self_atari_size",
                     "liberties_after") for f in features)


def encode_analysis(cfg: GoConfig, state: GoState, features: tuple,
                    gd: GroupData | None = None):
    """``(gd, ci, legal)``: the group data on the carried labels, the
    candidate-move info (None when unneeded) and board-move legality."""
    n = cfg.num_points
    if gd is None:
        gd = group_data(cfg, state.board, with_zxor=cfg.enforce_superko,
                        labels=state.labels)
    ci = None
    if needs_candidates(features):
        ci = candidate_info(cfg, state, gd)
        legal = ci.legal
    else:
        legal = legal_mask(cfg, state, gd)[:, :n]
    return gd, ci, legal


def assemble_planes(cfg: GoConfig, state: GoState, features: tuple,
                    gd: GroupData, ci, legal, lad_cap, lad_esc,
                    lad_kw: dict) -> torch.Tensor:
    """Stack the requested plane groups → ``[B, size, size, F]``; a
    ladder plane not passed in is read on its own here."""
    n = cfg.num_points
    board = state.board
    b = board.shape[0]
    me = state.turn[:, None]
    empty = board == 0
    has_stone = ~empty
    dev = board.device

    out = []
    for name in features:
        if name == "board":
            f = torch.stack([board == me, board == -me, empty],
                            dim=-1).float()
        elif name == "ones":
            f = torch.ones((b, n, 1), device=dev)
        elif name == "turns_since":
            age = state.step_count[:, None] - 1 - state.stone_ages
            f = _one_hot8(age, 0, has_stone & (state.stone_ages >= 0))
        elif name == "liberties":
            libs = gd.lib_counts.gather(1, gd.labels.long())
            f = _one_hot8(libs, 1, has_stone)
        elif name == "capture_size":
            f = _one_hot8(ci.capture_size, 0, legal)
        elif name == "self_atari_size":
            f = _one_hot8(ci.own_size_after, 1, legal & (ci.libs_after == 1))
        elif name == "liberties_after":
            f = _one_hot8(ci.libs_after, 1, legal)
        elif name == "ladder_capture":
            cap = (lad_cap if lad_cap is not None
                   else _ladders.ladder_capture_plane(
                       cfg, state, gd, legal, **lad_kw))
            f = cap.float()[..., None]
        elif name == "ladder_escape":
            esc = (lad_esc if lad_esc is not None
                   else _ladders.ladder_escape_plane(
                       cfg, state, gd, legal, **lad_kw))
            f = esc.float()[..., None]
        elif name == "sensibleness":
            f = (legal & ~true_eyes(cfg, state, state.turn)).float()[..., None]
        elif name == "zeros":
            f = torch.zeros((b, n, 1), device=dev)
        elif name == "color":
            f = (me == 1).float()[..., None].expand(b, n, 1)
        else:
            raise KeyError(f"unknown feature {name!r}")
        out.append(f)
    return torch.cat(out, dim=-1).reshape(b, cfg.size, cfg.size, -1)


def encode(cfg: GoConfig, states: GoState, features: tuple = None,
           ladder_depth: int = 40, ladder_lanes: int = 16,
           ladder_chase_slots: int = 6,
           gd: GroupData | None = None) -> torch.Tensor:
    """Encode a batch of states → float32 ``[B, size, size, F]``
    (NHWC). When both ladder planes are requested they come from one
    shared read (:func:`ladders.ladder_planes`)."""
    if features is None:
        features = DEFAULT_FEATURES
    gd, ci, legal = encode_analysis(cfg, states, features, gd)
    lad_cap = lad_esc = None
    lad_kw = dict(depth=ladder_depth, lanes=ladder_lanes,
                  chase_slots=ladder_chase_slots)
    if "ladder_capture" in features and "ladder_escape" in features:
        lad_cap, lad_esc = _ladders.ladder_planes(cfg, states, gd, legal,
                                                  **lad_kw)
    return assemble_planes(cfg, states, features, gd, ci, legal,
                           lad_cap, lad_esc, lad_kw)
