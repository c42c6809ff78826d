"""Batched Go engine on tensors: the port of ``engine/jaxgo.py``.

Every function takes a leading batch dimension written out (the
reference ``vmap``-s single-game functions instead): boards are int8
``[B, N]`` with ``N = size * size``, per-game scalars are ``[B]``.
Rules semantics are the reference's (suicide illegal, simple ko
always, optional positional superko, area scoring), and every integer
output -- labels, liberty counts, group sizes, per-group Zobrist XORs,
legality -- is bit-identical to it (``tests/test_torch_engine.py``).

State construction (:func:`new_states`, :func:`from_pygo` from the
host oracle), the full flood fill (:func:`compute_labels`, which is the
labels kernel of :mod:`rocalphago_tpu_torch.ops.labels`), the loop-free
group analysis on carried labels, legality, stepping (:func:`step`),
the eval signature and area scoring (:func:`area_scores`, whose empty
regions are one more labels launch). No function here reads a tensor
back to the host, so a batch of searches steps, scores and analyses
its leaves without a device→host sync.

Zobrist hashes are uint32 pairs in the reference. Torch's ``uint32``
supports few operations, so the port holds them in int64 tensors whose
values stay in ``[0, 2**32)``: XOR of two such values stays in range.

The group analysis uses the scatter formulation (the reference's CPU
default, ``jaxgo._dense_engine() == False``); a dense variant would
need its own measurement on the card first.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from rocalphago_tpu_torch.engine import zobrist as zobrist_tables

BLACK = 1
WHITE = -1

_NBR_SHIFTS = ((1, 0), (-1, 0), (0, 1), (0, -1))
_DIAG_SHIFTS = ((1, 1), (1, -1), (-1, 1), (-1, -1))


@dataclasses.dataclass(frozen=True)
class GoConfig:
    """Static engine parameters (the reference's ``jaxgo.GoConfig``)."""

    size: int = 19
    komi: float = 7.5
    enforce_superko: bool = False
    # ring-buffer length for positional-superko hashes
    max_history: int = 512

    @property
    def num_points(self) -> int:
        return self.size * self.size


def default_komi(size: int) -> float:
    """Standard area-scoring komi per board size: 7.5 for 13×13 and
    up (the 19×19 value), 7.0 below (the CGOS 9×9 convention). The
    trainers and the value-corpus generator score with it unless told
    otherwise (a net's spec always carries the 19×19 value)."""
    return 7.5 if size >= 13 else 7.0


class GoState(NamedTuple):
    """A batch of games; every field has the batch as leading dim."""

    board: torch.Tensor         # int8 [B, N]  0 empty, +1 black, -1 white
    turn: torch.Tensor          # int8 [B]     player to move (+1/-1)
    ko: torch.Tensor            # int32 [B]    point banned by simple ko, -1
    pass_count: torch.Tensor    # int8 [B]     consecutive passes
    done: torch.Tensor          # bool [B]
    step_count: torch.Tensor    # int32 [B]    moves played (incl. passes)
    hash: torch.Tensor          # int64 [B, 2] uint32 Zobrist hash words
    hash_history: torch.Tensor  # int64 [B, H, 2] ring buffer of hashes
    stone_ages: torch.Tensor    # int32 [B, N] step a stone was placed, -1
    prisoners: torch.Tensor     # int32 [B, 2] stones captured from [b, w]
    labels: torch.Tensor        # int32 [B, N] min flat index per group,
    #   sentinel N for empty -- always equal to compute_labels(board)


class GroupData(NamedTuple):
    """Whole-board group analysis; ``G = N + 1`` rows per game (one per
    possible root plus the sentinel row ``N``)."""

    labels: torch.Tensor              # int32 [B, N]
    sizes: torch.Tensor | None        # int32 [B, G]
    lib_counts: torch.Tensor          # int32 [B, G]
    member: torch.Tensor | None       # bool  [B, G, N]
    zxor: torch.Tensor | None         # int64 [B, G, 2] uint32 words


# --------------------------------------------------------------------------
# static per-size tables
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _tables_np(size: int):
    """(neighbors [N,4], diagonals [N,4]) as numpy; ``N`` off-board."""
    n = size * size
    neighbors = np.full((n, 4), n, dtype=np.int64)
    diagonals = np.full((n, 4), n, dtype=np.int64)
    for x in range(size):
        for y in range(size):
            p = x * size + y
            for k, (dx, dy) in enumerate(_NBR_SHIFTS):
                nx, ny = x + dx, y + dy
                if 0 <= nx < size and 0 <= ny < size:
                    neighbors[p, k] = nx * size + ny
            for k, (dx, dy) in enumerate(_DIAG_SHIFTS):
                nx, ny = x + dx, y + dy
                if 0 <= nx < size and 0 <= ny < size:
                    diagonals[p, k] = nx * size + ny
    return neighbors, diagonals


@functools.lru_cache(maxsize=None)
def _table(name: str, size: int, device: str) -> torch.Tensor:
    n = size * size
    if name == "neighbors":
        t = _tables_np(size)[0]
    elif name == "neighbors_padded":
        # row N (the "no point" index) has no neighbors
        t = np.concatenate([_tables_np(size)[0],
                            np.full((1, 4), n, np.int64)])
    elif name == "diagonals":
        t = _tables_np(size)[1]
    else:
        t = zobrist_tables.position_table(size).astype(np.int64)
    return torch.as_tensor(t, device=device)


def neighbors_for(size: int, device) -> torch.Tensor:
    """int64 ``[N, 4]`` neighbor indices, ``N`` off-board."""
    return _table("neighbors", size, str(device))


def neighbors_padded(size: int, device) -> torch.Tensor:
    """int64 ``[N + 1, 4]``: :func:`neighbors_for` plus an all-``N`` row
    so that index ``N`` (nowhere) can be looked up too."""
    return _table("neighbors_padded", size, str(device))


def diagonals_for(size: int, device) -> torch.Tensor:
    return _table("diagonals", size, str(device))


def zobrist_for(size: int, device) -> torch.Tensor:
    """int64 ``[N, 2, 2]`` position keys (uint32 values)."""
    return _table("zobrist", size, str(device))


def pad_points(x: torch.Tensor, value) -> torch.Tensor:
    """Append one column holding ``value`` to the last (points) axis,
    so that gathers at index ``N`` read the sentinel."""
    col = torch.full(x.shape[:-1] + (1,), value, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, col], dim=-1)


def _color_idx(color: torch.Tensor) -> torch.Tensor:
    """±1 color → 0/1 index into the Zobrist table."""
    return ((1 - color.long()) // 2)


# --------------------------------------------------------------------------
# state construction
# --------------------------------------------------------------------------


def new_states(cfg: GoConfig, batch: int, *, device) -> GoState:
    """A batch of fresh games on ``device`` (every field materialised,
    so the batch can be written in place)."""
    n, h = cfg.num_points, cfg.max_history

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return GoState(
        board=full((batch, n), 0, torch.int8),
        turn=full((batch,), BLACK, torch.int8),
        ko=full((batch,), -1, torch.int32),
        pass_count=full((batch,), 0, torch.int8),
        done=full((batch,), False, torch.bool),
        step_count=full((batch,), 0, torch.int32),
        hash=full((batch, 2), 0, torch.int64),
        hash_history=full((batch, h, 2), 0, torch.int64),
        stone_ages=full((batch, n), -1, torch.int32),
        prisoners=full((batch, 2), 0, torch.int32),
        labels=full((batch, n), n, torch.int32))


def from_pygo(cfg: GoConfig, states, *, device, with_history: bool = True,
              with_labels: bool = True) -> GoState:
    """Host :class:`pygo.GameState` (one, or a list) → a batched
    :class:`GoState` on ``device``.

    Hashes and the superko history are carried over from pygo's
    incremental hashes (the most recent ``cfg.max_history`` kept,
    placed so the engine's future writes evict the oldest first).
    ``with_labels=False`` leaves the labels all-sentinel (INVALID
    until :func:`seed_labels` refills the whole batch in one kernel
    launch -- the host BFS per state is what that saves)."""
    if not isinstance(states, (list, tuple)):
        states = [states]
    n = cfg.num_points
    h = cfg.max_history
    b = len(states)
    board = np.zeros((b, n), np.int8)
    turn = np.zeros((b,), np.int8)
    ko = np.full((b,), -1, np.int32)
    passes = np.zeros((b,), np.int8)
    done = np.zeros((b,), bool)
    steps = np.zeros((b,), np.int32)
    hashes = np.zeros((b, 2), np.int64)
    hist = np.zeros((b, h, 2), np.int64)
    ages = np.zeros((b, n), np.int32)
    prisoners = np.zeros((b, 2), np.int32)
    lab = np.full((b, n), n, np.int32)
    nbrs = _tables_np(cfg.size)[0]
    for i, st in enumerate(states):
        board[i] = np.asarray(st.board, np.int8).reshape(-1)
        if with_history:
            seen = [np.frombuffer(k, dtype=np.uint32)
                    for k in st._hash_history.keys()]
            for j, key in enumerate(reversed(seen[-h:])):
                hist[i, (st.turns_played - 1 - j) % h] = key
        if st.ko is not None:
            ko[i] = st.ko[0] * cfg.size + st.ko[1]
        if st.history and st.history[-1] is None:
            passes[i] = 2 if (len(st.history) > 1
                              and st.history[-2] is None) else 1
        turn[i] = st.current_player
        done[i] = st.is_end_of_game
        steps[i] = st.turns_played
        hashes[i] = np.asarray(st.zobrist_hash, np.uint32)
        ages[i] = np.asarray(st.stone_ages, np.int32).reshape(-1)
        prisoners[i] = (st.num_black_prisoners, st.num_white_prisoners)
        if with_labels:
            # host min-root BFS: an ascending scan seeds each group at
            # its minimum flat index
            bd = board[i]
            for p in range(n):
                if bd[p] != 0 and lab[i, p] == n:
                    lab[i, p] = p
                    stack = [p]
                    while stack:
                        q = stack.pop()
                        for r in nbrs[q]:
                            if r < n and bd[r] == bd[p] and lab[i, r] == n:
                                lab[i, r] = p
                                stack.append(r)

    def t(x):
        return torch.as_tensor(x, device=device)

    return GoState(board=t(board), turn=t(turn), ko=t(ko),
                   pass_count=t(passes), done=t(done), step_count=t(steps),
                   hash=t(hashes), hash_history=t(hist),
                   stone_ages=t(ages), prisoners=t(prisoners),
                   labels=t(lab))


# --------------------------------------------------------------------------
# group analysis
# --------------------------------------------------------------------------


def compute_labels(cfg: GoConfig, boards: torch.Tensor) -> torch.Tensor:
    """Connected-component root (min flat index) per point, ``N`` for
    empty: int8 ``[B, N]`` → int32 ``[B, N]``. On a CUDA tensor this is
    one launch of the labels kernel (:mod:`..ops.labels`)."""
    from rocalphago_tpu_torch.ops import labels as _labels

    return _labels.labels(boards.contiguous(), cfg.size)


def seed_labels(cfg: GoConfig, states: GoState) -> GoState:
    """Recompute the carried labels of a batched state in one fill
    (pairs with ``from_pygo(..., with_labels=False)``)."""
    return states._replace(labels=compute_labels(cfg, states.board))


def _dedup_mask(roots: torch.Tensor) -> torch.Tensor:
    """True at the first occurrence of each value along the last axis
    (K ≤ 4 neighbor roots) -- the dedup convention every caller of
    :func:`neighbor_analysis` shares."""
    k = roots.shape[-1]
    eq = roots[..., :, None] == roots[..., None, :]
    earlier = torch.ones((k, k), dtype=torch.bool,
                         device=roots.device).tril(-1)
    return ~(eq & earlier).any(dim=-1)


def neighbor_analysis(cfg: GoConfig, board: torch.Tensor,
                      labels: torch.Tensor):
    """``(nbr_color [B,N,4], nbr_root [B,N,4] int64, uniq [B,N,4],
    valid [N,4])``: off-board neighbors read color 0 and root ``N``;
    ``uniq`` marks the first occurrence of each root among a point's
    neighbors."""
    n = cfg.num_points
    nbrs = neighbors_for(cfg.size, board.device)
    nbr_color = pad_points(board, 0)[:, nbrs]
    nbr_root = pad_points(labels.long(), n)[:, nbrs]
    return nbr_color, nbr_root, _dedup_mask(nbr_root), nbrs < n


def relabel_after_place(cfg: GoConfig, board: torch.Tensor,
                        labels: torch.Tensor, pt: torch.Tensor,
                        color: torch.Tensor,
                        cap_mask: torch.Tensor) -> torch.Tensor:
    """Labels after each row places ``color[i]`` at ``pt[i]`` and
    removes ``cap_mask[i]`` -- exact with no flood fill, because a
    placement only merges groups (the min of min-rooted groups ∪ {pt})
    and a capture removes whole groups (reset to ``N``). ``pt`` must
    be a board point (< N)."""
    n = cfg.num_points
    nbrs = neighbors_padded(cfg.size, board.device)
    my = nbrs[pt.long()]                                      # [L, 4]
    same = (my < n) & (pad_points(board, 0).gather(1, my)
                       == color.to(board.dtype)[:, None])
    roots = torch.where(same, pad_points(labels, n).gather(1, my), n)
    new_root = torch.minimum(roots.min(dim=1).values, pt.to(labels.dtype))
    merged = (labels[:, :, None] == torch.where(
        same, roots, -2)[:, None, :]).any(dim=2)
    at_pt = torch.arange(n, device=board.device)[None, :] == pt[:, None]
    labels1 = torch.where(merged | at_pt, new_root[:, None], labels)
    return torch.where(cap_mask, n, labels1).to(labels.dtype)


def lib_counts_from_labels(cfg: GoConfig, board: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
    """int32 ``[B, N + 1]`` distinct-liberty count per group root (row
    ``N`` is 0): each empty point adds one to each distinct adjacent
    group."""
    n = cfg.num_points
    b = board.shape[0]
    empty = board == 0
    _, nbr_root, uniq, _ = neighbor_analysis(cfg, board, labels)
    contrib = empty[:, :, None] & uniq & (nbr_root < n)
    idx = torch.where(contrib, nbr_root, n).reshape(b, -1)
    out = torch.zeros((b, n + 1), dtype=torch.int32, device=board.device)
    out.scatter_add_(1, idx, contrib.reshape(b, -1).int())
    out[:, n] = 0
    return out


def group_data(cfg: GoConfig, board: torch.Tensor, *,
               with_member: bool = False, with_zxor: bool = False,
               labels: torch.Tensor | None = None) -> GroupData:
    """Group analysis of a batch of boards: sizes and distinct-liberty
    counts per root, plus the membership bitmap and per-group Zobrist
    XORs on request. Pass the carried ``labels`` to skip the fill."""
    n = cfg.num_points
    b = board.shape[0]
    if labels is None:
        labels = compute_labels(cfg, board)
    stone = board != 0
    sizes = torch.zeros((b, n + 1), dtype=torch.int32, device=board.device)
    sizes.scatter_add_(1, labels.long(), stone.int())
    lib_counts = lib_counts_from_labels(cfg, board, labels)
    member = zxor = None
    if with_member or with_zxor:
        roots = torch.arange(n + 1, device=board.device)
        member = ((labels[:, None, :] == roots[None, :, None])
                  & stone[:, None, :])                      # [B, G, N]
    if with_zxor:
        # per-group XOR of member keys as GF(2) parity of a 0/1
        # product; float32 sums of at most N ones are exact
        zob = zobrist_for(cfg.size, board.device)
        key = torch.where((board == BLACK)[:, :, None], zob[None, :, 0],
                          zob[None, :, 1])                  # [B, N, 2]
        bits = _unpack_bits(key).float()                    # [B, N, 64]
        parity = torch.remainder(member.float() @ bits, 2) > 0.5
        zxor = _pack_bits(parity)
        if not with_member:
            member = None
    return GroupData(labels, sizes, lib_counts, member, zxor)


def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """uint32 words (in int64) ``[..., W]`` → bool ``[..., W*32]``,
    little-endian bit order."""
    shifts = torch.arange(32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1).bool()


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool ``[..., W*32]`` → uint32 words (in int64) ``[..., W]``."""
    shifts = torch.arange(32, device=bits.device)
    words = bits.reshape(*bits.shape[:-1], -1, 32).long()
    return (words << shifts).sum(dim=-1)


def _xor_reduce_masked(keys: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """XOR of ``keys[..., i, :]`` (uint32 pairs in int64) where
    ``mask[..., i]``, by bit parity."""
    bits = _unpack_bits(keys) & mask[..., None]
    parity = bits.sum(dim=-2) % 2
    return _pack_bits(parity.bool())


# --------------------------------------------------------------------------
# legality
# --------------------------------------------------------------------------


def legal_mask(cfg: GoConfig, state: GoState,
               gd: GroupData | None = None) -> torch.Tensor:
    """bool ``[B, N + 1]`` over actions (last = pass, legal while the
    game is live); matches ``pygo.GameState.is_legal`` including
    positional superko when ``cfg.enforce_superko``."""
    n = cfg.num_points
    if gd is None:
        gd = group_data(cfg, state.board, with_zxor=cfg.enforce_superko,
                        labels=state.labels)
    board = state.board
    me = state.turn[:, None, None]
    empty = board == 0
    nbr_color, nbr_root, uniq, valid = neighbor_analysis(cfg, board,
                                                         gd.labels)
    b = board.shape[0]
    nbr_libs = gd.lib_counts.gather(1, nbr_root.reshape(b, -1)) \
        .reshape(nbr_root.shape)
    has_empty_nbr = (valid & (nbr_color == 0)).any(dim=2)
    own_safe = (valid & (nbr_color == me) & (nbr_libs >= 2)).any(dim=2)
    captures = valid & (nbr_color == -me) & (nbr_libs == 1)
    ok = empty & (has_empty_nbr | own_safe | captures.any(dim=2))
    ok = ok & (torch.arange(n, device=board.device)[None, :]
               != state.ko[:, None])
    if cfg.enforce_superko:
        zob = zobrist_for(cfg.size, board.device)
        ci = _color_idx(state.turn)
        cap_keys = gd.zxor.gather(
            1, nbr_root.reshape(b, -1, 1).expand(-1, -1, 2)
        ).reshape(b, n, 4, 2)
        cap_xor = _xor_reduce_masked(cap_keys, captures & uniq)  # [B,N,2]
        cand = (state.hash[:, None, :] ^ zob.permute(1, 0, 2)[ci]
                ^ cap_xor)
        seen = (cand[:, :, None, :] == state.hash_history[:, None, :, :]
                ).all(dim=-1).any(dim=-1)
        ok = ok & ~seen
    live = ~state.done[:, None]
    return torch.cat([ok & live, live], dim=1)


# --------------------------------------------------------------------------
# eval signature
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _signature_tables(size: int, device: str):
    """The eval-signature key families as int64 tensors on ``device``."""
    return zobrist_tables.SignatureTables(*(
        torch.as_tensor(t.astype(np.int64), device=device)
        for t in zobrist_tables.signature_tables(size)))


def eval_signature(cfg: GoConfig, state: GoState) -> torch.Tensor:
    """int64 ``[B, 2]`` (uint32 words) key under which the evaluation of
    each state may be cached: the carried position hash XOR one
    age-bucket key per stone XOR the ko, turn and done keys -- every
    input of the feature planes and the terminal value, as in the
    reference. Not valid under ``cfg.enforce_superko``."""
    n = cfg.num_points
    tabs = _signature_tables(cfg.size, str(state.board.device))
    bucket = torch.clamp(state.step_count[:, None] - 1 - state.stone_ages,
                         0, zobrist_tables.AGE_BUCKETS - 1).long()
    iota = torch.arange(n, device=state.board.device)
    keys = tabs.age[iota[None, :], bucket]                   # [B, N, 2]
    occupied = (state.board != 0) & (state.stone_ages >= 0)
    sig = state.hash ^ _xor_reduce_masked(keys, occupied)
    sig = sig ^ tabs.ko[state.ko.long() + 1]
    sig = sig ^ torch.where((state.turn == WHITE)[:, None], tabs.turn, 0)
    return sig ^ torch.where(state.done[:, None], tabs.done, 0)


# --------------------------------------------------------------------------
# step
# --------------------------------------------------------------------------


def where_rows(cond: torch.Tensor, new: GoState, old: GoState) -> GoState:
    """Per-row select of two batched states: row ``i`` of ``new`` where
    ``cond[i]``, else of ``old``."""
    return GoState(*(torch.where(cond.view((-1,) + (1,) * (a.dim() - 1)),
                                 a, b) for a, b in zip(new, old)))


def _set_history(cfg: GoConfig, state: GoState,
                 key: torch.Tensor) -> torch.Tensor:
    """``hash_history`` with ``key`` written at slot ``step_count % H``
    of each row."""
    slot = (state.step_count.long() % cfg.max_history)
    at = torch.arange(cfg.max_history,
                      device=key.device)[None, :] == slot[:, None]
    return torch.where(at[:, :, None], key[:, None, :], state.hash_history)


def step(cfg: GoConfig, state: GoState, action: torch.Tensor,
         gd: GroupData | None = None) -> GoState:
    """Play ``action[i]`` (flat index, ``N`` = pass) for each row's
    player to move; the reference's ``jaxgo.step`` row by row. Assumes
    the action is legal; an action on an occupied point degrades to a
    pass, and a finished game is frozen (any action leaves it
    unchanged). Both branches are computed for every row and selected
    per row. Pass ``gd`` (the :func:`group_data` of ``state.board`` on
    its carried labels) to reuse an analysis already made."""
    n = cfg.num_points
    action = action.long()
    pt = torch.clamp(action, max=n - 1)
    occupied = state.board.gather(1, pt[:, None])[:, 0] != 0
    is_pass = (action >= n) | occupied
    new = where_rows(is_pass, _step_pass(cfg, state),
                     _step_place(cfg, state, pt, gd))
    return where_rows(state.done, state, new)


def _step_pass(cfg: GoConfig, state: GoState) -> GoState:
    pc = state.pass_count + 1
    return state._replace(
        turn=-state.turn,
        ko=torch.full_like(state.ko, -1),
        pass_count=pc,
        done=pc >= 2,
        step_count=state.step_count + 1,
        hash_history=_set_history(cfg, state, state.hash))


def _step_place(cfg: GoConfig, state: GoState, action: torch.Tensor,
                gd: GroupData | None = None) -> GoState:
    """Place a stone at board point ``action[i]`` (< N) of every row."""
    n = cfg.num_points
    board, me = state.board, state.turn
    if gd is None:
        gd = group_data(cfg, board, labels=state.labels)
    my = neighbors_for(cfg.size, board.device)[action]          # [B, 4]
    nbr_color = pad_points(board, 0).gather(1, my)
    nbr_root = pad_points(gd.labels.long(), n).gather(1, my)

    # opponent neighbour groups in atari: their one liberty is `action`
    cap_roots = torch.where(
        (nbr_color == -me[:, None])
        & (gd.lib_counts.gather(1, nbr_root) == 1), nbr_root, -2)
    captured = (gd.labels[:, :, None] == cap_roots[:, None, :]).any(dim=2)
    num_captured = captured.sum(dim=1, dtype=torch.int32)

    at = (torch.arange(n, device=board.device)[None, :]
          == action[:, None])
    board2 = torch.where(at, me[:, None], torch.where(captured, 0, board))

    # simple ko: a lone new stone, exactly one capture, one liberty left
    placed_alone = ~(nbr_color == me[:, None]).any(dim=1)
    p_libs = (pad_points(board2, 1).gather(1, my) == 0).sum(dim=1)
    ko_point = _first_true(captured)
    ko = torch.where((num_captured == 1) & placed_alone & (p_libs == 1),
                     ko_point, -1).int()

    zob = zobrist_for(cfg.size, board.device)
    ci = _color_idx(me)
    cap_keys = torch.where((me == BLACK)[:, None, None], zob[None, :, 1, :],
                           zob[None, :, 0, :])              # [B, N, 2]
    new_hash = (state.hash ^ zob[action, ci, :]
                ^ _xor_reduce_masked(cap_keys, captured))

    opp = torch.arange(2, device=board.device)[None, :] == _color_idx(
        -me)[:, None]
    prisoners = state.prisoners + torch.where(opp, num_captured[:, None], 0)
    ages = torch.where(at, state.step_count[:, None],
                       torch.where(captured, -1, state.stone_ages))
    return state._replace(
        board=board2,
        turn=-me,
        ko=ko,
        pass_count=torch.zeros_like(state.pass_count),
        step_count=state.step_count + 1,
        hash=new_hash,
        hash_history=_set_history(cfg, state, new_hash),
        stone_ages=ages,
        prisoners=prisoners.int(),
        labels=relabel_after_place(cfg, board, gd.labels, action, me,
                                   captured))


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True of each row, 0 when none (``argmax`` of
    a bool row)."""
    n = mask.shape[-1]
    idx = torch.where(mask, torch.arange(n, device=mask.device),
                      n).min(dim=-1).values
    return torch.where(idx == n, 0, idx)


# --------------------------------------------------------------------------
# scoring
# --------------------------------------------------------------------------


def territory(cfg: GoConfig, board: torch.Tensor):
    """``(terr_b, terr_w)`` bool ``[B, N]``: the empty points whose
    region borders only black stones, and only white ones. The regions
    are labelled by one :func:`compute_labels` call (one labels kernel
    launch on the card) over boards holding 9 where the point is empty
    and 0 elsewhere."""
    n = cfg.num_points
    b = board.shape[0]
    empty = board == 0
    region = compute_labels(cfg, torch.where(empty, 9, 0).to(torch.int8))
    nbr_color = pad_points(board, 0)[:, neighbors_for(cfg.size,
                                                      board.device)]
    region = region.long()

    def touches(color):
        pts = empty & (nbr_color == color).any(dim=2)
        by_region = torch.zeros((b, n + 1), dtype=torch.int8,
                                device=board.device).scatter_reduce(
            1, region, pts.to(torch.int8), reduce="amax") > 0
        return by_region.gather(1, region)

    t_b, t_w = touches(BLACK), touches(WHITE)
    return empty & t_b & ~t_w, empty & t_w & ~t_b


def area_scores(cfg: GoConfig, state: GoState):
    """Area scores ``(black, white + komi)``, float32 ``[B]`` each:
    empty regions bordering exactly one colour count for it
    (:func:`territory`)."""
    board = state.board
    terr_b, terr_w = territory(cfg, board)
    black = (board == BLACK).sum(dim=1) + terr_b.sum(dim=1)
    white = (board == WHITE).sum(dim=1) + terr_w.sum(dim=1)
    return black.float(), white.float() + cfg.komi


def winner(cfg: GoConfig, state: GoState) -> torch.Tensor:
    """int32 ``[B]``: +1 black wins, -1 white wins, 0 draw."""
    black, white = area_scores(cfg, state)
    return torch.sign(black - white).int()
