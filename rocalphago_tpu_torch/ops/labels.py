"""Group labelling: the CUDA kernel ``csrc/labels.cu``, its plain
PyTorch version and the wrapper the engine calls.

Replaces ``rocalphago_tpu/ops/labels.py::pallas_labels`` (the TPU
kernel) and is the function of ``jaxgo.compute_labels`` (its XLA twin):
int8 boards ``[B, N]`` → int32 ``[B, N]``, each point the minimum flat
index of its same-colour group, ``N`` for empty points. A point holds 0
(empty) or a colour, any value > 0 being one colour and any value < 0
the other: game boards hold -1, 0 and +1, and area scoring
(``torchgo.territory``, behind ``area_scores`` and
:func:`terminal_labels`) labels its empty regions on boards of 9 where
the point is empty and 0 elsewhere.

Bound on the card: latency of dependent iterations, not bytes or
operations -- see the note at the top of ``csrc/labels.cu`` for what
the kernel's design does about it (one warp per board, four boards per
block; thread ``r`` holds row ``r``'s colours as bitboards and its
labels in registers; an iteration is a min-scan along each row's runs
and a vertical exchange by warp shuffles, ended by ``__any_sync``; no
shared memory, no barrier). Boards are at most 32 wide: the launch
refuses a larger size and the wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch

from rocalphago_tpu_torch.ops import _build

#: launches of the CUDA kernel in this process (plain runs not counted)
launches = 0
#: this kernel's index in the per-thread launch counts
KERNEL = _build.SOURCES.index("labels")


def labels_plain(boards: torch.Tensor, size: int) -> torch.Tensor:
    """Plain PyTorch version: hook over same-colour neighbours, then a
    pointer jump, to a fixpoint (each fixpoint test syncs with the
    host -- fine on the CPU, which is where it runs)."""
    from rocalphago_tpu_torch.engine.torchgo import (
        neighbors_for,
        pad_points,
    )

    n = size * size
    nbrs = neighbors_for(size, boards.device)
    stone = boards != 0
    links = ((pad_points(boards, 0)[:, nbrs] == boards[:, :, None])
             & stone[:, :, None] & (nbrs < n))
    iota = torch.arange(n, device=boards.device)
    lab = torch.where(stone, iota, n)
    for _ in range(n):
        hook = torch.where(links, pad_points(lab, n)[:, nbrs], n)
        new = torch.minimum(lab, hook.min(dim=2).values)
        new = torch.minimum(new, pad_points(new, n).gather(1, new))
        if torch.equal(new, lab):
            break
        lab = new
    return lab.int()


def terminal_labels(cfg, state):
    """Auxiliary training targets from a batch of terminal positions
    (the reference's ``ops/labels.py::terminal_labels``, batched):
    ``(ownership int8 [B, N], score float32 [B])``, black-positive.
    Ownership is the area-scoring verdict per point: a stone's colour;
    for an empty point the colour its region borders when it borders
    only one, else 0 (dame, regions shared by both). Score is ``black -
    white - komi``, so ``sign(score) == torchgo.winner``. The regions
    are one labels launch on the card (``torchgo.territory``)."""
    from rocalphago_tpu_torch.engine.torchgo import BLACK, WHITE, territory

    board = state.board
    terr_b, terr_w = territory(cfg, board)
    ownership = board + terr_b.to(torch.int8) - terr_w.to(torch.int8)
    black = (board == BLACK).sum(dim=1) + terr_b.sum(dim=1)
    white = (board == WHITE).sum(dim=1) + terr_w.sum(dim=1)
    return ownership, black.float() - white.float() - cfg.komi


def _check(boards: torch.Tensor, size: int) -> None:
    if boards.dtype != torch.int8 or boards.dim() != 2:
        raise TypeError(f"boards must be int8 [B, N], got "
                        f"{boards.dtype} {tuple(boards.shape)}")
    if boards.shape[1] != size * size:
        raise ValueError(f"boards have {boards.shape[1]} points, size² "
                         f"is {size * size}")
    if not boards.is_contiguous():
        raise ValueError("boards must be contiguous")


def labels(boards: torch.Tensor, size: int) -> torch.Tensor:
    """Labels of a batch of boards. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel on the current stream
    (or raises -- there is no fallback)."""
    global launches
    _check(boards, size)
    if boards.device.type == "cpu":
        return labels_plain(boards, size)
    if boards.device.type != "cuda":
        raise ValueError(f"labels: unsupported device {boards.device}")
    out = torch.empty(boards.shape, dtype=torch.int32, device=boards.device)
    if boards.shape[0] == 0:
        return out
    fn = _build.library("labels").rocalphago_labels
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(boards.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(boards.data_ptr(), out.data_ptr(), boards.shape[0], size,
                 stream)
    if err != 0:
        raise RuntimeError(f"labels kernel launch failed: CUDA error {err}")
    launches += 1
    _build.count_launch(KERNEL)
    return out
