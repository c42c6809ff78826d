"""Group labelling: the CUDA kernel ``csrc/labels.cu``, its plain
PyTorch version and the wrapper the engine calls.

Replaces ``rocalphago_tpu/ops/labels.py::pallas_labels`` (the TPU
kernel) and is the function of ``jaxgo.compute_labels`` (its XLA twin):
int8 boards ``[B, N]`` → int32 ``[B, N]``, each point the minimum flat
index of its same-colour group, ``N`` for empty points.

Bound on the card: latency of dependent sweeps, not bytes or
operations -- see the note at the top of ``csrc/labels.cu`` for what
the kernel's design does about it (shared-memory sweeps, pointer
jumping, a block-wide convergence test).
"""

from __future__ import annotations

import ctypes

import torch

from rocalphago_tpu_torch.ops import _build

#: launches of the CUDA kernel in this process (plain runs not counted)
launches = 0


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
    return out
