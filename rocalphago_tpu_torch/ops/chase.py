"""Ladder chase: the CUDA kernel ``csrc/chase.cu``, its plain PyTorch
version and the wrapper the ladder planes call.

Replaces ``rocalphago_tpu/ops/chase.py::pallas_chase`` (the TPU kernel)
and is the function of ``features/ladders.py::_chase`` (its XLA twin):
for each lane -- a board, its carried min-root labels and a prey point
-- is the prey group ladder-captured with the chaser to move? Each rung
is two plies (chaser move, forced escaper response), up to ``depth``
rungs. A lane with a negative prey point is disabled and reads False.
``collect_core=True`` also returns each lane's read core (the prey's
stones, the prey point and every cell a rung changed).

Bound on the card: the latency of a rung's chain of block-wide
decisions, not bytes or operations -- see the note at the top of
``csrc/chase.cu`` for what the kernel's design does about it (one
block per lane with its own rung loop, shared-memory board and liberty
table, barrier-fused reductions).
"""

from __future__ import annotations

import ctypes

import torch

from rocalphago_tpu_torch.ops import _build

#: launches of the CUDA kernel in this process (plain runs not counted)
launches = 0

# per-option ladder outcomes, ordered so the chaser minimises
_CAPTURED, _CONTINUE, _ESCAPED = 0, 1, 2


def chase_plain(boards: torch.Tensor, labels: torch.Tensor,
                prey: torch.Tensor, size: int, depth: int = 40,
                collect_core: bool = False, return_rungs: bool = False):
    """Plain PyTorch version, batched over lanes: the reference's
    ``ladders._chase`` with every lane stepped in lockstep and frozen
    once decided (the result is per lane, so lockstep changes
    nothing). Each rung tests ``done`` on the host.

    ``return_rungs=True`` appends each lane's rung count (int ``[L]``)
    to the return -- the work the kernel does on these inputs, which
    ``chip_smoke.py`` counts for the kernel's roofline bound."""
    from rocalphago_tpu_torch.engine.torchgo import (
        GoConfig,
        lib_counts_from_labels,
        neighbors_for,
        pad_points,
    )
    from rocalphago_tpu_torch.features.ladders import (
        _escaper_response_full,
        _first,
        _place,
        _relabel_place,
    )

    cfg = GoConfig(size=size)
    n = cfg.num_points
    nbrs = neighbors_for(size, boards.device)
    iota = torch.arange(n, device=boards.device)
    enabled = prey >= 0
    pp = torch.where(enabled, prey, 0).long()
    board, lab = boards, labels
    prey_color = board.gather(1, pp[:, None])[:, 0]
    chaser = -prey_color
    done = ~enabled
    rungs = torch.zeros_like(prey)
    captured = torch.zeros_like(enabled)
    core = torch.zeros_like(board, dtype=torch.bool)

    def option(lib_counts, prey_mask, lib_pt, en):
        b1, ok, cap0 = _place(cfg, board, lab, lib_counts, lib_pt, chaser)
        prey_l1, resp_l, resp_pt, resp_cap, resp_made = \
            _escaper_response_full(cfg, b1, prey_color, prey_mask, lab,
                                   lib_counts, lib_pt, cap0)
        logic = torch.where(resp_l <= 1, _CAPTURED,
                            torch.where(resp_l >= 3, _ESCAPED, _CONTINUE))
        outcome = torch.where(en & ok & (prey_l1 == 1), logic, _ESCAPED)
        return outcome, (lib_pt, cap0, resp_pt, resp_cap, resp_made)

    for rung in range(depth):
        if bool(done.all()):
            break
        lib_counts = lib_counts_from_labels(cfg, board, lab)
        root = lab.gather(1, pp[:, None])[:, 0].long()
        prey_alive = board.gather(1, pp[:, None])[:, 0] == prey_color
        libs = torch.where(prey_alive,
                           lib_counts.gather(1, root[:, None])[:, 0], 0)
        prey_mask = lab == root[:, None]
        lib_pts = (board == 0) & (pad_points(lab.long(), n)[:, nbrs]
                                  == root[:, None, None]).any(dim=2)
        l1 = _first(lib_pts)
        l2 = _first(lib_pts & (iota[None, :] != l1[:, None]))
        o1, u1 = option(lib_counts, prey_mask, l1, libs == 2)
        o2, u2 = option(lib_counts, prey_mask, l2, libs == 2)
        pick1 = o1 <= o2
        o = torch.where(pick1, o1, o2)
        c_pt, cap0, resp_pt, resp_cap, resp_made = (
            torch.where(pick1.view(-1, *([1] * (a.dim() - 1))), a, b)
            for a, b in zip(u1, u2))
        pre = torch.where(~prey_alive, _CAPTURED,
                          torch.where(libs >= 3, _ESCAPED,
                                      torch.where(libs == 1, _CAPTURED, -1)))
        o = torch.where(pre >= 0, pre, o)
        advance = (pre < 0) & (o == _CONTINUE) & ~done
        board1, lab1 = _relabel_place(cfg, board, lab, c_pt, chaser, cap0,
                                      advance)
        board2, lab2 = _relabel_place(cfg, board1, lab1, resp_pt,
                                      prey_color, resp_cap,
                                      advance & resp_made)
        add = ((prey_mask & (board != 0)) | (iota[None, :] == pp[:, None])
               | (board2 != board))
        core = torch.where(done[:, None], core, core | add)
        rungs = rungs + (~done).int()
        captured = torch.where(done, captured, o == _CAPTURED)
        done = done | (o != _CONTINUE) | (rung + 1 >= depth)
        board, lab = board2, lab2
    out = (captured & enabled,)
    if collect_core:
        out += (core & enabled[:, None],)
    if return_rungs:
        out += (rungs,)
    return out if len(out) > 1 else out[0]


def _check(boards, labels, prey, size, depth) -> None:
    n = size * size
    if boards.dtype != torch.int8 or boards.dim() != 2 \
            or boards.shape[1] != n:
        raise TypeError(f"boards must be int8 [L, {n}], got "
                        f"{boards.dtype} {tuple(boards.shape)}")
    if labels.dtype != torch.int32 or labels.shape != boards.shape:
        raise TypeError(f"labels must be int32 {tuple(boards.shape)}, "
                        f"got {labels.dtype} {tuple(labels.shape)}")
    if prey.dtype != torch.int32 or prey.shape != boards.shape[:1]:
        raise TypeError(f"prey must be int32 [{boards.shape[0]}], got "
                        f"{prey.dtype} {tuple(prey.shape)}")
    if not (boards.device == labels.device == prey.device):
        raise ValueError("boards, labels and prey must share a device")
    if not (boards.is_contiguous() and labels.is_contiguous()
            and prey.is_contiguous()):
        raise ValueError("chase inputs must be contiguous")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")


def chase(boards: torch.Tensor, labels: torch.Tensor, prey: torch.Tensor,
          size: int, depth: int = 40, collect_core: bool = False):
    """Ladder verdicts of a batch of lanes: bool ``[L]`` (and the core,
    bool ``[L, N]``, with ``collect_core``). ``boards`` int8 ``[L, N]``,
    ``labels`` int32 ``[L, N]``, ``prey`` int32 ``[L]`` (negative =
    disabled). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel on the current stream, or raises."""
    global launches
    _check(boards, labels, prey, size, depth)
    if boards.device.type == "cpu":
        return chase_plain(boards, labels, prey, size, depth, collect_core)
    if boards.device.type != "cuda":
        raise ValueError(f"chase: unsupported device {boards.device}")
    lanes, n = boards.shape
    captured = torch.empty((lanes,), dtype=torch.bool, device=boards.device)
    core = (torch.empty((lanes, n), dtype=torch.bool, device=boards.device)
            if collect_core else None)
    if lanes > 0:
        fn = _build.library("chase").rocalphago_chase
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(boards.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(boards.data_ptr(), labels.data_ptr(), prey.data_ptr(),
                     captured.data_ptr(),
                     core.data_ptr() if core is not None else None,
                     lanes, size, depth, stream)
        if err != 0:
            raise RuntimeError(
                f"chase kernel launch failed: CUDA error {err}")
        launches += 1
    return (captured, core) if collect_core else captured
