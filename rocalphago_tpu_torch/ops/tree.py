"""The search tree's walks: the CUDA kernel ``csrc/tree.cu``, its plain
PyTorch versions and the wrappers the device search calls.

Not a port of a Pallas kernel: these replace the two data-dependent
``lax.while_loop``s of ``rocalphago_tpu/search/device_mcts.py``,
``_descend_one`` (PUCT selection, ``_select_action``) and
``_backup_one``. In eager PyTorch each level of those loops would be a
device→host sync; the kernel keeps the walks on the card.

* :func:`descend` -- from each game's root, follow PUCT-selected child
  pointers until an unexpanded edge or a terminal node: ``(node,
  action)``, ``action == -1`` where the walk ended on a terminal node.
  ``root_action >= 0`` forces the first edge out of the root.
  ``forced_k > 0`` turns on forced playouts at the root (the
  reference's ``_select_action_root``): a prior-supported root child
  short of ``sqrt(forced_k * p * N)`` visits (``N`` the root's visits
  so far) is taken first, the largest deficit and then the lowest index
  winning; the root uses PUCT when no child is short. Selection below
  the root is PUCT either way, and ``forced_k = 0`` is the plain PUCT
  walk.
* :func:`backup` -- from the edge ``(start_node, start_action)`` up to
  the root, add one visit and ``-v``, ``+v``, ... (the sign alternating
  at each level) to each edge's value sum, in place. A negative
  ``start_node`` backs up nothing.

Slabs: ``prior``, ``value_sum`` float32 and ``visits``, ``child`` int32
``[B, M, A]``; ``done`` bool and ``parent``, ``paction`` int32
``[B, M]``; per-game int32 / float32 ``[B]``.

Bound on the card: the latency of a chain of dependent levels (a child
pointer read at one level addresses the next); see the note at the top
of ``csrc/tree.cu`` for the design (one warp per game for the descent,
one thread per game for the backup).
"""

from __future__ import annotations

import ctypes

import torch

from rocalphago_tpu_torch.ops import _build

#: launches of the CUDA kernels (descend and backup) in this process;
#: plain runs are not counted
launches = 0
#: this kernel's index in the per-thread launch counts
KERNEL = _build.SOURCES.index("tree")


def select_plain(prior: torch.Tensor, visits: torch.Tensor,
                 value_sum: torch.Tensor, c_puct: float) -> torch.Tensor:
    """PUCT argmax over each row's edges (``[..., A]`` → int64
    ``[...]``), ties to the lowest index: the reference's
    ``_select_action`` in the order of operations XLA compiles it to.
    Its source reads ``c_puct * p * sqrt(n + 1) / (1 + n_a)``, but XLA's
    simplifier gathers the two per-node scalars first and computes
    ``p * (sqrt(n + 1) * c_puct) / (1 + n_a)`` (the compiled HLO of the
    reference shows it), which rounds differently."""
    nv = visits.float()
    q = torch.where(visits > 0, value_sum / torch.clamp(nv, min=1.0), 0.0)
    cs = torch.sqrt(nv.sum(dim=-1, keepdim=True) + 1.0) * c_puct
    u = prior * cs / (1.0 + nv)
    score = torch.where(prior > 0, q + u, float("-inf"))
    return torch.argmax(score, dim=-1)


def select_root_plain(prior: torch.Tensor, visits: torch.Tensor,
                      value_sum: torch.Tensor, c_puct: float,
                      forced_k: float) -> torch.Tensor:
    """Root selection under forced playouts (``[..., A]`` → int64
    ``[...]``): the child with the largest deficit below its floor
    ``sqrt(forced_k * p * N)`` where one is short, else PUCT. The floor
    is computed as XLA compiles the reference's
    ``sqrt(forced_k * p * sum(n))``: ``p * (sum(n) * forced_k)``."""
    nv = visits.float()
    floor = torch.sqrt(prior * (nv.sum(dim=-1, keepdim=True) * forced_k))
    deficit = torch.where(prior > 0, floor - nv, float("-inf"))
    short = deficit.amax(dim=-1) > 0
    return torch.where(short, torch.argmax(deficit, dim=-1),
                       select_plain(prior, visits, value_sum, c_puct))


def descend_plain(prior, visits, value_sum, child, done, root, root_action,
                  c_puct: float, forced_k: float = 0.0):
    """Plain version of :func:`descend`: every game steps one level per
    iteration, frozen once stopped; the loop ends on a host test."""
    b = prior.shape[0]
    ar = torch.arange(b, device=prior.device)
    root, root_action = root.long(), root_action.long()
    at_term0 = done[ar, root]
    forced = (root_action >= 0) & ~at_term0
    nxt0 = torch.where(
        forced, child[ar, root, root_action.clamp(min=0)].long(), -1)
    stop = at_term0 | (forced & (nxt0 < 0))
    node = torch.where(stop | ~forced, root, nxt0)
    action = torch.where(forced, root_action, -1)
    while not bool(stop.all()):
        at_term = done[ar, node]
        rows = (prior[ar, node], visits[ar, node], value_sum[ar, node])
        sel = select_plain(*rows, c_puct)
        if forced_k:
            sel = torch.where(node == root,
                              select_root_plain(*rows, c_puct, forced_k),
                              sel)
        a = torch.where(at_term, -1, sel)
        nxt = torch.where(a >= 0, child[ar, node, a.clamp(min=0)].long(), -1)
        ends = at_term | (nxt < 0)
        action = torch.where(stop, action, a)
        node = torch.where(stop | ends, node, nxt)
        stop = stop | ends
    return node.int(), action.int()


def backup_plain(visits, value_sum, parent, paction, start_node,
                 start_action, values):
    """Plain version of :func:`backup` (in place; returns ``(visits,
    value_sum)``): every live walk climbs one level per iteration; the
    loop ends on a host test."""
    node, action = start_node.long(), start_action.long()
    v = -values
    while True:
        live = torch.nonzero(node >= 0)[:, 0]
        if live.numel() == 0:
            return visits, value_sum
        n, a = node[live], action[live]
        visits[live, n, a] += 1
        value_sum[live, n, a] += v[live]
        node = node.clone()
        action = action.clone()
        action[live] = paction[live, n].long()
        node[live] = parent[live, n].long()
        v = -v


def _check(*, slabs=(), rows=(), games=(), batch: int, device) -> None:
    for name, t, dtype in slabs + rows + games:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape[0] != batch:
            raise ValueError(f"{name} has batch {t.shape[0]}, not {batch}")
    shapes = {t.shape for _, t, _ in slabs}
    if len(shapes) > 1 or any(t.dim() != 3 for _, t, _ in slabs):
        raise ValueError("edge slabs must share one [B, M, A] shape")
    m = slabs[0][1].shape[1]
    for name, t, _ in rows:
        if t.shape != (batch, m):
            raise ValueError(f"{name} must be [{batch}, {m}], got "
                             f"{tuple(t.shape)}")
    for name, t, _ in games:
        if t.shape != (batch,):
            raise ValueError(f"{name} must be [{batch}], got "
                             f"{tuple(t.shape)}")


def _launch(fn_name: str, argtypes, args) -> None:
    global launches
    fn = getattr(_build.library("tree"), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"tree kernel {fn_name} launch failed: "
                           f"CUDA error {err}")
    launches += 1
    _build.count_launch(KERNEL)


def descend(prior, visits, value_sum, child, done, root, root_action,
            c_puct: float, forced_k: float = 0.0):
    """``(node, action)`` int32 ``[B]`` of each game's descent. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel on
    the current stream, or raises (there is no fallback)."""
    b = prior.shape[0]
    _check(slabs=(("prior", prior, torch.float32),
                  ("visits", visits, torch.int32),
                  ("value_sum", value_sum, torch.float32),
                  ("child", child, torch.int32)),
           rows=(("done", done, torch.bool),),
           games=(("root", root, torch.int32),
                  ("root_action", root_action, torch.int32)),
           batch=b, device=prior.device)
    if prior.device.type == "cpu":
        return descend_plain(prior, visits, value_sum, child, done, root,
                             root_action, c_puct, forced_k)
    if prior.device.type != "cuda":
        raise ValueError(f"tree: unsupported device {prior.device}")
    node = torch.empty((b,), dtype=torch.int32, device=prior.device)
    action = torch.empty_like(node)
    if b == 0:
        return node, action
    _, m, a = prior.shape
    with torch.cuda.device(prior.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("rocalphago_tree_descend",
                [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
                [prior.data_ptr(), visits.data_ptr(), value_sum.data_ptr(),
                 child.data_ptr(), done.data_ptr(), root.data_ptr(),
                 root_action.data_ptr(), node.data_ptr(), action.data_ptr(),
                 b, m, a, float(c_puct), float(forced_k), stream])
    return node, action


def backup(visits, value_sum, parent, paction, start_node, start_action,
           values):
    """Back each game's value up its path, updating ``visits`` and
    ``value_sum`` in place; returns them. ``values`` are from the
    evaluated state's player to move. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel, or raises."""
    b = visits.shape[0]
    _check(slabs=(("visits", visits, torch.int32),
                  ("value_sum", value_sum, torch.float32)),
           rows=(("parent", parent, torch.int32),
                 ("paction", paction, torch.int32)),
           games=(("start_node", start_node, torch.int32),
                  ("start_action", start_action, torch.int32),
                  ("values", values, torch.float32)),
           batch=b, device=visits.device)
    if visits.device.type == "cpu":
        return backup_plain(visits, value_sum, parent, paction, start_node,
                            start_action, values)
    if visits.device.type != "cuda":
        raise ValueError(f"tree: unsupported device {visits.device}")
    if b == 0:
        return visits, value_sum
    _, m, a = visits.shape
    with torch.cuda.device(visits.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("rocalphago_tree_backup",
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                + [ctypes.c_void_p],
                [visits.data_ptr(), value_sum.data_ptr(), parent.data_ptr(),
                 paction.data_ptr(), start_node.data_ptr(),
                 start_action.data_ptr(), values.data_ptr(), b, m, a,
                 stream])
    return visits, value_sum
