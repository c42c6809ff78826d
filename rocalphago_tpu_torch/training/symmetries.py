"""Dihedral (D4) augmentation on the device.

The port of ``training/symmetries.py``. Group element ``t`` in 0..7 is
the reference's: ``rot90^(t % 4)`` (``np.rot90`` on the board axes,
counter-clockwise), after a flip of the second board axis when
``t >= 4``. Each element is a fixed permutation of the ``s × s``
points, precomputed once per board size, so a batch with one ``t`` per
sample is a single gather -- no loop over the batch. Planes are NHWC
``[B, s, s, F]``, the shards' and the nets' input layout (the nets
permute to NCHW inside).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _element(a: np.ndarray, t: int) -> np.ndarray:
    """The reference's group element ``t`` on the first two axes."""
    if t >= 4:
        a = np.flip(a, axis=1)
    return np.rot90(a, t % 4)


@functools.lru_cache(maxsize=None)
def _tables(size: int):
    """``(src [8, N], dst [8, N])`` int64: ``src[t][d]`` is the point
    whose value element ``t`` moves to point ``d``; ``dst[t][p]`` is
    where it moves point ``p`` (the inverse permutation)."""
    n = size * size
    grid = np.arange(n).reshape(size, size)
    src = np.stack([_element(grid, t).reshape(n) for t in range(8)])
    dst = np.empty_like(src)
    for t in range(8):
        dst[t, src[t]] = np.arange(n)
    return torch.from_numpy(src), torch.from_numpy(dst)


@functools.lru_cache(maxsize=None)
def _table(which: int, size: int, device: torch.device) -> torch.Tensor:
    """One of :func:`_tables` on ``device``, copied there once."""
    return _tables(size)[which].to(device)


def _gather_points(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``out[b, d] = x[b, perm[b, d]]`` over the flattened board axes of
    ``[B, s, s, ...]``."""
    b, s = x.shape[0], x.shape[1]
    flat = x.reshape(b, s * s, -1)
    idx = perm[:, :, None].expand(-1, -1, flat.shape[2])
    return flat.gather(1, idx).reshape(x.shape)


def transform_planes(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Apply element ``t[i]`` to sample ``i`` of ``[B, s, s, F]`` (or
    ``[B, s, s]``) planes."""
    src = _table(0, x.shape[1], x.device)
    return _gather_points(x, src[t.long()])


def inverse_transform_planes(x: torch.Tensor, t: torch.Tensor
                             ) -> torch.Tensor:
    """Undo element ``t[i]`` on sample ``i``."""
    dst = _table(1, x.shape[1], x.device)
    return _gather_points(x, dst[t.long()])


def transform_action(action: torch.Tensor, t: torch.Tensor, size: int
                     ) -> torch.Tensor:
    """Apply element ``t[i]`` to flat board action ``action[i]`` (pass
    = ``size²`` maps to itself)."""
    n = size * size
    dst = _table(1, size, action.device)
    moved = dst[t.long(), action.long().clamp(max=n - 1)].to(action.dtype)
    return torch.where(action >= n, action, moved)


def random_transform_batch(generator: torch.Generator | None,
                           planes: torch.Tensor, actions: torch.Tensor,
                           size: int, t: torch.Tensor | None = None):
    """A random element per sample for a training batch (``planes
    [B, s, s, F]``, ``actions [B]``), drawn from ``generator`` unless
    ``t`` is given (the seam tests use to replay the reference's
    draws)."""
    if t is None:
        t = draw_elements(generator, planes.shape[0], planes.device)
    return (transform_planes(planes, t),
            transform_action(actions, t, size))


def draw_elements(generator: torch.Generator, batch: int, device
                  ) -> torch.Tensor:
    """``batch`` group elements, uniform on 0..7, from ``generator``
    (which lives on ``device``)."""
    return torch.randint(0, 8, (batch,), generator=generator,
                         device=device)
