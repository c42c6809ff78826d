"""Shared Zobrist tables: one hashing scheme for both engines.

A copy of the reference package's ``engine/zobrist.py``, kept in the
port so that the port imports nothing of the JAX package. The tables
must stay bit-identical to the reference's: the same fixed seeds and
the same single ``integers()`` draw, so a position hashes to the same
uint32[2] key in the host oracle (:mod:`.pygo`), the port's batched
engine (:mod:`.torchgo`) and the reference engines
(``tests/test_torch_engine.py`` pins it).

Two key families:

* :func:`position_table` -- the POSITION keys (``[N, 2, 2]``:
  per-point, per-color, 2×uint32).
* :func:`signature_tables` -- the EVAL-SIGNATURE keys (a second,
  independent fixed seed) for the player to move, the ko point, the
  done flag and the per-stone age bucket.

Numpy only: the host oracle must import without torch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

#: the device engine's historical seed — DO NOT change: every carried
#: hash, superko ring buffer and differential test pins these values
POSITION_SEED = 20260729

#: the eval-signature family's own seed (independent of the position
#: keys so signature terms never cancel against stone keys)
SIGNATURE_SEED = 20260806

#: number of stone-age buckets the ``turns_since`` planes one-hot
#: (``features/planes.py::_one_hot8`` — ages clip into ``0..7``)
AGE_BUCKETS = 8


@functools.lru_cache(maxsize=None)
def position_table(size: int) -> np.ndarray:
    """Per-point position keys ``uint32 [N, 2, 2]``.

    ``table[p, color_idx]`` is the 2×uint32 key of a stone at flat
    point ``p``; ``color_idx`` 0 = black, 1 = white. Fixed seed →
    identical hashes across engines and processes.
    """
    n = size * size
    rng = np.random.default_rng(POSITION_SEED)
    return rng.integers(0, 2**32, size=(n, 2, 2), dtype=np.uint32)


class SignatureTables(NamedTuple):
    """The eval-signature key families (all uint32, trailing dim 2)."""

    age: np.ndarray   # [N, AGE_BUCKETS, 2]  per-point per-age-bucket
    ko: np.ndarray    # [N + 1, 2]           indexed ``ko + 1`` (0 = none)
    turn: np.ndarray  # [2]                  XORed when white to move
    done: np.ndarray  # [2]                  XORed when the game is over


@functools.lru_cache(maxsize=None)
def signature_tables(size: int) -> SignatureTables:
    """Keys for the non-positional terms of the eval signature."""
    n = size * size
    rng = np.random.default_rng(SIGNATURE_SEED)
    return SignatureTables(
        age=rng.integers(0, 2**32, size=(n, AGE_BUCKETS, 2),
                         dtype=np.uint32),
        ko=rng.integers(0, 2**32, size=(n + 1, 2), dtype=np.uint32),
        turn=rng.integers(0, 2**32, size=(2,), dtype=np.uint32),
        done=rng.integers(0, 2**32, size=(2,), dtype=np.uint32),
    )
