"""Transposition-keyed evaluation cache for the serve fleet.

The port of the reference package's ``serve/evalcache.py``, with its
constructor's defaults (capacity 100,000, 8 shards, verify and symmetry
off) and no environment switch: a pool has a cache only when the caller
passes ``eval_cache=EvalCache(...)``.

Fleet traffic repeats itself (sessions walk the same openings, searches
reach transpositions), yet every dispatched row pays a full policy and
value evaluation. The engine carries an exact Zobrist hash per position,
extended to an eval signature
(:func:`rocalphago_tpu_torch.engine.torchgo.eval_signature`) that also
covers the player to move, the ko point, the done flag and the per-stone
age buckets -- everything the feature planes read.

:class:`EvalCache` is a bounded LRU with sharded locks, keyed
``(sig_hi, sig_lo, board_size, komi, params_version)``, storing host
copies of the exact device outputs: a hit is bit-identical to a device
evaluation by construction. The params version is part of the key, and
because the evaluator's version registry reuses version numbers after
retirement, the evaluator calls :meth:`evict_version` whenever a version
retires.

Collision safety: the signature is 64 bits, so a false hit needs a
64-bit collision among live entries of one shard. ``verify=True``
stores the board bytes with each entry, compares them on every hit,
counts a mismatch in ``eval_cache_collisions_total`` and serves the miss
path instead.

Symmetry folding (``symmetry=True``) replaces the Zobrist key with a
canonical exact key -- the lexicographically smallest of the 8 dihedral
transforms of the board bytes (plus the age-bucket bytes, the remapped
ko point, turn and done) -- and stores priors in the canonical
orientation, remapping them on a hit. It is off by default: the nets
are not exactly equivariant, so a symmetric hit is only approximately
the evaluation of the original board.

Thread safety: entries shard by key hash across independent locks that
never nest, with each other or with any other serve lock.
"""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict

import numpy as np

from rocalphago_tpu_torch.obs import registry as obs_registry

DEFAULT_CAPACITY = 100_000
DEFAULT_SHARDS = 8


# ----------------------------------------------------------- symmetry


@functools.lru_cache(maxsize=None)
def dihedral_perms(size: int):
    """``(perms, inverses)``: the 8 dihedral transforms as flat-index
    permutations. ``canon_field = field[perms[t]]`` applies transform
    ``t``; ``field = canon_field[inverses[t]]`` undoes it."""
    idx = np.arange(size * size, dtype=np.int64).reshape(size, size)
    perms, invs = [], []
    for k in range(4):
        for flip in (False, True):
            t = np.rot90(idx, k)
            if flip:
                t = np.fliplr(t)
            p = np.ascontiguousarray(t).reshape(-1)
            inv = np.empty_like(p)
            inv[p] = np.arange(p.size)
            perms.append(p)
            invs.append(inv)
    return tuple(perms), tuple(invs)


def canonical_key(size: int, board: np.ndarray, buckets: np.ndarray,
                  ko: int, turn: int, done: bool):
    """``(core_key, t)``: the symmetry-folded exact key of a position:
    the transform ``t`` whose board bytes are lexicographically
    smallest (the first such ``t`` on ties) canonicalizes the board,
    the age buckets and the ko point; turn and done are invariant. The
    key is raw bytes, so unlike the Zobrist path it cannot collide.
    """
    perms, invs = dihedral_perms(size)
    best_t, best_cb = 0, board[perms[0]].tobytes()
    for t in range(1, 8):
        cb = board[perms[t]].tobytes()
        if cb < best_cb:
            best_t, best_cb = t, cb
    p, inv = perms[best_t], invs[best_t]
    cko = -1 if ko < 0 else int(inv[ko])
    core = (best_cb, buckets[p].tobytes(), cko, int(turn), bool(done))
    return core, best_t


def canonicalize_priors(priors: np.ndarray, t: int,
                        size: int) -> np.ndarray:
    """Reorder a priors row ``[N+1]`` (pass logit last, invariant)
    into the canonical orientation ``t``."""
    n = size * size
    perms, _ = dihedral_perms(size)
    return np.concatenate([priors[..., :n][..., perms[t]],
                           priors[..., n:]], axis=-1)


def orient_priors(canon_priors: np.ndarray, t: int,
                  size: int) -> np.ndarray:
    """Undo :func:`canonicalize_priors`: canonical-frame priors back
    to the original orientation of a row canonicalized by ``t``."""
    n = size * size
    _, invs = dihedral_perms(size)
    return np.concatenate([canon_priors[..., :n][..., invs[t]],
                           canon_priors[..., n:]], axis=-1)


# -------------------------------------------------------------- cache


class EvalCache:
    """Bounded, sharded-lock LRU of evaluation outputs (the module
    docstring has the key, the collision bound and the invalidation).

    Keys are plain tuples whose last element is the params version
    (:meth:`evict_version` relies on that layout); values are opaque to
    the cache (the evaluator stores ``(priors_row, value)`` host
    arrays, in the canonical orientation under symmetry folding). One
    instance is safely shared across every session of a pool, and
    across the member pools of a ``MultiSizePool``, since the board
    size is part of the key.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 shards: int = DEFAULT_SHARDS, verify: bool = False,
                 symmetry: bool = False):
        self.capacity = int(capacity)
        self.shards = max(1, int(shards))
        self.symmetry = bool(symmetry)
        # symmetry keys are exact bytes: nothing to verify against
        self.verify = False if self.symmetry else bool(verify)
        self._per_shard = max(1, self.capacity // self.shards)
        self._maps = [OrderedDict() for _ in range(self.shards)]
        self._locks = [threading.Lock() for _ in range(self.shards)]
        # per-shard event counts, updated under that shard's lock and
        # summed by stats(); registry counters inc outside the locks
        self._hits = [0] * self.shards
        self._misses = [0] * self.shards
        self._evictions = [0] * self.shards
        self._collisions = [0] * self.shards
        self._hits_c = obs_registry.counter("eval_cache_hits_total")
        self._misses_c = obs_registry.counter("eval_cache_misses_total")
        self._evcap_c = obs_registry.counter(
            "eval_cache_evictions_total", reason="capacity")
        self._evver_c = obs_registry.counter(
            "eval_cache_evictions_total", reason="version")
        self._coll_c = obs_registry.counter(
            "eval_cache_collisions_total")
        self._entries_g = obs_registry.gauge("eval_cache_entries")

    def _shard_of(self, key) -> int:
        return hash(key) % self.shards

    def __len__(self) -> int:
        return sum(len(m) for m in self._maps)

    def lookup(self, key, board_bytes: bytes | None = None):
        """The cached value for ``key`` (refreshing LRU recency), or
        None. In verify mode a hit whose stored board bytes differ
        from ``board_bytes`` is a detected hash collision: counted,
        and served as a miss (the subsequent insert overwrites the
        colliding entry)."""
        i = self._shard_of(key)
        with self._locks[i]:
            entry = self._maps[i].get(key)
            if entry is not None:
                if (self.verify and board_bytes is not None
                        and entry[1] is not None
                        and entry[1] != board_bytes):
                    self._collisions[i] += 1
                    self._misses[i] += 1
                    entry = None
                    collided = True
                else:
                    self._maps[i].move_to_end(key)
                    self._hits[i] += 1
                    collided = False
            else:
                self._misses[i] += 1
                collided = False
        if entry is None:
            self._misses_c.inc()
            if collided:
                self._coll_c.inc()
            return None
        self._hits_c.inc()
        return entry[0]

    def insert(self, key, value, board_bytes: bytes | None = None):
        """Store ``value`` (LRU-evicting the shard past its share of
        the capacity). ``board_bytes`` is retained only in verify
        mode."""
        i = self._shard_of(key)
        evicted = 0
        with self._locks[i]:
            m = self._maps[i]
            m[key] = (value, board_bytes if self.verify else None)
            m.move_to_end(key)
            while len(m) > self._per_shard:
                m.popitem(last=False)
                evicted += 1
                self._evictions[i] += 1
        if evicted:
            self._evcap_c.inc(evicted)
        self._entries_g.set(len(self))

    def evict_version(self, version) -> int:
        """Drop every entry of a retired params version, required on
        retirement: the evaluator's registry reuses version numbers
        (``max(versions) + 1``), so a stale entry under a recycled
        number would be served for a different net. Returns the number
        of entries dropped."""
        removed = 0
        for i in range(self.shards):
            with self._locks[i]:
                m = self._maps[i]
                dead = [k for k in m if k[-1] == version]
                for k in dead:
                    del m[k]
                self._evictions[i] += len(dead)
                removed += len(dead)
        if removed:
            self._evver_c.inc(removed)
        self._entries_g.set(len(self))
        return removed

    def clear(self) -> None:
        for i in range(self.shards):
            with self._locks[i]:
                self._maps[i].clear()
        self._entries_g.set(0)

    def stats(self) -> dict:
        """Host-side counters (the probe surface, mirrored in
        ``ServePool.stats``; the metric registry carries the same
        numbers)."""
        hits = sum(self._hits)
        misses = sum(self._misses)
        total = hits + misses
        return {
            "enabled": True,
            "entries": len(self),
            "capacity": self.capacity,
            "hits": hits,
            "misses": misses,
            "evictions": sum(self._evictions),
            "collisions": sum(self._collisions),
            "hit_rate": (round(hits / total, 4) if total else None),
        }


def disabled_stats() -> dict:
    """The ``stats()`` shape when no cache is attached: the same keys,
    so the probe schema does not depend on the configuration."""
    return {"enabled": False, "entries": 0, "capacity": 0, "hits": 0,
            "misses": 0, "evictions": 0, "collisions": 0,
            "hit_rate": None}
