"""The replay buffer: the hand-off between self-play actors and the
learner. A copy of the reference package's ``data/replay.py``.

A bounded, thread-safe ring of finished self-play batches
(:class:`ZeroGames`). Producers (``training/actor.py``) ``put``
batches -- blocking when full (pacing) or evicting the oldest (free
run) -- and consumers take them out either FIFO
(:meth:`ReplayBuffer.next_batch`, the bit-exact lockstep path) or by a
prioritised-recency draw (:meth:`ReplayBuffer.sample`, geometric from
the newest entry).

Durability and transport:

- crash-safe spill: with ``spill_dir`` set, every accepted entry is
  written atomically (:func:`~rocalphago_tpu_torch.runtime.atomic.
  atomic_write_json`) and removed again when consumed or evicted;
  :meth:`ReplayBuffer.restore` reloads whatever survived, skipping
  anything unreadable;
- tolerant JSONL ingest: :class:`JsonlIngester` tails ``*.jsonl``
  shards written by out-of-process actors (one game record per line),
  consuming only newline-terminated lines, so a writer that crashed
  mid-line never poisons the stream.

Records are host numpy arrays with the recorder's dtypes, and the JSON
record (:func:`games_to_record`) is the reference's, game id included:
either package reads the other's records and spills.

Blocking waits are tagged :func:`~rocalphago_tpu_torch.runtime.
watchdog.waiting_on` ``("replay_fill")``, so a starving learner's
stall event is told apart from a hang. The registry
(:mod:`~rocalphago_tpu_torch.obs.registry`) carries the reference's
``replay_fill_games``, ``replay_ingest_games_total``,
``replay_ingest_per_min``, ``replay_evicted_games_total``,
``replay_spilled_total`` and ``replay_sample_staleness_seconds``. The
module imports numpy only.
"""

from __future__ import annotations

import glob
import hashlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import numpy as np

from rocalphago_tpu_torch.obs import registry
from rocalphago_tpu_torch.runtime import atomic, watchdog

#: default capacity in entries (one entry = one self-play batch)
DEFAULT_CAPACITY = 8
#: default geometric recency parameter of :meth:`ReplayBuffer.sample`
DEFAULT_SAMPLE_P = 0.5

#: Record-schema version written by :func:`games_to_record`. v1: the
#: five core fields, no ``schema`` key. v2: adds the optional
#: self-play-economics fields (``full``/``ownership``/``score``,
#: present only when recorded). Readers accept any version up to this
#: one (absent optionals load as None); a record of a newer schema
#: raises :class:`UnknownSchemaError`.
RECORD_SCHEMA = 2


class UnknownSchemaError(ValueError):
    """Record written by a newer schema than this reader knows."""


class ZeroGames(NamedTuple):
    """One finished self-play batch, the unit the buffer stores, in the
    recorder's dtypes (the learner makes its own float casts, so a
    round trip through the buffer is bit-exact):

    - ``actions``: ``[T, B]`` int32 move indices per ply
    - ``live``: ``[T, B]`` bool, the game was live when ply t played
    - ``visits``: ``[T, B, A]`` root visit counts (int32) or targets
      (float32: π′ under Gumbel, pruned targets under forced playouts)
    - ``winners``: ``[B]`` int32 (+1 black / -1 white / 0 draw)
    - ``finished``: ``[B]`` bool, the game ended by two passes

    Schema v2's optional fields (None with the flags off):

    - ``full``: ``[T, B]`` bool, the ply ran a full search (playout
      caps; only these plies carry policy targets)
    - ``ownership``: ``[B, N]`` int8 terminal ownership, black-positive
    - ``score``: ``[B]`` float32 terminal score (black − white − komi)
    """

    actions: np.ndarray
    live: np.ndarray
    visits: np.ndarray
    winners: np.ndarray
    finished: np.ndarray
    full: np.ndarray | None = None
    ownership: np.ndarray | None = None
    score: np.ndarray | None = None


class ReplayEntry(NamedTuple):
    """A buffered batch and its provenance: ``seq`` (ingest order),
    ``version`` (the params snapshot that played it) and ``t_ingest``
    (monotonic seconds, for its age)."""

    seq: int
    version: int
    games: ZeroGames
    t_ingest: float


def compute_game_id(games: ZeroGames) -> str:
    """Content hash of one batch: sha256 over every present field's
    name, dtype, shape and raw bytes (16 hex characters). A pure
    function of the content, so a batch re-encoded, re-shipped or
    re-spilled hashes to the same id."""
    h = hashlib.sha256()
    for name, arr in zip(ZeroGames._fields, games):
        if arr is None:
            continue
        a = np.asarray(arr)
        h.update(name.encode("utf-8"))
        h.update(str(a.dtype).encode("utf-8"))
        h.update(str(a.shape).encode("utf-8"))
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def games_to_record(games: ZeroGames, version: int = 0,
                    seq: int = 0, game_id: str | None = None) -> dict:
    """A JSON-serialisable record keeping shapes and dtypes. Absent
    (None) fields are left out, so a flags-off batch writes the v1
    field set plus the ``schema`` tag; every record carries its
    ``game_id`` (:func:`compute_game_id`)."""
    rec = {"version": int(version), "seq": int(seq),
           "schema": RECORD_SCHEMA,
           "game_id": game_id or compute_game_id(games)}
    for name, arr in zip(ZeroGames._fields, games):
        if arr is None:
            continue
        a = np.asarray(arr)
        rec[name] = a.tolist()
        rec[name + "_dtype"] = str(a.dtype)
    return rec


def record_game_id(rec: dict, games: ZeroGames | None = None) -> str:
    """A record's ``game_id``: the embedded one, else recomputed from
    ``games`` (the parsed batch)."""
    gid = rec.get("game_id")
    if gid:
        return str(gid)
    if games is None:
        games, _ = record_to_games(rec)
    return compute_game_id(games)


def record_to_games(rec: dict) -> tuple[ZeroGames, int]:
    """Inverse of :func:`games_to_record`: ``(games, version)``. Raises
    ``KeyError`` / ``TypeError`` / ``ValueError`` on a malformed record,
    and :class:`UnknownSchemaError` on a newer schema; v1 records and
    v2 records without an optional field load it as None."""
    schema = int(rec.get("schema", 1))
    if schema > RECORD_SCHEMA:
        raise UnknownSchemaError(
            f"record schema {schema} is newer than this reader's "
            f"{RECORD_SCHEMA}")
    arrs = []
    for name in ZeroGames._fields:
        if name in ZeroGames._field_defaults and name not in rec:
            arrs.append(None)
            continue
        arrs.append(np.asarray(rec[name],
                               dtype=np.dtype(rec[name + "_dtype"])))
    return ZeroGames(*arrs), int(rec.get("version", 0))


_INCARNATIONS = itertools.count()


def _as_host(games: ZeroGames) -> ZeroGames:
    return ZeroGames(*(None if x is None else np.asarray(x)
                       for x in games))


class ReplayBuffer:
    """Bounded thread-safe ring of :class:`ReplayEntry`.

    ``capacity`` is in entries; ``put(block=True)`` paces producers
    (waits for a FIFO consumer to make room), ``put(block=False)``
    evicts the oldest entry instead -- the mode for a :meth:`sample`
    consumer, which never removes entries."""

    def __init__(self, capacity: int | None = None, *,
                 sample_p: float | None = None,
                 spill_dir: str | None = None, seed: int = 0):
        self.capacity = (DEFAULT_CAPACITY if capacity is None
                         else int(capacity))
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.sample_p = (DEFAULT_SAMPLE_P if sample_p is None
                         else float(sample_p))
        if not 0.0 < self.sample_p <= 1.0:
            raise ValueError(f"sample_p must be in (0, 1], "
                             f"got {self.sample_p}")
        self.spill_dir = spill_dir
        self._cond = threading.Condition()
        self._entries: list[ReplayEntry] = []  # guarded-by: self._cond
        self._seq = 0                          # guarded-by: self._cond
        self._closed = False                   # guarded-by: self._cond
        self._ingested = 0                     # guarded-by: self._cond
        self._t_first: float | None = None     # guarded-by: self._cond
        self._rng = np.random.default_rng(seed)  # guarded-by: self._cond
        # spill names carry an incarnation tag, so this buffer's files
        # never collide with a dead incarnation's leftovers: restore()
        # reads only foreign tags. The per-process counter keeps two
        # buffers made in the same millisecond apart (the reference's
        # pid.ms tag alone lets a second buffer skip the first one's
        # files as its own)
        self._spill_tag = (f"{os.getpid():x}."
                           f"{int(time.time() * 1e3) & 0xffffffff:08x}."
                           f"{next(_INCARNATIONS):x}")
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    # ------------------------------------------------------- producers

    def put(self, games: ZeroGames, version: int = 0,
            block: bool = False, timeout: float | None = None,
            evict: bool = True) -> bool:
        """Append a batch; True if accepted, False on timeout or when
        closed. ``block=True`` waits for room; ``block=False`` evicts
        the oldest entry when full, or with ``evict=False`` refuses
        (returns False, the buffer untouched)."""
        games = _as_host(games)
        n_games = int(games.winners.shape[0])
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        evict_seqs: list[int] = []
        evicted_games = 0
        with self._cond:
            while (block and not self._closed
                   and len(self._entries) >= self.capacity):
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    return False
                self._cond.wait(rem)
            if self._closed:
                return False
            if not evict and len(self._entries) >= self.capacity:
                return False
            while len(self._entries) >= self.capacity:
                old = self._entries.pop(0)
                evict_seqs.append(old.seq)
                evicted_games += int(old.games.winners.shape[0])
            entry = ReplayEntry(self._seq, int(version), games,
                                time.monotonic())
            self._seq += 1
            if self.spill_dir:
                # spilled before the entry is visible: a consumer that
                # takes it at once then removes a file that exists (the
                # reference writes after releasing the lock, and a fast
                # consumer's unspill can run first, leaving a consumed
                # entry on disk for a later restore to insert again)
                atomic.atomic_write_json(
                    self._spill_path(entry.seq),
                    games_to_record(games, entry.version, entry.seq),
                    indent=None)
                for seq in evict_seqs:
                    self._unspill(seq)
            self._entries.append(entry)
            self._ingested += n_games
            if self._t_first is None:
                self._t_first = time.monotonic()
            fill = self._fill_games()
            total, t_first = self._ingested, self._t_first
            self._cond.notify_all()
        if self.spill_dir:
            registry.counter("replay_spilled_total").inc()
        registry.gauge("replay_fill_games").set(fill)
        registry.counter("replay_ingest_games_total").inc(n_games)
        minutes = max(time.monotonic() - t_first, 1e-9) / 60.0
        registry.gauge("replay_ingest_per_min").set(total / minutes)
        if evicted_games:
            registry.counter("replay_evicted_games_total").inc(
                evicted_games)
        return True

    # ------------------------------------------------------- consumers

    def _fill_games(self) -> int:
        """Under the lock: the games in the ring."""
        return sum(int(e.games.winners.shape[0]) for e in self._entries)

    def _wait_nonempty(self, deadline) -> bool:
        """Under the lock: wait for an entry; False on timeout or when
        closed and empty."""
        while not self._entries and not self._closed:
            rem = (None if deadline is None
                   else deadline - time.monotonic())
            if rem is not None and rem <= 0:
                return False
            self._cond.wait(rem)
        return bool(self._entries)

    def next_batch(self, timeout: float | None = None) \
            -> ReplayEntry | None:
        """FIFO-pop the oldest entry (the lockstep, bit-exact path).
        Blocks until an entry arrives; None on timeout or when the
        buffer is closed and drained."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with watchdog.waiting_on("replay_fill"):
            with self._cond:
                if not self._wait_nonempty(deadline):
                    return None
                entry = self._entries.pop(0)
                fill = self._fill_games()
                self._cond.notify_all()   # room for paced producers
        if self.spill_dir:
            self._unspill(entry.seq)      # consumed: not restored
        self._observe_out(entry, fill)
        return entry

    def sample(self, timeout: float | None = None) \
            -> ReplayEntry | None:
        """Prioritised-recency draw (geometric from the newest entry,
        parameter ``sample_p``); the entry stays in the ring. Blocks
        until non-empty; None on timeout or closed and empty."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with watchdog.waiting_on("replay_fill"):
            with self._cond:
                if not self._wait_nonempty(deadline):
                    return None
                n = len(self._entries)
                back = min(int(self._rng.geometric(self.sample_p)) - 1,
                           n - 1)
                entry = self._entries[n - 1 - back]
                fill = self._fill_games()
        self._observe_out(entry, fill)
        return entry

    # ------------------------------------------------------- lifecycle

    def close(self) -> None:
        """Refuse further puts and wake every waiter (consumers drain
        what is left, then get None)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    @property
    def fill(self) -> int:
        with self._cond:
            return len(self._entries)

    @property
    def ingested_games(self) -> int:
        with self._cond:
            return self._ingested

    # ----------------------------------------------------- persistence

    def restore(self) -> int:
        """Reload spilled entries after a crash; returns the count.
        Unreadable or torn files are skipped; every file read is
        removed and the survivors re-spilled under fresh sequence
        numbers, so a second crash cannot restore them twice. The
        entries go in under one critical section, so puts running
        meanwhile never land in the middle of the restored stream."""
        if not self.spill_dir:
            return 0
        paths = sorted(
            p for p in glob.glob(
                os.path.join(self.spill_dir, "entry.*.json"))
            if f".{self._spill_tag}." not in os.path.basename(p))
        recovered = []
        for path in paths:
            try:
                with open(path, encoding="utf-8") as f:
                    rec = json.load(f)
                games, version = record_to_games(rec)
            except (OSError, ValueError, KeyError, TypeError):
                continue
            recovered.append((_as_host(games), version))
        evict_seqs: list[int] = []
        evicted_games = 0
        new_entries: list[ReplayEntry] = []
        with self._cond:
            if self._closed:
                return 0
            for games, version in recovered:
                while len(self._entries) >= self.capacity:
                    old = self._entries.pop(0)
                    evict_seqs.append(old.seq)
                    evicted_games += int(old.games.winners.shape[0])
                entry = ReplayEntry(self._seq, int(version), games,
                                    time.monotonic())
                self._seq += 1
                self._entries.append(entry)
                self._ingested += int(games.winners.shape[0])
                new_entries.append(entry)
            if new_entries and self._t_first is None:
                self._t_first = time.monotonic()
            fill = self._fill_games()
            self._cond.notify_all()
        # file I/O outside the lock: drop the old files, then re-spill
        # only the entries still in the buffer
        for path in paths:
            try:
                os.unlink(path)
            except OSError:
                pass
        evicted = set(evict_seqs)
        for entry in new_entries:
            if entry.seq in evicted:
                continue
            atomic.atomic_write_json(
                self._spill_path(entry.seq),
                games_to_record(entry.games, entry.version, entry.seq),
                indent=None)
        restored_seqs = {e.seq for e in new_entries}
        for seq in evict_seqs:
            if seq not in restored_seqs:
                self._unspill(seq)
        if new_entries:
            registry.counter("replay_spilled_total").inc(len(new_entries))
            registry.gauge("replay_fill_games").set(fill)
        if evicted_games:
            registry.counter("replay_evicted_games_total").inc(
                evicted_games)
        return len(new_entries)

    def discard_spill(self) -> int:
        """Delete every spilled entry without restoring it; returns the
        count. The lockstep resume path: its actor replays the games
        bit for bit from the checkpointed generator chain, so restoring
        leftovers would insert them twice."""
        if not self.spill_dir:
            return 0
        n = 0
        for path in glob.glob(os.path.join(self.spill_dir,
                                           "entry.*.json")):
            try:
                os.unlink(path)
                n += 1
            except OSError:
                pass
        return n

    def _spill_path(self, seq: int) -> str:
        return os.path.join(self.spill_dir,
                            f"entry.{self._spill_tag}.{seq:08d}.json")

    def _unspill(self, seq: int) -> None:
        try:
            os.unlink(self._spill_path(seq))
        except OSError:
            pass

    def _observe_out(self, entry: ReplayEntry, fill: int) -> None:
        """The registry's view of a take: the entry's age and the fill."""
        registry.histogram("replay_sample_staleness_seconds").observe(
            time.monotonic() - entry.t_ingest)
        registry.gauge("replay_fill_games").set(fill)


class JsonlIngester:
    """Tail ``*.jsonl`` shards in a directory into a buffer: the
    transport for out-of-process actors (each appends game records to
    its own shard).

    Single consumer, no locks: per-shard byte offsets live on the
    instance, and only newline-terminated lines are read, so a torn
    tail waits for the next :meth:`poll`. Records that fail to parse
    are counted in ``skipped`` (a newer schema in ``schema_skipped``),
    never fatal. A shard that shrinks under its offset (rewritten or
    rotated) is read again from byte 0 (``shard_rotated``); the bounded
    window of recent ``game_id``\\ s skips records already ingested
    (``dedup_hits``)."""

    def __init__(self, buffer: ReplayBuffer, path: str,
                 dedup_window: int = 4096):
        self.buffer = buffer
        self.path = path
        self.skipped = 0
        self.schema_skipped = 0
        self.shard_rotated = 0
        self.dedup_hits = 0
        self.dedup_window = int(dedup_window)
        self._offsets: dict[str, int] = {}
        self._seen: dict[str, None] = {}   # insertion-ordered id ring

    def poll(self) -> int:
        """Ingest every complete new line; returns the entries added."""
        added = 0
        for shard in sorted(glob.glob(os.path.join(self.path,
                                                   "*.jsonl"))):
            offset = self._offsets.get(shard, 0)
            try:
                with open(shard, "rb") as f:
                    if os.fstat(f.fileno()).st_size < offset:
                        self.shard_rotated += 1
                        offset = 0
                        self._offsets[shard] = 0
                    f.seek(offset)
                    data = f.read()
            except OSError:
                continue
            end = data.rfind(b"\n")
            if end < 0:
                continue
            for line in data[:end].splitlines():
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                    games, version = record_to_games(rec)
                    gid = record_game_id(rec, games)
                except UnknownSchemaError:
                    self.schema_skipped += 1
                    continue
                except (ValueError, KeyError, TypeError):
                    self.skipped += 1
                    continue
                if gid in self._seen:
                    self.dedup_hits += 1
                    continue
                if self.buffer.put(games, version=version):
                    added += 1
                    self._seen[gid] = None
                    while len(self._seen) > self.dedup_window:
                        self._seen.pop(next(iter(self._seen)))
            self._offsets[shard] = offset + end + 1
        return added


def append_jsonl_record(path: str, games: ZeroGames,
                        version: int = 0, seq: int = 0) -> None:
    """Producer side of the JSONL transport: append one record as a
    single newline-terminated line."""
    line = json.dumps(games_to_record(games, version, seq),
                      separators=(",", ":")) + "\n"
    with open(path, "a", encoding="utf-8") as f:
        f.write(line)
