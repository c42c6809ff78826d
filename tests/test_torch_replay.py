"""The port's replay buffer and game records
(``rocalphago_tpu_torch/data/replay.py``) against the reference's
``data/replay.py``, on the CPU.

* Records cross both ways, schema v1 (the five core fields) and v2
  (with ``full``, ``ownership``, ``score``): the port's record is the
  reference's JSON text, game id included, and each reads the other's
  back with dtypes and shapes intact; spill directories restore across
  the packages.
* The buffer behaves as the reference's: FIFO and fill, eviction,
  pacing, the recency sampler (the same draws from the same seed),
  close, spill, restore (torn files skipped, atomic against live puts)
  and discard.
* The JSONL ingester: a torn tail, garbage lines, a newer schema, a
  rotated shard re-read exactly once.

Waits are on events and threads joined, never on a consumer's timeout
against a producer's timing (the reference's
``test_extended_fields_roundtrip_and_spill`` is unsteady for a second
reason the port fixes: two buffers made in the same millisecond shared
a spill tag, so the second skipped the first one's files).
"""

import json
import os
import threading

import numpy as np
import pytest

from rocalphago_tpu.data import replay as ref_replay
from rocalphago_tpu_torch.data import replay


def make_games(seed=0, t=3, b=2, a=26, ext=False, n=25):
    r = np.random.default_rng(seed)
    g = replay.ZeroGames(
        actions=r.integers(0, a, (t, b)).astype(np.int32),
        live=r.integers(0, 2, (t, b)).astype(bool),
        visits=r.integers(0, 5, (t, b, a)).astype(np.int32),
        winners=r.integers(-1, 2, (b,)).astype(np.int32),
        finished=r.integers(0, 2, (b,)).astype(bool))
    if ext:
        g = g._replace(full=r.integers(0, 2, (t, b)).astype(bool),
                       ownership=r.integers(-1, 2, (b, n)).astype(np.int8),
                       score=r.normal(size=(b,)).astype(np.float32))
    return g


def gumbel_games(seed=0):
    """A record with float32 targets (π′, or pruned targets)."""
    g = make_games(seed, ext=True)
    v = np.random.default_rng(seed + 1).dirichlet(
        np.ones(26), size=(3, 2)).astype(np.float32)
    return g._replace(visits=v)


def games_equal(a, b):
    def eq(x, y):
        if x is None or y is None:
            return x is None and y is None
        return (np.array_equal(x, y) and x.dtype == y.dtype
                and x.shape == y.shape)

    return len(a) == len(b) and all(eq(x, y) for x, y in zip(a, b))


def as_ref(g):
    return ref_replay.ZeroGames(*g)


# ---------------------------------------------------------- records


@pytest.mark.parametrize("games", [make_games(0), make_games(1, ext=True),
                                   gumbel_games(2)],
                         ids=["v1", "v2", "v2-float-targets"])
def test_records_and_ids_cross_both_ways(games):
    assert replay.compute_game_id(games) == \
        ref_replay.compute_game_id(as_ref(games))
    mine = replay.games_to_record(games, version=7, seq=3)
    theirs = ref_replay.games_to_record(as_ref(games), version=7, seq=3)
    assert json.dumps(mine) == json.dumps(theirs)
    got, version = ref_replay.record_to_games(json.loads(json.dumps(mine)))
    assert version == 7 and games_equal(tuple(got), tuple(games))
    back, version = replay.record_to_games(json.loads(json.dumps(theirs)))
    assert version == 7 and games_equal(back, games)
    assert replay.record_game_id(theirs) == mine["game_id"]
    # an id-less record (an older writer): recomputed from the content
    del theirs["game_id"]
    assert replay.record_game_id(theirs) == mine["game_id"]


def test_schema_v1_and_a_newer_schema():
    rec = ref_replay.games_to_record(as_ref(make_games(0)))
    del rec["schema"]                 # a v1 writer wrote no tag
    games, _ = replay.record_to_games(rec)
    assert games.full is None and games.ownership is None \
        and games.score is None
    rec = replay.games_to_record(make_games(0))
    rec["schema"] = replay.RECORD_SCHEMA + 1
    assert replay.RECORD_SCHEMA == ref_replay.RECORD_SCHEMA == 2
    with pytest.raises(replay.UnknownSchemaError):
        replay.record_to_games(rec)
    with pytest.raises(ref_replay.UnknownSchemaError):
        ref_replay.record_to_games(rec)


def test_spills_restore_across_the_packages(tmp_path):
    spill = str(tmp_path / "a")
    ref = ref_replay.ReplayBuffer(capacity=4, spill_dir=spill)
    ref.put(as_ref(make_games(0, ext=True)), version=3)
    ref.put(as_ref(gumbel_games(1)), version=4)
    buf = replay.ReplayBuffer(capacity=4, spill_dir=spill)
    assert buf.restore() == 2
    for version, want in ((3, make_games(0, ext=True)),
                          (4, gumbel_games(1))):
        e = buf.next_batch(timeout=0)
        assert e.version == version and games_equal(e.games, want)
    spill = str(tmp_path / "b")
    buf = replay.ReplayBuffer(capacity=4, spill_dir=spill)
    buf.put(make_games(5), version=9)
    ref = ref_replay.ReplayBuffer(capacity=4, spill_dir=spill)
    assert ref.restore() == 1
    e = ref.next_batch(timeout=0)
    assert e.version == 9 and games_equal(tuple(e.games), make_games(5))


# ---------------------------------------------------------- buffer


def test_fifo_order_fill_and_eviction():
    buf = replay.ReplayBuffer(capacity=3)
    assert buf.capacity == 3 and buf.sample_p == 0.5
    assert replay.ReplayBuffer().capacity == 8
    for i in range(3):
        assert buf.put(make_games(i), version=i)
    assert buf.fill == 3 and buf.ingested_games == 6
    assert buf.put(make_games(3), version=3)          # evicts version 0
    assert not buf.put(make_games(4), version=4, evict=False)
    assert [buf.next_batch(timeout=0).version for _ in range(3)] == \
        [1, 2, 3]
    assert buf.next_batch(timeout=0) is None
    with pytest.raises(ValueError):
        replay.ReplayBuffer(capacity=0)
    with pytest.raises(ValueError):
        replay.ReplayBuffer(sample_p=0.0)


def test_paced_put_waits_for_a_consumer():
    buf = replay.ReplayBuffer(capacity=1)
    assert buf.put(make_games(0), version=0, block=True, timeout=0)
    assert not buf.put(make_games(1), version=1, block=True, timeout=0.01)
    waiting, done = threading.Event(), []

    def producer():
        waiting.set()
        done.append(buf.put(make_games(1), version=1, block=True))

    t = threading.Thread(target=producer)
    t.start()
    waiting.wait()
    assert buf.next_batch().version == 0
    t.join()
    assert done == [True] and buf.next_batch().version == 1


def test_sample_draws_as_the_reference_and_keeps_entries():
    mine = replay.ReplayBuffer(capacity=8, sample_p=0.5, seed=1)
    ref = ref_replay.ReplayBuffer(capacity=8, sample_p=0.5, seed=1)
    for i in range(8):
        mine.put(make_games(i), version=i)
        ref.put(as_ref(make_games(i)), version=i)
    got = [mine.sample(timeout=0).version for _ in range(200)]
    want = [ref.sample(timeout=0).version for _ in range(200)]
    assert got == want and mine.fill == 8
    assert sum(v == 7 for v in got) > 200 * 0.3       # p 0.5: the newest


def test_close_wakes_consumers_and_refuses_puts():
    buf = replay.ReplayBuffer(capacity=2)
    got = []
    t = threading.Thread(target=lambda: got.append(buf.next_batch()))
    t.start()
    buf.close()
    t.join()
    assert got == [None] and buf.closed
    assert not buf.put(make_games(0))
    assert buf.sample() is None


def test_spill_restore_skips_torn_files(tmp_path):
    spill = str(tmp_path / "replay")
    buf = replay.ReplayBuffer(capacity=4, spill_dir=spill)
    buf.put(make_games(0), version=3)
    buf.put(make_games(1, ext=True), version=4)
    buf.put(make_games(2), version=5)
    assert buf.next_batch(timeout=0).version == 3     # consumed: unspilled
    assert len(os.listdir(spill)) == 2
    with open(os.path.join(spill, "entry.dead.00000099.json"), "w") as f:
        f.write('{"version": 1, "actions": [[1')       # torn
    fresh = replay.ReplayBuffer(capacity=4, spill_dir=spill)
    assert fresh.restore() == 2
    e = fresh.next_batch(timeout=0)
    assert e.version == 4 and games_equal(e.games, make_games(1, ext=True))
    assert fresh.next_batch(timeout=0).version == 5
    # everything restored was consumed: nothing left to restore twice
    assert replay.ReplayBuffer(capacity=4, spill_dir=spill).restore() == 0


def test_restore_is_atomic_against_live_puts(tmp_path):
    spill = str(tmp_path / "spill")
    old = replay.ReplayBuffer(capacity=8, spill_dir=spill)
    for i in range(3):
        old.put(make_games(i), version=i)
    buf = replay.ReplayBuffer(capacity=16, spill_dir=spill)
    start = threading.Barrier(2)
    restored = []

    def producer():
        start.wait()
        for i in range(5):
            buf.put(make_games(100 + i), version=100 + i)

    def restorer():
        start.wait()
        restored.append(buf.restore())

    threads = [threading.Thread(target=producer),
               threading.Thread(target=restorer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert restored == [3]
    versions = []
    while (e := buf.next_batch(timeout=0)) is not None:
        versions.append(e.version)
    assert [v for v in versions if v < 100] == [0, 1, 2]
    assert [v for v in versions if v >= 100] == list(range(100, 105))
    first = versions.index(0)
    assert versions[first:first + 3] == [0, 1, 2]
    assert replay.ReplayBuffer(capacity=16, spill_dir=spill).restore() == 0


def test_discard_spill_clears_without_reinserting(tmp_path):
    spill = str(tmp_path / "spill")
    buf = replay.ReplayBuffer(capacity=4, spill_dir=spill)
    buf.put(make_games(0), version=1)
    buf.put(make_games(1), version=2)
    again = replay.ReplayBuffer(capacity=4, spill_dir=spill)
    assert again.discard_spill() == 2
    assert os.listdir(spill) == [] and again.restore() == 0
    assert again.fill == 0


# ---------------------------------------------------------- ingester


def test_ingester_torn_tail_garbage_and_newer_schema(tmp_path):
    shard = str(tmp_path / "actor0.jsonl")
    replay.append_jsonl_record(shard, make_games(0), version=1)
    with open(shard, "a") as f:
        f.write('{"version": 2, "actions": [[1')      # a writer mid-line
    buf = replay.ReplayBuffer(capacity=8)
    ing = replay.JsonlIngester(buf, str(tmp_path))
    assert ing.poll() == 1
    assert ing.poll() == 0
    rec = replay.games_to_record(make_games(5))
    rec["schema"] = replay.RECORD_SCHEMA + 1
    with open(shard, "a") as f:
        f.write("corrupted-not-json\n" + json.dumps(rec) + "\n")
    ref_replay.append_jsonl_record(shard, as_ref(make_games(3, ext=True)),
                                   version=3)
    assert ing.poll() == 1
    assert ing.skipped == 1 and ing.schema_skipped == 1
    assert buf.next_batch(timeout=0).version == 1
    e = buf.next_batch(timeout=0)
    assert e.version == 3 and games_equal(e.games, make_games(3, ext=True))


def test_ingester_rotation_rereads_exactly_once(tmp_path):
    shard = str(tmp_path / "actor0.jsonl")
    for i in range(3):
        replay.append_jsonl_record(shard, make_games(i), version=i + 1)
    buf = replay.ReplayBuffer(capacity=8)
    ing = replay.JsonlIngester(buf, str(tmp_path))
    assert ing.poll() == 3 and ing.shard_rotated == 0
    os.unlink(shard)                # the actor's replacement starts over
    replay.append_jsonl_record(shard, make_games(0), version=1)
    replay.append_jsonl_record(shard, make_games(9), version=9)
    assert ing.poll() == 1
    assert ing.shard_rotated == 1 and ing.dedup_hits == 1
    assert [buf.next_batch(timeout=0).version for _ in range(4)] == \
        [1, 2, 3, 9]
    replay.append_jsonl_record(shard, make_games(8), version=10)
    assert ing.poll() == 1 and ing.shard_rotated == 1


def test_buffer_loses_and_repeats_nothing_under_contention(tmp_path):
    """More producer and consumer threads than cores, a shortened switch
    interval, paced puts into a small spilling buffer: every batch put
    is taken exactly once, and no consumed entry is left on disk."""
    import sys

    producers, consumers, each = 6, 6, 20
    buf = replay.ReplayBuffer(capacity=3, spill_dir=str(tmp_path / "s"))
    taken, lock = [], threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def produce(p):
            for i in range(each):
                assert buf.put(make_games(0), version=p * 1000 + i,
                               block=True, timeout=30)

        def consume():
            while (e := buf.next_batch(timeout=30)) is not None:
                with lock:
                    taken.append(e.version)

        threads = ([threading.Thread(target=produce, args=(p,))
                    for p in range(producers)]
                   + [threading.Thread(target=consume)
                      for _ in range(consumers)])
        for t in threads:
            t.start()
        for t in threads[:producers]:
            t.join(60)
        buf.close()
        for t in threads[producers:]:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sorted(taken) == sorted(p * 1000 + i for p in range(producers)
                                   for i in range(each))
    assert os.listdir(tmp_path / "s") == []
