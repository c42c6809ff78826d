"""The port's transposition cache (``rocalphago_tpu_torch/serve/
evalcache.py``) and the serving seam's eval keys, against the
reference's.

``dihedral_perms``, ``canonical_key`` and the prior reorientation are
bit-identical to the reference's on seeded positions; ``SimStep.
eval_keys`` of the port's searcher (``prepare_sim(keys=True)``) and
``eval_key`` of a batch of roots are the reference's uint32 signatures,
simulation by simulation. Through the batching evaluator a cache hit is
bit-identical to the uncached evaluation, in-batch duplicates collapse
to one device row and fan out, komi and params version keep their own
entries, a retired version evicts its entries, verify mode turns a
forced key collision into a counted miss, and a fault at
``serve.cache`` fails only its batch. The LRU bookkeeping matches the
reference's stats line by line.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from rocalphago_tpu.engine import jaxgo
from rocalphago_tpu.search import device_mcts as ref_mcts
from rocalphago_tpu.serve import evalcache as ref_cache
from rocalphago_tpu_torch.engine import torchgo
from rocalphago_tpu_torch.models import CNNPolicy, CNNValue
from rocalphago_tpu_torch.runtime import faults
from rocalphago_tpu_torch.runtime.faults import InjectedFault
from rocalphago_tpu_torch.search import device_mcts
from rocalphago_tpu_torch.serve import BatchingEvaluator, evalcache
from rocalphago_tpu_torch.serve.evalcache import EvalCache
from rocalphago_tpu_torch.serve.evaluator import cat_states, pad_rows
from torch_port_helpers import (  # noqa: F401
    jax_states,
    one_torch_thread,
    random_games,
    torch_states,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 5
N = SIZE * SIZE
FEATS = ("board", "ones", "turns_since")
VFEATS = FEATS + ("color",)
CFG = jaxgo.GoConfig(size=SIZE)
TCFG = torchgo.GoConfig(size=SIZE)


@pytest.fixture(autouse=True)
def _clean_fault_plan():
    yield
    faults.install(None)


def _key(n, version=0):
    return (n, n + 1, 5, 7.5, version)


@pytest.mark.parametrize("size", [5, 9, 19])
def test_dihedral_perms_are_the_references(size):
    got, want = evalcache.dihedral_perms(size), ref_cache.dihedral_perms(size)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 8
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_canonical_keys_and_priors_are_the_references():
    rng = np.random.default_rng(7)
    for size in (5, 9):
        n = size * size
        for _ in range(20):
            board = rng.integers(-1, 2, n).astype(np.int8)
            buckets = rng.integers(-1, 8, n).astype(np.int8)
            ko = int(rng.integers(-1, n))
            turn, done = int(rng.choice([-1, 1])), bool(rng.integers(2))
            got = evalcache.canonical_key(size, board, buckets, ko, turn,
                                          done)
            want = ref_cache.canonical_key(size, board, buckets, ko, turn,
                                           done)
            assert got == want
            priors = rng.normal(size=n + 1).astype(np.float32)
            t = got[1]
            canon = evalcache.canonicalize_priors(priors, t, size)
            np.testing.assert_array_equal(
                canon, ref_cache.canonicalize_priors(priors, t, size))
            np.testing.assert_array_equal(
                evalcache.orient_priors(canon, t, size), priors)


def fake_policy(params, planes):
    return jax.numpy.zeros((planes.shape[0], N))


def fake_value(params, planes):
    return planes[..., 0].sum(axis=(1, 2)) / N


def test_eval_keys_are_the_references_sim_by_sim():
    """The port's searcher with fake nets, fed the reference's
    evaluations, descends the reference's tree; each simulation's
    ``eval_keys`` and the roots' ``eval_key`` equal the reference's."""
    sts = random_games(SIZE, 4, 0, 14, seed=3)
    jroots, troots = jax_states(CFG, sts), torch_states(SIZE, sts)
    ref = ref_mcts.make_device_mcts(CFG, FEATS, VFEATS, fake_policy,
                                    fake_value, n_sim=12, max_nodes=24)
    port = device_mcts.make_device_mcts(
        TCFG, FEATS, VFEATS,
        lambda p: torch.zeros((p.shape[0], N)),
        lambda p: p[..., 0].sum(dim=(1, 2)) / N, n_sim=12, max_nodes=24)
    with jax.enable_checks(False):
        np.testing.assert_array_equal(
            port.eval_key(troots).numpy(),
            np.asarray(ref.eval_key(jroots)).astype(np.int64))
        jtree = ref.init(None, None, jroots)
        ttree = port.init(troots)
        free_j = jax.numpy.full((4,), -1, jax.numpy.int32)
        free_t = torch.full((4,), -1, dtype=torch.int32)
        jctx = ref.prepare_sim(jtree, free_j)
        tctx = port.prepare_sim(ttree, free_t, keys=True)
        assert port.prepare_sim(ttree, free_t).eval_keys is None
        for sim in range(12):
            np.testing.assert_array_equal(
                tctx.eval_keys.numpy(),
                np.asarray(jctx.eval_keys).astype(np.int64),
                err_msg=f"sim {sim}")
            pr, va = ref.eval_batch(None, None, jctx.eval_states)
            tp = torch.tensor(np.asarray(pr))
            tv = torch.tensor(np.asarray(va))
            jtree, jctx = ref.advance_sim(jtree, jctx, pr, va, free_j)
            ttree = port.apply_sim(ttree, tctx, tp, tv)
            tctx = port.prepare_sim(ttree, free_t, keys=True)
        np.testing.assert_array_equal(ttree.visits.numpy(),
                                      np.asarray(jtree.visits))


# ----------------------------------------------------- the cached path

@pytest.fixture(scope="module")
def search_and_nets():
    kw = dict(board=SIZE, layers=2, filters_per_layer=8, device="cpu",
              dtype=torch.float32)
    pol, val = CNNPolicy(FEATS, seed=1, **kw), CNNValue(VFEATS, seed=2, **kw)
    search = device_mcts.make_device_mcts(TCFG, FEATS, VFEATS, pol.module,
                                          val.module, n_sim=4)
    return search, pol, val


def cached_ev(search_and_nets, cache, **kw):
    search, pol, val = search_and_nets
    kw.setdefault("key_fn", search.eval_key)
    return BatchingEvaluator(
        search.eval_with, pol.module, val.module, batch_sizes=(1, 2, 4),
        eval_komi_fn=search.eval_with, default_komi=TCFG.komi,
        cache=cache, board=SIZE, start=False, **kw)


@functools.lru_cache(maxsize=None)
def boards():
    return random_games(SIZE, 3, 1, 6, seed=9)


def state(i):
    if i < 0:
        return torchgo.new_states(TCFG, 1, device="cpu")
    return torch_states(SIZE, [boards()[i]])


def served(ev, *reqs):
    ev.drain_once()
    return [r.result(timeout=30) for r in reqs]


def test_hit_is_bit_identical_to_the_uncached_row(search_and_nets):
    ev = cached_ev(search_and_nets, EvalCache(capacity=64, shards=2))
    try:
        st = state(0)
        want_p, want_v = ev.eval_direct(st)
        (p1, v1), = served(ev, ev.submit(st))           # miss + insert
        (p2, v2), = served(ev, ev.submit(st))           # a pure hit
        for p, v in ((p1, v1), (p2, v2)):
            assert torch.equal(p, want_p) and torch.equal(v, want_v)
        s = ev.cache.stats()
        assert (s["hits"], s["misses"], s["entries"]) == (1, 1, 1)
        assert ev.rows_total == 2 and ev.unique_rows_total == 1
    finally:
        ev.close()


def test_in_batch_dedup_fans_out(search_and_nets):
    """Four rows in one batch, three unique: one device row saved, the
    unique rows padded to 4, every row its own position's output."""
    ev = cached_ev(search_and_nets, EvalCache(capacity=64, shards=2))
    try:
        sts = [state(-1), state(-1), state(0), state(1)]
        # the unique rows at the size they are evaluated at (a row's
        # float32 output may change with the batch size on the CPU too)
        up, uv = ev.eval_direct(pad_rows(cat_states(
            [sts[0], sts[2], sts[3]]), 4))
        refs = [(up[i:i + 1], uv[i:i + 1]) for i in (0, 0, 1, 2)]
        outs = served(ev, *[ev.submit(st) for st in sts])
        assert ev.batches == 1 and ev.rows_total == 4
        assert ev.unique_rows_total == 3 and ev.dedup_rows_saved_total == 1
        assert ev.padded_total == 4
        for (p, v), (rp, rv) in zip(outs, refs):
            assert torch.equal(p, rp) and torch.equal(v, rv)
        assert ev.stats()["dedup_saved"] == 1
    finally:
        ev.close()


def test_komi_and_version_keep_their_own_entries(search_and_nets):
    search, pol, val = search_and_nets
    ev = cached_ev(search_and_nets, EvalCache(capacity=64, shards=1))
    try:
        st = state(-1)
        (p0, _), = served(ev, ev.submit(st))
        served(ev, ev.submit(st, komi=9.5))
        s = ev.cache.stats()
        assert (s["misses"], s["hits"], s["entries"]) == (2, 0, 2)
        served(ev, ev.submit(st), ev.submit(st, komi=9.5))
        assert ev.cache.stats()["hits"] == 2
        ev.set_params(pol.module, val.module)   # version 0 retires
        s = ev.cache.stats()
        assert s["entries"] == 0 and s["evictions"] == 2
        (p1, _), = served(ev, ev.submit(st))
        assert torch.equal(p1, p0) and ev.cache.stats()["misses"] == 3
        v = ev.add_version(pol.module, val.module)
        served(ev, ev.submit(st, version=v))
        assert ev.cache.stats()["entries"] == 2
        ev.release(v)                           # the stage pin drops
        assert ev.cache.stats()["entries"] == 1
    finally:
        ev.close()


def test_forced_collision_is_detected(search_and_nets):
    ev = cached_ev(search_and_nets,
                   EvalCache(capacity=16, shards=1, verify=True),
                   key_fn=lambda s: np.zeros((s.board.shape[0], 2),
                                             np.int64))
    try:
        a, b = state(-1), state(0)
        served(ev, ev.submit(a))
        (pb, vb), = served(ev, ev.submit(b))    # same key, other board
        want_p, want_v = ev.eval_direct(b)
        assert torch.equal(pb, want_p) and torch.equal(vb, want_v)
        s = ev.cache.stats()
        assert (s["collisions"], s["hits"], s["misses"]) == (1, 0, 2)
    finally:
        ev.close()


def test_symmetry_mode_serves_a_transformed_hit(search_and_nets):
    """Symmetry folding: a position and its mirror share one entry,
    the hit's priors reoriented (approximate by design: the net is not
    equivariant, so only the support is checked)."""
    ev = cached_ev(search_and_nets, EvalCache(capacity=16, symmetry=True))
    try:
        st = state(0)
        perms, _ = evalcache.dihedral_perms(SIZE)
        mirror = st._replace(board=st.board[:, perms[1]],
                             stone_ages=st.stone_ages[:, perms[1]],
                             labels=torchgo.compute_labels(
                                 TCFG, st.board[:, perms[1]]),
                             ko=torch.full_like(st.ko, -1),
                             hash=torch.zeros_like(st.hash))
        st = st._replace(ko=torch.full_like(st.ko, -1))
        (p0, _), = served(ev, ev.submit(st))
        (p1, _), = served(ev, ev.submit(mirror))
        s = ev.cache.stats()
        assert (s["hits"], s["misses"]) == (1, 1)
        np.testing.assert_array_equal(
            (p1[0, :N][perms[1]] > 0).numpy(), (p0[0, :N] > 0).numpy())
    finally:
        ev.close()


def test_cache_barrier_fails_only_the_batch(search_and_nets):
    ev = cached_ev(search_and_nets, EvalCache(capacity=16, shards=1))
    try:
        faults.install("io_error@serve.cache:1")
        req = ev.submit(state(-1))
        ev.drain_once()
        with pytest.raises(InjectedFault):
            req.result(timeout=30)
        (p, _), = served(ev, ev.submit(state(-1)))
        assert p.shape == (1, N + 1)
        assert ev.failures == 1 and ev.batches == 2
    finally:
        ev.close()


def test_lru_bookkeeping_is_the_references():
    """The same operations on both caches give the same stats."""
    def script(cache_mod):
        c = cache_mod.EvalCache(capacity=4, shards=1, verify=True)
        log = []
        for n in range(4):
            c.insert(_key(n), n, board_bytes=bytes([n]))
        log.append(c.lookup(_key(0), board_bytes=bytes([0])))
        c.insert(_key(9), 9)
        log.append(c.lookup(_key(1)))
        log.append(c.lookup(_key(2), board_bytes=b"x"))   # a collision
        c.insert(_key(5, version=3), 5)
        log.append(c.evict_version(3))
        log.append(c.stats())
        c.clear()
        log.append((len(c), c.stats()["entries"]))
        return log

    assert script(evalcache) == script(ref_cache)
    assert evalcache.disabled_stats() == ref_cache.disabled_stats()
    c = EvalCache()
    assert (c.capacity, c.shards, c.verify, c.symmetry) == (
        100_000, 8, False, False)
    assert EvalCache(symmetry=True, verify=True).verify is False
