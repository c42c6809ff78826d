"""The port's live rollout (``rocalphago_tpu_torch/rollout``, the pools'
staged versions, the gateway's canary arm) against the reference's, on
the CPU.

The evaluator serves a pinned request on its version and never
coalesces a batch across a version edge, the same trail as the
reference's; both pools stage, promote and discard; a spill crosses the
packages both ways, and after the swap the port's genmove equals the
reference's (the 2 × 8 float32 5×5 nets of ``tests/test_torch_gateway.
py``, carried across with ``params_from_flax``: each genmove is a batch
of one and the PUCT search has no draw); the canary's decisions and arm
sequences are the reference's on scripted outcomes; the router's
sticky, spillover, failover, convergence and refusal scripts write the
reference router's frames, ``elapsed_ms`` aside; and a hot swap never
hands a running forward of the pool's nets half-swapped weights. No
wall-clock bound is asserted.
"""

import json
import socket
from contextlib import closing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.engine import pygo as ref_pygo
from rocalphago_tpu.gateway import client as ref_gw_client
from rocalphago_tpu.gateway.server import GatewayServer as RefGateway
from rocalphago_tpu.models import CNNPolicy as RefPolicy
from rocalphago_tpu.models import CNNValue as RefValue
from rocalphago_tpu.rollout import canary as ref_canary
from rocalphago_tpu.rollout import hotswap as ref_hotswap
from rocalphago_tpu.rollout import router as ref_router
from rocalphago_tpu.runtime import faults as ref_faults
from rocalphago_tpu.serve import BatchingEvaluator as RefEvaluator
from rocalphago_tpu.serve import ServePool as RefPool
from rocalphago_tpu.training import actor as ref_actor
from rocalphago_tpu_torch.engine import pygo, torchgo
from rocalphago_tpu_torch.gateway import client as gw_client
from rocalphago_tpu_torch.gateway import protocol
from rocalphago_tpu_torch.gateway.server import GatewayServer
from rocalphago_tpu_torch.models import CNNPolicy, CNNValue
from rocalphago_tpu_torch.models.weights import params_from_flax, params_to_flax
from rocalphago_tpu_torch.multisize import MultiSizePool
from rocalphago_tpu_torch.rollout import canary, hotswap, router
from rocalphago_tpu_torch.runtime import faults
from rocalphago_tpu_torch.serve import BatchingEvaluator, ServePool
from rocalphago_tpu_torch.training import actor
from rocalphago_tpu_torch.training.zero import snapshot
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 5
FEATS = ("board", "ones")
VFEATS = FEATS + ("color",)
N_SIM = 8

PORT = dict(name="port", pygo=pygo, gateway=GatewayServer, client=gw_client,
            canary=canary, router=router, faults=faults)
REF = dict(name="ref", pygo=ref_pygo, gateway=RefGateway,
           client=ref_gw_client, canary=ref_canary, router=ref_router,
           faults=ref_faults)


@pytest.fixture(autouse=True)
def _clean_fault_plans():
    yield
    faults.install(None)
    ref_faults.install(None)


@pytest.fixture(scope="module")
def nets():
    """2 × 8 FCN nets of both packages, carried across in float32."""
    kw = dict(board=SIZE, layers=2, filters_per_layer=8)
    with jax.enable_checks(False):
        rp = RefPolicy(FEATS, seed=1, **kw)
        rv = RefValue(VFEATS, seed=2, **kw)
        pp = CNNPolicy(FEATS, init_weights=False, device="cpu",
                       dtype=torch.float32, **kw)
        pv = CNNValue(VFEATS, init_weights=False, device="cpu",
                      dtype=torch.float32, **kw)
        for ref, port in ((rp, pp), (rv, pv)):
            ref.module = ref.module.clone(dtype=jnp.float32)
            ref._apply = jax.jit(ref.module.apply)
            port.module.load_state_dict(params_from_flax(
                jax.tree.map(np.asarray, ref.params)))
    return rp, rv, pp, pv


@pytest.fixture(scope="module")
def pools(nets):
    """One warm pool of each package; extra pools share its searcher."""
    rp, rv, pp, pv = nets
    kw = dict(n_sim=N_SIM, max_sessions=4, batch_sizes=(1, 2, 4),
              max_wait_us=2000)
    with jax.enable_checks(False):
        ref = RefPool(rv, rp, **kw)
        ref.warm()
    port = ServePool(pv, pp, **kw)
    port.warm()
    yield {"port": port, "ref": ref}
    port.close()
    ref.close()


def port_scaled(module, scale: float) -> dict:
    return {k: v * scale for k, v in module.state_dict().items()}


def ref_scaled(params, scale: float):
    return jax.tree.map(lambda x: x * scale, params)


# ------------------------------------------------ versioned evaluator

def port_fake():
    def ev(pp, pv, states):
        b = states.board.shape[0]
        return (torch.full((b, 4), float(pp["tag"])),
                torch.full((b,), float(pp["tag"])))
    cfg = torchgo.GoConfig(size=SIZE)
    states = lambda: torchgo.new_states(cfg, 1, device="cpu")  # noqa: E731
    return BatchingEvaluator(ev, {"tag": 0.0}, {"tag": 0.0},
                             batch_sizes=(1, 2, 4), start=False), states


def ref_fake():
    def ev(pp, pv, states):
        b = states["board"].shape[0]
        tag = float(np.asarray(pp["tag"]))
        return (np.full((b, 4), tag, np.float32),
                np.full((b,), tag, np.float32))
    states = lambda: {"board": np.zeros((1, SIZE, SIZE),  # noqa: E731
                                        np.float32)}
    return RefEvaluator(ev, {"tag": np.float32(0.0)},
                        {"tag": np.float32(0.0)}, batch_sizes=(1, 2, 4),
                        start=False), states


def tag(x) -> dict:
    return {"tag": float(x)}


def ev_trail(make, script: str) -> list:
    ev, states = make()
    trail = []

    def retired(fn):
        try:
            fn()
            return False
        except KeyError:
            return True

    try:
        if script == "pin":
            before = ev.submit(states(), rows=1)
            v1 = ev.set_params(tag(1), tag(1))
            after = ev.submit(states(), rows=1)
            ev.drain_once()
            ev.drain_once()
            trail += [float(before.result(timeout=5)[0][0, 0]),
                      float(after.result(timeout=5)[0][0, 0]), v1,
                      ev.stats()["params_version"], ev.stats()["swaps"],
                      retired(lambda: ev.acquire(0))]
        elif script == "edge":
            reqs = [ev.submit(states(), rows=1)]
            ev.set_params(tag(1), tag(1))
            reqs += [ev.submit(states(), rows=1) for _ in range(2)]
            ev.drain_once()
            trail += [ev.batches, ev.rows_total]
            ev.drain_once()
            trail += [ev.batches, ev.rows_total]
            trail += [float(r.result(timeout=5)[0][0, 0]) for r in reqs]
        else:
            staged = ev.add_version(tag(2), tag(2))
            trail += [staged, ev.params_version, ev.acquire(staged)]
            ev.release(staged)
            ev.set_params(version=staged)
            trail += [ev.params_version, retired(lambda: ev.acquire(0))]
            dead = ev.add_version(tag(3), tag(3))
            ev.release(dead)
            trail += [dead, retired(lambda: ev.acquire(dead)),
                      retired(lambda: ev.set_params(version=dead))]
    finally:
        ev.close()
    return trail


@pytest.mark.parametrize("script", ["pin", "edge", "stage"])
def test_versioned_evaluator_keeps_the_references_trail(script):
    got = ev_trail(port_fake, script)
    assert got == ev_trail(ref_fake, script)
    if script == "pin":
        assert got[:2] == [0.0, 1.0] and got[-1] is True
    elif script == "edge":
        # one device batch, one net: the version edge splits the queue
        assert got == [1, 1, 2, 3, 0.0, 1.0, 1.0]


# ------------------------------------------------- the pools' versions

def pool_trail(pool, scaled, pkg) -> list:
    """Stage, pin, discard (the pin falls back), stage and promote."""
    trail = [pool.params_version]
    staged = pool.stage_params(*scaled(1.5))
    trail += [staged, pool.params_version]
    game = pkg["pygo"].GameState(size=SIZE)
    with pool.open_session(resilient=False) as sess:
        sess.pin_version(staged)
        mv = sess.get_move(game)
        trail += [mv, sess.params_version]
        pool.discard_version(staged)
        mv = sess.get_move(game)
        trail += [mv, sess.params_version, sess.raw.pinned_version]
    promo = pool.stage_params(*scaled(0.5))
    v = pool.promote_version(promo)
    trail += [promo, v, pool.params_version, pool.stats()["params"]]
    with pool.open_session(resilient=False) as sess:
        trail += [sess.get_move(game), sess.params_version]
    back = pool.stage_params(*scaled(1.0))
    trail += [pool.promote_version(back)]
    return trail


def test_serve_pools_stage_promote_and_discard_alike(pools, nets):
    rp, rv, pp, pv = nets
    port, ref = pools["port"], pools["ref"]
    got = pool_trail(port, lambda s: (port_scaled(pp.module, s),
                                      port_scaled(pv.module, s)), PORT)
    with jax.enable_checks(False):
        want = pool_trail(ref, lambda s: (ref_scaled(rp.params, s),
                                          ref_scaled(rv.params, s)), REF)
    assert got == want
    v0, staged = got[0], got[1]
    # pinned on the staged version, then back on current after discard
    assert got[2] == v0 and got[4] == staged
    assert got[6] == v0 and got[7] is None
    assert got[10] == got[8] == got[9]


def test_multisize_pool_fans_one_version_across_the_ladder(nets):
    pol = CNNPolicy(FEATS, board=SIZE, layers=1, filters_per_layer=4,
                    device="cpu", dtype=torch.float32)
    val = CNNValue(VFEATS, board=SIZE, layers=1, filters_per_layer=4,
                   device="cpu", dtype=torch.float32)
    msp = MultiSizePool(val, pol, sizes=(5, 7), n_sim=2,
                        batch_sizes=(1, 2))
    try:
        base = pol.module.state_dict()
        doubled = {k: 2 * v for k, v in base.items()}
        staged = msp.stage_params(doubled, val.module.state_dict())
        assert msp.params_version == 0 and all(
            msp.pool_for(s).evaluator.version_params(staged) is not None
            for s in (5, 7))
        with msp.open_session(size=7, resilient=False) as sess:
            sess.pin_version(staged)
            assert sess.get_move(pygo.GameState(size=7)) is not None
            assert sess.params_version == staged
            msp.discard_version(staged)
            sess.get_move(pygo.GameState(size=7))
            assert sess.params_version == 0
        for s in (5, 7):
            with pytest.raises(KeyError):
                msp.pool_for(s).evaluator.acquire(staged)
        promo = msp.stage_params(doubled, val.module.state_dict())
        assert msp.promote_version(promo) == promo
        assert [msp.pool_for(s).params_version for s in (5, 7)] == [promo,
                                                                     promo]
        # the source nets follow, so a new size shares the promoted pair
        assert torch.equal(pol.module.state_dict()["head.conv.weight"],
                           doubled["head.conv.weight"])
        assert msp.stats()["params_version"] == promo
    finally:
        msp.close()


# --------------------------------------------------- spills, both ways

def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def same_tree(a, b) -> bool:
    fa, fb = flat(a), flat(b)
    return fa.keys() == fb.keys() and all(
        np.array_equal(fa[k], fb[k]) for k in fa)


def test_a_spill_crosses_the_packages_both_ways(tmp_path, pools, nets):
    rp, rv, pp, pv = nets
    port, ref = pools["port"], pools["ref"]
    held = [{k: v.clone() for k, v in n.module.state_dict().items()}
            for n in (pp, pv)]
    ref_held = rp.params, rv.params
    game = pygo.GameState(size=SIZE)
    ref_game = ref_pygo.GameState(size=SIZE)
    for st in (game, ref_game):
        st.do_move((2, 2))
        st.do_move((1, 3))
    # the port publishes, the reference's watcher swaps its pool
    pub = actor.ParamsPublisher(spill_dir=str(tmp_path / "p"))
    pol_new = snapshot(pp.module)
    pol_new.load_state_dict(port_scaled(pp.module, 0.5))
    v0 = pub.publish(pol_new, snapshot(pv.module))
    v1 = pub.publish(pol_new, snapshot(pv.module))
    names = sorted(p.name for p in (tmp_path / "p").iterdir())
    assert names == ["rollout.json", f"spill.{v1:05d}.policy.msgpack",
                     f"spill.{v1:05d}.value.msgpack"] and v0 == v1 - 1
    with jax.enable_checks(False):
        rw = ref_hotswap.SpillWatcher(
            str(tmp_path / "p"), ref_hotswap.HotSwapper(ref), rp.params,
            rv.params)
        assert rw.poll_once() is True and rw.poll_once() is False
        assert same_tree(jax.device_get(ref.policy.params),
                         params_to_flax(pol_new.state_dict()))
    # the reference publishes, the port's watcher swaps its pool
    with jax.enable_checks(False):
        rpub = ref_actor.ParamsPublisher(spill_dir=str(tmp_path / "r"))
        # the reference's pool already serves pol_new: publish it, a
        # real swap for the port's pool
        rpub.publish(rp.params, rv.params)
    pw = hotswap.SpillWatcher(str(tmp_path / "r"), hotswap.HotSwapper(port),
                              pp.module, pv.module)
    assert pw.poll_once() is True and pw.poll_once() is False
    assert pw.swapper.version == 0 == rw.swapper.version - v1
    got = params_to_flax(port.policy.module.state_dict())
    assert same_tree(got, jax.device_get(ref.policy.params))
    # both pools now serve the same pair: the same genmove
    with port.open_session(resilient=False) as s:
        mv = s.get_move(game)
        assert s.params_version == port.params_version
    with jax.enable_checks(False), ref.open_session(resilient=False) as s:
        assert s.get_move(ref_game) == mv
    # back to the weights the test found, in both pools
    port.set_params(*held)
    with jax.enable_checks(False):
        ref.set_params(*ref_held)


def test_publisher_watcher_passes_state_dicts(pools, nets):
    _, _, pp, pv = nets
    port = pools["port"]
    pub = actor.ParamsPublisher()
    swapper = hotswap.HotSwapper(port)
    watch = hotswap.PublisherWatcher(pub, swapper, poll_s=0.01)
    assert watch.poll_once() is False
    pub.publish(snapshot(pp.module), snapshot(pv.module), version=4)
    assert watch.poll_once() is True and swapper.version == 4
    assert swapper.swaps == 1 and torch.equal(
        port.policy.module.state_dict()["head.conv.weight"],
        pp.module.state_dict()["head.conv.weight"])


# --------------------------------------------------------------- canary

class FakePool:
    """Records the pool calls the controller makes."""

    def __init__(self):
        self.version = 1
        self._next = 2
        self.calls: list = []

    @property
    def params_version(self):
        return self.version

    def stage_params(self, pp, pv, version=None):
        v = self._next if version is None else int(version)
        self._next = v + 1
        self.calls.append(("stage", v))
        return v

    def promote_version(self, v):
        self.calls.append(("promote", v))
        self.version = v

    def discard_version(self, v):
        self.calls.append(("discard", v))


CANARY_SCRIPTS = {
    "strong": (0.5, 6, ["c+"] * 6),
    "weak": (0.5, 6, ["c+"] + ["c-"] * 5 + ["stage"] + ["c+"] * 2),
    "waits": (0.5, 4, ["i+"] * 10 + ["c+"] * 4),
    "assign": (0.25, 4, ["a"] * 8 + ["c-", "i+", "c+", "a", "a"]),
}


def canary_trail(pkg, script: str) -> list:
    fraction, min_games, steps = CANARY_SCRIPTS[script]
    fp = FakePool()
    can = pkg["canary"].CanaryController(fp, fraction=fraction,
                                         min_games=min_games)
    trail = [can.stage({"p": 1}, {"v": 1})]
    for step in steps:
        if step == "a":
            trail.append(can.assign())
        elif step == "stage":
            trail.append(can.stage({"p": 2}, {"v": 2}))
        else:
            arm = "candidate" if step[0] == "c" else "incumbent"
            trail.append(can.record(arm, won=step[1] == "+"))
    trail += [fp.calls, can.stats()]
    return trail


@pytest.mark.parametrize("script", list(CANARY_SCRIPTS))
def test_canary_decides_as_the_reference(script):
    got = canary_trail(PORT, script)
    assert got == canary_trail(REF, script)
    stats = got[-1]
    if script == "strong":
        assert stats["promotions"] == 1 and stats["wilson_lb"] >= 0.5
    if script == "weak":
        assert stats["rollbacks"] == 1 and stats["state"] == "running"
    if script == "assign":
        assert stats["assigned"] == {"candidate": 2, "incumbent": 8}
    assert canary.FRACTION == 0.1 and canary.MIN_GAMES == 32


def test_gateway_canary_arm_searches_on_the_staged_version(pools, nets):
    _, _, pp, pv = nets
    port = pools["port"]
    acquired = []
    plain = port.evaluator.acquire

    def recording(version=None):
        v = plain(version)
        acquired.append(v)
        return v

    port.evaluator.acquire = recording
    held = [{k: v.clone() for k, v in n.module.state_dict().items()}
            for n in (pp, pv)]
    can = canary.CanaryController(port, fraction=1.0, min_games=4)
    srv = GatewayServer(port, max_conns=4, canary=can).start()
    try:
        staged = can.stage(port_scaled(pp.module, 1.1),
                           pv.module.state_dict())
        with closing(gw_client.GatewayClient("127.0.0.1", srv.port)) as c:
            c.new_game(board=SIZE)
            assert "move" in c.genmove("b")
        assert acquired == [staged] and can.stats()["assigned"] == {
            "candidate": 1, "incumbent": 0}
        for _ in range(4):
            can.record("candidate", won=True)
        assert can.state == "promoted" and port.params_version == staged
        # a second candidate, rolled back under a pinned live session
        acquired.clear()
        second = can.stage(port_scaled(pp.module, 0.9),
                           pv.module.state_dict())
        with closing(gw_client.GatewayClient("127.0.0.1", srv.port)) as c:
            c.new_game(board=SIZE)
            c.genmove("b")
            for _ in range(4):
                can.record("candidate", won=False)
            assert can.state == "rolled_back"
            c.genmove("w")
        assert acquired == [second, staged]   # fell back to current
        assert srv.stats()["requests"]["unhandled"] == 0
    finally:
        srv.close()
        port.evaluator.acquire = plain
        port.set_params(*held)          # the weights the test found


# --------------------------------------------------------------- router

class Raw:
    """A raw NDJSON client keeping every frame (``elapsed_ms`` dropped:
    the one wall-clock field)."""

    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=60)
        self.reader = self.sock.makefile("rb")
        self.frames = [self._read()]
        self._id = 0

    def _read(self):
        line = self.reader.readline()
        if not line:
            return None
        frame = json.loads(line)
        frame.pop("elapsed_ms", None)
        return frame

    def ask(self, **msg) -> dict:
        self._id += 1
        self.sock.sendall(protocol.encode_frame(dict(msg, id=self._id)))
        frame = self._read()
        self.frames.append(frame)
        return frame

    def close(self) -> None:
        self.reader.close()
        self.sock.close()


def fleet(pkg, pool, nets):
    """Two replicas: ``a`` over a 1-session pool sharing ``pool``'s
    searcher (the spillover victim), ``b`` over ``pool``."""
    rp, rv, pp, pv = nets
    pol, val = (pp, pv) if pkg is PORT else (rp, rv)
    kw = dict(n_sim=N_SIM, max_sessions=1, batch_sizes=(1, 2, 4),
              max_wait_us=2000, searcher=pool.search)
    small = (ServePool if pkg is PORT else RefPool)(val, pol, **kw)
    a = pkg["gateway"](small, max_conns=4).start()
    b = pkg["gateway"](pool, max_conns=4).start()
    R = pkg["router"].Replica
    reps = [R("127.0.0.1", a.port, gateway=a, name="a"),
            R("127.0.0.1", b.port, gateway=b, name="b")]
    return reps, a, b, small


def route_script(pkg, pool, nets, script: str) -> list:
    reps, a, b, small = fleet(pkg, pool, nets)
    trail = []
    try:
        with pkg["router"].RolloutRouter(reps, max_conns=8).start() as rt:
            if script == "sticky":
                cs = [Raw(rt.port) for _ in range(2)]
                for c in cs:
                    c.ask(type="new_game", board=SIZE)
                for _ in range(2):
                    for c in cs:
                        c.ask(type="genmove", color="b")
            elif script == "spillover":
                cs = [Raw(rt.port) for _ in range(3)]
                for c in cs:
                    c.ask(type="new_game", board=SIZE)
                    c.ask(type="genmove", color="b")
            elif script == "failover":
                cs = [Raw(rt.port)]
                c = cs[0]
                c.ask(type="new_game", board=SIZE)
                moved = c.ask(type="genmove", color="b")["move"]
                c.ask(type="play", color="w",
                      move="C3" if moved != "C3" else "C2")
                holder = a if rt.stats()["replicas"]["a"]["sessions"] else b
                holder.drain(timeout=1.0)
                c.ask(type="genmove", color="b")
                c.ask(type="genmove", color="w")
            elif script == "convergence":
                cs = []
                rt.poll_health_once()
                trail.append([r.healthy for r in reps])
                target = max(r.gateway.pool.params_version
                             for r in reps) + 1
                for r in reps:
                    p = r.gateway.pool
                    if pkg is PORT:
                        p.set_params(p.policy.module.state_dict(),
                                     p.value.module.state_dict(),
                                     version=target)
                    else:
                        p.set_params(p.policy.params, p.value.params,
                                     version=target)
                trail.append(rt.await_convergence(target, timeout=10))
                trail.append(sorted(r.params_version >= target
                                    for r in reps))
            else:                                   # refusal
                cs = []
                a.drain(timeout=0.5)
                b.drain(timeout=0.5)
                rt.poll_health_once()
                c = Raw(rt.port)
                trail.append(c.frames)
                c.close()
            for c in cs:
                trail.append(c.frames)
                c.close()
            st = rt.stats()
            trail.append({k: st[k] for k in ("routed", "spillovers",
                                             "failovers",
                                             "retried_genmoves")})
            trail.append({n: r["routed"] for n, r in st["replicas"].items()})
    finally:
        a.close()
        b.close()
        small.close()
    return trail


@pytest.mark.parametrize("script", ["sticky", "spillover", "failover",
                                    "convergence", "refusal"])
def test_router_scripts_write_the_references_frames(script, pools, nets):
    got = route_script(PORT, pools["port"], nets, script)
    with jax.enable_checks(False):
        want = route_script(REF, pools["ref"], nets, script)
    assert got == want
    counts, shares = got[-2], got[-1]
    if script == "sticky":
        assert shares == {"a": 1, "b": 1}
    elif script == "spillover":
        assert counts["spillovers"] >= 1
    elif script == "failover":
        assert counts["failovers"] == 1 and counts["retried_genmoves"] == 1
        assert all(f["type"] != "error" for f in got[0])
    elif script == "convergence":
        assert got[:3] == [[True, True], True, [True, True]]
    else:
        (hello,) = got[0]
        assert hello["code"] == "overload" and hello["retry_after_s"] == 1.0


# ---------------------------------------------------------- the facade

def test_a_swap_never_tears_a_running_forward():
    """The ladder's policy rung forwards the pool's facade net on its own
    thread. A swap that lands mid-forward (here: from a hook between the
    trunk and the head) must leave that forward on whole old weights;
    copying the new weights into the live module would tear it."""
    kw = dict(board=SIZE, layers=2, filters_per_layer=4, device="cpu",
              dtype=torch.float32)
    pol = CNNPolicy(FEATS, seed=3, **kw)
    val = CNNValue(VFEATS, seed=4, **kw)
    pool = ServePool(val, pol, n_sim=2, batch_sizes=(1,))
    try:
        planes = pol._states_to_planes(pygo.GameState(size=SIZE))
        old_sd = {k: v.clone() for k, v in pol.module.state_dict().items()}
        new_sd = {k: -v for k, v in old_sd.items()}
        old = pol.forward(planes)
        probe = snapshot(pol.module)
        probe.load_state_dict(new_sd)
        new = probe(planes)

        def swap_mid_forward(swap):
            fired = []

            def hook(module, args):
                if not fired:
                    fired.append(True)
                    swap()
            handle = pol.module.head.register_forward_pre_hook(hook)
            try:
                return pol.forward(planes)
            finally:
                handle.remove()

        # the hazard: an in-place copy mid-forward mixes the two nets
        torn = swap_mid_forward(lambda: pol.module.load_state_dict(new_sd))
        assert not torch.equal(torn, old) and not torch.equal(torn, new)
        pol.module.load_state_dict(old_sd)
        # the pool's swap: the running forward ends on the old net, the
        # next one runs on the new
        held = pol.module
        got = swap_mid_forward(
            lambda: pool.set_params(new_sd, val.module.state_dict()))
        assert torch.equal(got, old)
        assert pol.module is not held and torch.equal(pol.forward(planes),
                                                      new)
        assert all(torch.equal(v, old_sd[k])
                   for k, v in held.state_dict().items())
    finally:
        pool.close()
