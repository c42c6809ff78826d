"""The port's degradation ladder (``rocalphago_tpu_torch/interface/
resilient.py``), fault barriers and error classifier, against the
reference's.

A scripted primary player (its errors chosen call by call) and the
fault plans of the chaos suite drive the port's ``ResilientPlayer`` and
the reference's through the same 9×9 game, with the in-repo ``puct``
policy carried across in float32 for the policy rung: every move, every
rung served and the final ``stats()`` (latencies aside) are equal. The
fallback rung's move is the reference's; a hang is abandoned by the
watchdog in both. Errors of the device map across as the classifier
sees them: the card's out-of-memory error stands where the reference
has XLA's ``RESOURCE_EXHAUSTED`` (both transient: the reduced rung),
and a sticky CUDA error where it has a non-retryable XLA status (both
not transient: the policy rung). ``is_transient``'s table and the fault
plans' parser are held to the reference's row by row.
"""

import os
import threading

import jax
import jax.numpy as jnp
import pytest
import torch

from rocalphago_tpu.engine import pygo as ref_pygo
from rocalphago_tpu.interface.resilient import ResilientPlayer as RefLadder
from rocalphago_tpu.models import NeuralNetBase as RefNet
from rocalphago_tpu.runtime import faults as ref_faults
from rocalphago_tpu.runtime.retries import is_transient as ref_transient
from rocalphago_tpu.serve.admission import \
    EvaluatorOverload as RefOverload
from rocalphago_tpu_torch.engine import pygo
from rocalphago_tpu_torch.interface import gtp
from rocalphago_tpu_torch.interface.resilient import (
    RUNGS,
    ResilientPlayer,
    percentile,
)
from rocalphago_tpu_torch.models import NeuralNetBase
from rocalphago_tpu_torch.runtime import faults
from rocalphago_tpu_torch.runtime.deadline import Deadline
from rocalphago_tpu_torch.runtime.retries import is_transient
from rocalphago_tpu_torch.serve.admission import EvaluatorOverload
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(ROOT, "results/zero_r5/target_compare/puct/policy.json")
OPENING = [(2, 2), (6, 6), (2, 6), (6, 2), (4, 4)]


@pytest.fixture(autouse=True)
def _clean_fault_plans():
    yield
    faults.install(None)
    ref_faults.install(None)


@pytest.fixture(scope="module")
def nets():
    """The puct 9×9 policy in both packages, float32."""
    with jax.enable_checks(False):
        ref = RefNet.load_model(SPEC)
        ref.module = ref.module.clone(dtype=jnp.float32)
        ref._apply = jax.jit(ref.module.apply)
    port = NeuralNetBase.load_model(SPEC, device="cpu", dtype=torch.float32)
    return ref, port


class XlaRuntimeError(RuntimeError):
    """Stands in for jaxlib's error type: the reference's classifier
    reads the type's name and the status word in the message."""


PORT_ERRORS = {
    "transient": lambda: faults.InjectedFault("flake"),
    "error": lambda: RuntimeError("programming error"),
    "overload": lambda: EvaluatorOverload("queue full"),
    "oom": lambda: torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"),
    "sticky": lambda: torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"),
    "value": lambda: ValueError("bad argument"),
}
REF_ERRORS = {
    "transient": lambda: ref_faults.InjectedFault("flake"),
    "error": lambda: RuntimeError("programming error"),
    "overload": lambda: RefOverload("queue full"),
    "oom": lambda: XlaRuntimeError(
        "RESOURCE_EXHAUSTED: Out of memory allocating 2147483648 bytes"),
    "sticky": lambda: XlaRuntimeError(
        "FAILED_PRECONDITION: the device is in an unrecoverable state"),
    "value": lambda: ValueError("bad argument"),
}


class Scripted:
    """A primary whose calls follow ``script`` (then plain moves): an
    error name raises that package's error, ``illegal`` answers an
    occupied point, anything else plays the last sensible move (so the
    fallback rung's first sensible move differs)."""

    n_sim = 8

    def __init__(self, script, errors, policy):
        self.script = list(script)
        self.errors = errors
        self.policy = policy
        self.sim_limit = None
        self.limits_seen = []

    def get_move(self, state):
        self.limits_seen.append(self.sim_limit)
        what = self.script.pop(0) if self.script else "ok"
        if what in self.errors:
            raise self.errors[what]()
        if what == "illegal":
            return OPENING[0]
        moves = state.get_legal_moves(include_eyes=False)
        return moves[-1] if moves else None


def play(ladder, game_mod, moves: int):
    st = game_mod.GameState(size=9)
    for mv in OPENING:
        st.do_move(mv)
    out = []
    for _ in range(moves):
        mv = ladder.get_move(st)
        out.append((mv, ladder.last_rung))
        st.do_move(mv)
    return out


def stats_sans_latency(ladder):
    s = ladder.stats()
    s.pop("latency_s")
    return s


def run_both(nets, script, plan, moves, policy=True, **kw):
    ref_net, port_net = nets
    ref_p = Scripted(script, REF_ERRORS, ref_net if policy else None)
    port_p = Scripted(script, PORT_ERRORS, port_net if policy else None)
    ref_l, port_l = RefLadder(ref_p, **kw), ResilientPlayer(port_p, **kw)
    ref_faults.install(plan)
    with jax.enable_checks(False):
        want = play(ref_l, ref_pygo, moves)
    faults.install(plan)
    got = play(port_l, pygo, moves)
    # searches abandoned as hung run on to their end: wait for them
    for t in threading.enumerate():
        if t.name.startswith("genmove-"):
            t.join(timeout=60)
            assert not t.is_alive()
    assert got == want
    assert stats_sans_latency(port_l) == stats_sans_latency(ref_l)
    assert port_p.limits_seen == ref_p.limits_seen
    return port_l, got


SCRIPTS = {
    "errors": (["ok", "transient", "ok", "error", "oom", "ok", "overload",
                "overload", "sticky", "illegal", "value", "transient",
                "transient"], None),
    "search_barrier": ([], "io_error@serve.search:2"),
    "search_and_policy": ([], "error@serve.search:1,error@serve.policy:1"),
    "search_and_reduced": ([], "io_error@serve.search,io_error@serve.reduced"),
    "iteration": ([], "error@iter7.serve.search"),
    "every_rung": ([], "io_error@serve.search:2,io_error@serve.reduced,"
                       "kill@serve.policy,error@serve.fallback"),
    "random": (["error", "ok", "overload"],
               "io_error@random:p=0.3,seed=7"),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_rungs_moves_and_stats_are_the_references(nets, name):
    script, plan = SCRIPTS[name]
    ladder, moves = run_both(nets, script, plan, 8)
    assert ladder.genmoves == 8
    if name == "errors":
        rungs = [r for _, r in moves]
        assert set(rungs) == {"search", "reduced", "policy"}
        assert ladder.reasons["overload"] == 2
        assert ladder.reasons["illegal_from_player"] == 1
        assert ladder.reduced_sims == 2
    if name == "every_rung":
        assert moves[1][1] == "fallback"
        assert ladder.reasons["fallback_error"] == 1


def test_fallback_rung_is_the_references_first_sensible_move(nets):
    """No policy net and a primary that always fails: the fallback rung
    serves every move, the reference's first sensible move, off the
    host rules alone."""
    ladder, moves = run_both(nets, ["error"] * 12, None, 6, policy=False)
    assert [r for _, r in moves] == ["fallback"] * 6
    assert ladder.served["fallback"] == 6 and ladder.last_fallback == {
        "rung": "fallback", "reason": "error", "turn": 10}


def test_hang_is_abandoned_like_the_reference(nets):
    """A search that sleeps past ``hang_timeout_s`` is abandoned by the
    watchdog and the policy rung serves, in both packages."""
    ladder, moves = run_both(nets, [], "sleep@iter5.serve.search=4", 1,
                             hang_timeout_s=1.0)
    assert moves[0][1] == "policy" and ladder.reasons == {"hang": 1}


def test_engine_default_answers_a_legal_move_where_raw_errors(nets):
    """The port's engine wraps every player in the ladder: a player
    that raises still gets a legal vertex; ``resilient=False`` (the
    CLI's ``--no-resilient``) answers ``? error``, as the reference's
    raw engine does."""
    _, port_net = nets
    failing = Scripted(["error"] * 10, PORT_ERRORS, port_net)
    engine = gtp.GTPEngine(failing)
    reply, _ = engine.handle("genmove b")
    assert reply.startswith("= ") and gtp.vertex_to_move(reply[2:], 9)
    health = engine.handle("rocalphago-health")[0]
    assert '"status": "degraded"' in health
    raw = gtp.GTPEngine(Scripted(["error"], PORT_ERRORS, port_net),
                        resilient=False)
    assert raw.handle("genmove b")[0] == "? programming error\n\n"
    assert raw.handle("rocalphago-health")[0].startswith(
        "? resilient serving disabled")
    # a barrier fault on the engine's own path is counted, not echoed
    faults.install("io_error@genmove.post_search")
    reply, _ = engine.handle("genmove w")
    assert reply.startswith("= ")
    assert engine._serve.barrier_faults == 1


TRANSIENT_ROWS = [
    (OSError("disk"), True), (TimeoutError(), True),
    (ConnectionError(), True), (ValueError(), False), (KeyError(), False),
    (TypeError(), False), (AssertionError(), False),
    (RuntimeError("boom"), False), (EvaluatorOverload("full"), True),
    (faults.InjectedFault("x"), True), (faults.InjectedKill("x"), False),
]
CUDA_ROWS = [
    # the card's out-of-memory error: XLA's RESOURCE_EXHAUSTED
    (torch.cuda.OutOfMemoryError("CUDA out of memory."), True),
    # sticky errors poison the context: never retried
    (torch.AcceleratorError("CUDA error: an illegal memory access was "
                            "encountered"), False),
    (torch.AcceleratorError("CUDA error: device-side assert triggered"),
     False),
    (RuntimeError("CUDA error: unspecified launch failure"), False),
]


@pytest.mark.parametrize("exc,want", TRANSIENT_ROWS + CUDA_ROWS,
                         ids=lambda x: type(x).__name__
                         if isinstance(x, BaseException) else str(x))
def test_is_transient_table(exc, want):
    assert is_transient(exc) is want
    if (exc, want) in TRANSIENT_ROWS and not isinstance(
            exc, (faults.InjectedFault, faults.InjectedKill,
                  EvaluatorOverload)):
        assert ref_transient(exc) is want


PLANS = [
    "crash@iter3.post_save", "io_error@promote:2,sleep@pre_iteration=0.5",
    "kill@random:p=0.05,seed=7", "kill@actor.game:p=0.2,kill@learner.step:3",
    "error@serve.search", "io_error@serve.eval:5,sleep@iter2.serve.search=1.5",
    "", " , ", "io_error@random:p=0.3:seed=11",
]
BAD_PLANS = ["nope", "boom@serve.search", "sleep@serve.search",
             "kill@random", "kill@x:p=1.5", "io_error@"]


@pytest.mark.parametrize("plan", PLANS)
def test_parse_plan_agrees(plan):
    fields = ("kind", "barrier", "iteration", "hit", "arg", "text", "p",
              "seed")
    got = [tuple(getattr(s, f) for f in fields)
           for s in faults.parse_plan(plan)]
    want = [tuple(getattr(s, f) for f in fields)
            for s in ref_faults.parse_plan(plan)]
    assert got == want


@pytest.mark.parametrize("plan", BAD_PLANS)
def test_parse_plan_refuses_what_the_reference_refuses(plan):
    with pytest.raises(ValueError):
        ref_faults.parse_plan(plan)
    with pytest.raises(ValueError):
        faults.parse_plan(plan)


def test_barrier_schedules_are_the_references():
    """The same plan over the same barrier hits fires on the same hits
    (the probabilistic draws are hashed, not random)."""
    plan = ("io_error@random:p=0.2,seed=3,error@iter4.serve.search,"
            "kill@serve.policy:3")
    names = ["serve.search", "serve.policy", "serve.eval", "serve.reduced"]

    def schedule(mod):
        mod.install(plan)
        fired = []
        for i in range(40):
            try:
                mod.barrier(names[i % 4], iteration=i // 2)
            except Exception as e:  # noqa: BLE001 -- recorded
                fired.append((i, type(e).__name__))
        return fired

    got, want = schedule(faults), schedule(ref_faults)
    assert got == want and len(got) > 3
    faults.install(None)
    faults.barrier("serve.search")          # no plan: nothing fires


def test_deadline_remaining_and_repr():
    assert Deadline(None).remaining() is None
    assert repr(Deadline.after(None)) == "Deadline(unlimited)"
    d = Deadline.after(3600.0)
    assert 3500.0 < d.remaining() <= 3600.0
    assert repr(d).startswith("Deadline(in +")
    assert Deadline.after(-1.0).remaining() == 0.0
    assert percentile([], 0.5) is None
    assert percentile([1, 2, 3, 4], 0.5) == 3
    assert RUNGS == ("search", "reduced", "policy", "fallback")
