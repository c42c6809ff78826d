"""Deterministic fault injection at named barriers.

A copy of the reference package's ``runtime/faults.py`` (standard
library only), without its environment read: a plan is installed only
by :func:`install` (the chaos tests and ``chip_smoke.py`` do), and
``install(None)`` clears it. Serving code calls :func:`barrier` at
named points; with no plan installed a barrier is a ``None`` check and
a return, so production paths pay nothing.

Plan grammar::

    plan   := spec ("," spec)*
    spec   := kind "@" ["iter" N "."] barrier [":" hit]
              [":p=" P] [":seed=" S] ["=" arg]
    kind   := "crash" | "io_error" | "error" | "sleep" | "kill"

* ``crash`` -- flush stdio and ``os._exit(FAULT_EXIT_CODE)`` (a hard
  kill: no atexit hooks, no finally blocks);
* ``io_error`` -- raise :class:`InjectedFault` (an ``OSError``, so
  transient to :func:`~.retries.is_transient`);
* ``error`` -- raise ``RuntimeError`` (not transient);
* ``sleep`` -- block ``arg`` seconds (trips a watchdog);
* ``kill`` -- raise :class:`InjectedKill` (a ``RuntimeError``: not
  transient, so it rides through the retry layer and takes a
  supervised worker thread down).

``iterN.`` restricts a spec to barrier hits whose ``iteration``
argument is N; ``:hit`` fires on the k-th matching hit (default the
first), and a deterministic spec fires at most once. A spec's barrier
matches the full dotted name or any dot-suffix (``io_error@search``
hits ``serve.search``); ``random`` matches every barrier and needs a
probability. ``:p=P`` makes a spec fire with probability P per hit from
its ``hit``-th hit on, repeatedly; the draw is hashed from the seed
(``:seed=S``, default 0), the barrier name and the hit count, so a plan
replays the same schedule every run. The comma form
``kill@random:p=0.05,seed=7`` re-attaches ``p=``/``seed=`` fragments to
the spec before them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import sys
import time

FAULT_EXIT_CODE = 173          # distinct from shell and signal codes
_KINDS = ("crash", "io_error", "error", "sleep", "kill")


class InjectedFault(OSError):
    """The raisable injected fault (an OSError: transient)."""


class InjectedKill(RuntimeError):
    """The injected worker kill (not transient: it passes through the
    retry layer and ends the worker thread)."""


@dataclasses.dataclass
class _Spec:
    kind: str
    barrier: str
    iteration: int | None
    hit: int
    arg: float | None
    text: str                  # the spec as written, for log lines
    p: float | None = None     # probabilistic: the chance per hit
    seed: int = 0
    count: int = 0
    fired: bool = False

    def matches(self, name: str, iteration) -> bool:
        if self.iteration is not None and iteration != self.iteration:
            return False
        return (self.barrier == "random"
                or name == self.barrier
                or name.endswith("." + self.barrier))

    def draw(self, name: str) -> bool:
        """The Bernoulli draw of a ``p`` spec, hashed from (seed,
        barrier name, hit count)."""
        digest = hashlib.sha256(
            f"{self.seed}:{name}:{self.count}".encode()).digest()
        frac = int.from_bytes(digest[:8], "big") / float(1 << 64)
        return frac < (self.p or 0.0)


_SPEC_RE = re.compile(
    r"^(?P<kind>[a-z_]+)@(?P<barrier>[A-Za-z0-9_.]+)"
    r"(?::(?P<hit>\d+))?(?::p=(?P<p>[0-9.]+))?"
    r"(?::seed=(?P<seed>\d+))?(?:=(?P<arg>[0-9.]+))?$")

# a fragment with no "@" that re-attaches to the spec before it
_PARAM_RE = re.compile(r"^(p|seed)=[0-9.]+$")

_plan: list[_Spec] = []


def parse_plan(text: str) -> list[_Spec]:
    raws: list[str] = []
    for frag in text.split(","):
        frag = frag.strip()
        if not frag:
            continue
        if raws and "@" not in frag and _PARAM_RE.match(frag):
            raws[-1] += ":" + frag
        else:
            raws.append(frag)
    specs = []
    for raw in raws:
        m = _SPEC_RE.match(raw)
        if m is None:
            raise ValueError(
                f"bad fault spec {raw!r}: expected "
                "kind@[iterN.]barrier[:hit][=arg] "
                f"(kinds: {', '.join(_KINDS)})")
        kind = m.group("kind")
        if kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in {raw!r} "
                f"(kinds: {', '.join(_KINDS)})")
        barrier_part = m.group("barrier")
        iteration = None
        first, _, rest = barrier_part.partition(".")
        it_m = re.fullmatch(r"iter(\d+)", first)
        if it_m and rest:
            iteration = int(it_m.group(1))
            barrier_part = rest
        if kind == "sleep" and m.group("arg") is None:
            raise ValueError(
                f"sleep spec {raw!r} needs a duration: sleep@name=0.5")
        p = float(m.group("p")) if m.group("p") else None
        if p is not None and not 0.0 <= p <= 1.0:
            raise ValueError(
                f"fault spec {raw!r}: p must be in [0, 1], got {p}")
        if barrier_part == "random" and p is None:
            raise ValueError(
                f"fault spec {raw!r}: the 'random' wildcard barrier "
                "needs a probability (e.g. kill@random:p=0.05) -- "
                "without one it would fire on the very first barrier "
                "of the run")
        specs.append(_Spec(
            kind=kind, barrier=barrier_part, iteration=iteration,
            hit=int(m.group("hit") or 1),
            arg=float(m.group("arg")) if m.group("arg") else None,
            p=p, seed=int(m.group("seed") or 0), text=raw))
    return specs


def install(plan: str | None) -> None:
    """Set the active plan; ``None`` or ``""`` clears it."""
    global _plan
    _plan = parse_plan(plan or "")


def _fire(spec: _Spec, name: str) -> None:
    # probabilistic specs never retire: each later hit draws again
    spec.fired = spec.p is None
    if spec.kind == "kill":
        raise InjectedKill(f"injected kill at {name} (spec {spec.text})")
    if spec.kind == "crash":
        print(f"faults: injected crash at {name} (spec {spec.text})",
              file=sys.stderr)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(FAULT_EXIT_CODE)
    if spec.kind == "io_error":
        raise InjectedFault(
            f"injected io_error at {name} (spec {spec.text})")
    if spec.kind == "error":
        raise RuntimeError(f"injected error at {name} (spec {spec.text})")
    if spec.kind == "sleep":
        time.sleep(spec.arg or 0.0)


def barrier(name: str, iteration: int | None = None) -> None:
    """Declare a fault barrier. No-op unless the plan names it."""
    plan = _plan
    if not plan:
        return
    for spec in plan:
        if spec.fired or not spec.matches(name, iteration):
            continue
        spec.count += 1
        if spec.count < spec.hit:
            continue
        if spec.p is not None and not spec.draw(name):
            continue
        _fire(spec, name)
