"""Kernel-launch tracking of named entry points, and the opt-in
``torch.profiler`` capture.

The port of ``obs/jaxobs.py``. The reference wraps its jitted entry
points to record each compile; the port compiles nothing at run time,
so its wrapper records what a call cost the card instead: the launches
of each hand-written kernel made inside the call.

LAUNCH TRACKING -- :func:`track` wraps a callable (``track("name",
fn)``, or ``@track("name")`` on a function or a method). Every call
adds, per kernel (``labels``, ``chase``, ``tree``), the launches made
inside it on the calling thread to the counter
``kernel_launches_total{entry=..., kernel=...}`` of the default
registry (all three series, at 0 where it launched nothing). A launch belongs to the innermost tracked call
open on its thread, so the entries' series never count one launch
twice, and launches made where no tracked call is open land in the
entry ``untracked`` when :func:`flush_untracked` runs (the CLIs call it
before they write the registry): then the series of a kernel sum to its
process total (``ops.<kernel>.launches``). The counts are per thread
(``ops._build.THREAD``), so the fleet's, the gang's and the serve
pool's threads each count only their own launches. A call costs the
three integer reads before and after; it reads no clock, takes no lock
and never syncs with the card.

The wrapper delegates every other attribute to the wrapped callable.
Unlike the reference's, it keeps no per-call timing (no ``calls``,
``first_call_s``, ``steady_ema_s`` or ``stats()``: nothing read them).
The reference's compile series (``jax_compiles_total``,
``jax_compile_seconds``) and its ``compile`` event have no
counterpart: nothing compiles.

PROFILER CAPTURE -- :func:`maybe_start_profiler` starts a
``torch.profiler`` capture (host operations, and the card's kernels
when the device is CUDA) when given a directory (the zero CLI's
``--profile-dir``) and is a no-op otherwise; :func:`stop_profiler`
writes the Chrome trace into that directory, is idempotent and also
runs at exit, so a crashed run still writes its trace. Both emit the
reference's ``profiler`` events. There is no environment knob.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import sys
import threading
import types

from rocalphago_tpu_torch.obs import registry as _registry
from rocalphago_tpu_torch.obs import trace as _trace
from rocalphago_tpu_torch.ops import _build

#: the tracked kernels, in the order of the per-thread counts
KERNELS = _build.SOURCES
#: the entry label of launches made where no tracked call is open
UNTRACKED = "untracked"


class TrackedFunction:
    """Callable wrapper; see module docstring. Attribute: ``entry``
    (name); everything else delegates to the wrapped callable. As a
    class attribute it binds like a method."""

    def __init__(self, entry: str, fn, registry=None):
        self._fn = fn
        self.entry = entry
        #: where the series go (None: the process default at each call)
        self.registry = registry

    def __call__(self, *args, **kwargs):
        thread = _build.THREAD
        before = list(thread.counts)
        thread.frames.append([0] * len(KERNELS))
        try:
            return self._fn(*args, **kwargs)
        finally:
            self._count(thread, before, thread.frames.pop())

    def _count(self, thread, before: list, nested: list) -> None:
        """Record this call's own launches (those of nested tracked
        calls are theirs) and hand the whole delta to the enclosing
        tracked call, if any."""
        reg = self.registry or _registry.REGISTRY
        outer = thread.frames[-1] if thread.frames else None
        for i, kernel in enumerate(KERNELS):
            delta = thread.counts[i] - before[i]
            if outer is not None:
                outer[i] += delta
            reg.counter("kernel_launches_total", entry=self.entry,
                        kernel=kernel).inc(delta - nested[i])

    def __get__(self, obj, objtype=None):
        return self if obj is None else types.MethodType(self, obj)

    def __getattr__(self, item):
        # only reached for names NOT on the wrapper; '_fn' itself is
        # refused, so an instance made without __init__ (a copy)
        # cannot recurse
        if item == "_fn":
            raise AttributeError(item)
        return getattr(self._fn, item)

    def __repr__(self) -> str:
        return f"TrackedFunction({self.entry!r})"


def track(entry: str, fn=None, registry=None):
    """Wrap a callable with launch tracking -- ``track("name", fn)`` or
    as a decorator ``@track("name")``."""
    if fn is None:
        return lambda f: TrackedFunction(entry, f, registry)
    return TrackedFunction(entry, fn, registry)


def flush_untracked(registry=None) -> None:
    """Bring the ``untracked`` series of each kernel up to the launches
    this process made where no tracked call was open."""
    reg = registry or _registry.REGISTRY
    for i, kernel in enumerate(KERNELS):
        c = reg.counter("kernel_launches_total", entry=UNTRACKED,
                        kernel=kernel)
        if _build.UNTRACKED[i] > c.value:
            c.inc(_build.UNTRACKED[i] - c.value)


def process_launches() -> dict:
    """``{kernel: launches}``, the process totals of the wrappers."""
    from rocalphago_tpu_torch.ops import chase, labels, tree

    return {"labels": labels.launches, "chase": chase.launches,
            "tree": tree.launches}


def registry_launches(registry=None) -> dict:
    """``{kernel: launches}`` summed over every entry's series."""
    snap = (registry or _registry.REGISTRY).snapshot()["counters"]
    out = dict.fromkeys(KERNELS, 0)
    for kernel in KERNELS:
        tail = f'kernel="{kernel}"}}'
        out[kernel] = sum(v for k, v in snap.items()
                          if k.startswith("kernel_launches_total{")
                          and k.endswith(tail))
    return out


# ------------------------------------------------ profiler capture

_lock = threading.Lock()
_profiling = {"dir": None, "prof": None, "name": None}  # guarded-by: _lock


def maybe_start_profiler(out_dir: str | None = None, device=None,
                         name: str = "trace.json") -> bool:
    """Start a ``torch.profiler`` capture whose Chrome trace
    :func:`stop_profiler` writes to ``out_dir/name`` (the card's kernels
    too when ``device`` is CUDA); returns whether a capture started.
    Safe to call unconditionally: no directory, or a capture already
    running, is a no-op."""
    if not out_dir:
        return False
    from torch.profiler import ProfilerActivity, profile

    with _lock:
        if _profiling["dir"] is not None:
            return False
        activities = [ProfilerActivity.CPU]
        if device is not None and str(device).startswith("cuda"):
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(out_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.start()
        _profiling.update(dir=out_dir, prof=prof, name=name)
    atexit.register(stop_profiler)
    _trace.emit("profiler", action="start", out_dir=out_dir)
    print(f"torchobs: profiler capture -> {out_dir}", file=sys.stderr)
    return True


def stop_profiler() -> str | None:
    """Stop an active capture and write its Chrome trace; returns the
    trace's path (None when no capture runs). Idempotent; also runs at
    exit."""
    with _lock:
        out, prof, name = (_profiling["dir"], _profiling["prof"],
                           _profiling["name"])
        if out is None:
            return None
        _profiling.update(dir=None, prof=None, name=None)
    prof.stop()
    path = os.path.join(out, name)
    prof.export_chrome_trace(path)
    _trace.emit("profiler", action="stop", out_dir=out)
    return path


@contextlib.contextmanager
def profiler_session(out_dir: str | None = None, device=None,
                     name: str = "trace.json"):
    """Context-manager form of the start/stop pair."""
    started = maybe_start_profiler(out_dir, device, name)
    try:
        yield started
    finally:
        if started:
            stop_profiler()
