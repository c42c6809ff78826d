"""Pipelined chunk dispatch: one chunk in flight while the host decides
whether to send the next.

The port of the reference's ``runtime/pipeline.py`` at its default
depth of 1, on CUDA events. PyTorch queues a chunk's kernels and
returns; :meth:`ChunkPipeline.push` records an event after the chunk
and then waits on the chunk before it, so the host stays at most one
chunk ahead of the card and learns about a chunk one chunk late:

* the device search checks its deadline between chunks; on expiry at
  most one chunk is still in flight, and its simulations count;
* self-play's done-poll reads the done flag of a *retired* chunk. A
  flag pushed as a ``handle`` is copied to pinned host memory behind
  its chunk, so once the chunk's event has completed the host reads it
  without waiting for anything dispatched since (reading the flag on
  the card would wait for the whole stream).

``host_gap_frac`` is the reference's measure of the idle the host
causes between chunks: the host time during which no pushed chunk was
in flight, over the pipeline's active wall time. At depth 1 every push
leaves the chunk just pushed in flight, so the window only empties at
:meth:`drain`, and the fraction is 0 unless a caller retires chunks
between pushes some other way. It does not see a card starved *inside*
a chunk by a slow host; the profiler's idle share does.

On the CPU every operation has finished when it returns: nothing is
waited for and handles are read as they are, but the retire order is
the same, so the host sees each chunk one chunk late there too.

A pipeline built with a ``runner`` name records the reference's
metrics in the registry (:mod:`..obs.registry`):
``dispatch_gap_s{runner=}`` (each gap), ``dispatch_chunks_total
{runner=}`` (each push) and ``device_occupancy{runner=}`` (1 −
``host_gap_frac``, set when a window closes). None of them reads the
card.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from rocalphago_tpu_torch.obs import registry as obs_registry

DEPTH = 1


class ChunkPipeline:
    """At most ``DEPTH`` dispatched, unretired chunks on ``device``'s
    current stream.

    ``push(handle, payload)`` registers a dispatched chunk and retires
    the chunks beyond the window, returning their ``(payload, handle)``
    pairs, oldest first; a retired handle is on the host (or the CPU)
    and ready. ``drain()`` retires every chunk and closes the window;
    ``finish()`` closes the window without waiting (a later read of the
    results waits for the tail). ``chunks`` and ``gaps`` count pushes
    and gaps; the stats survive ``finish`` (a later push opens a new
    window) until :meth:`reset_stats`."""

    def __init__(self, device, runner: str = "", registry=None):
        self.device = torch.device(device)
        self.runner = runner
        self._inflight: deque = deque()
        self._window_start = None
        self._gap_started = None
        self.chunks = 0
        self.gaps = 0
        self.gap_s = 0.0
        self.wall_s = 0.0            # closed windows only
        self._gap_h = self._occ_g = self._chunks_c = None
        if runner:
            reg = registry or obs_registry.REGISTRY
            self._gap_h = reg.histogram("dispatch_gap_s", runner=runner)
            self._occ_g = reg.gauge("device_occupancy", runner=runner)
            self._chunks_c = reg.counter("dispatch_chunks_total",
                                         runner=runner)

    def push(self, handle=None, payload=None) -> list:
        """Register a dispatched chunk (``handle``, a small tensor the
        caller wants to read later, may be None); wait until at most
        ``DEPTH`` chunks are in flight; return the retired pairs."""
        now = time.monotonic()
        if self._window_start is None:
            self._window_start = now
        if self._gap_started is not None:
            gap = now - self._gap_started
            self._gap_started = None
            self.gaps += 1
            self.gap_s += gap
            if self._gap_h is not None:
                self._gap_h.observe(gap)
        event = None
        if self.device.type == "cuda":
            if handle is not None:
                host = torch.empty(handle.shape, dtype=handle.dtype,
                                   pin_memory=True)
                host.copy_(handle, non_blocking=True)
                handle = host
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._inflight.append((payload, handle, event))
        self.chunks += 1
        if self._chunks_c is not None:
            self._chunks_c.inc()
        retired = []
        while len(self._inflight) > DEPTH:
            retired.append(self._retire())
        return retired

    def _retire(self):
        payload, handle, event = self._inflight.popleft()
        if event is not None:
            event.synchronize()
        if not self._inflight:
            self._gap_started = time.monotonic()
        return payload, handle

    def pending(self) -> int:
        """Chunks dispatched and not yet retired."""
        return len(self._inflight)

    def drain(self) -> list:
        """Retire every chunk in flight (waiting for them), then close
        the window; returns the retired pairs."""
        retired = []
        while self._inflight:
            retired.append(self._retire())
        self.finish()
        return retired

    def finish(self) -> None:
        """Close the accounting window without waiting, and set the
        occupancy gauge. Idempotent."""
        if self._window_start is None:
            return
        end = (self._gap_started if self._gap_started is not None
               and not self._inflight else time.monotonic())
        self.wall_s += max(end - self._window_start, 0.0)
        self._window_start = None
        self._gap_started = None
        if self._occ_g is not None:
            self._occ_g.set(self.occupancy)

    @property
    def host_gap_frac(self) -> float:
        """Gap time over active wall time (closed windows, and the open
        one up to now)."""
        wall = self.wall_s
        if self._window_start is not None:
            wall += time.monotonic() - self._window_start
        if wall <= 0.0:
            return 0.0
        return min(1.0, self.gap_s / wall)

    @property
    def occupancy(self) -> float:
        """1 − :attr:`host_gap_frac`: the share of the active wall time
        with a chunk in flight (the gauge's value)."""
        return 1.0 - self.host_gap_frac

    def reset_stats(self) -> None:
        """Zero the counts and the accounting (the metric handles stay);
        refused while chunks are in flight."""
        if self._inflight:
            raise RuntimeError(
                "reset_stats with chunks still in flight: drain() first")
        self.chunks = self.gaps = 0
        self.gap_s = self.wall_s = 0.0
        self._window_start = self._gap_started = None

    def __repr__(self) -> str:
        return (f"ChunkPipeline(depth={DEPTH}, runner={self.runner!r}, "
                f"chunks={self.chunks}, inflight={len(self._inflight)}, "
                f"gap_frac={self.host_gap_frac:.4f})")
