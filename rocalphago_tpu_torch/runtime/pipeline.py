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
"""

from __future__ import annotations

import time
from collections import deque

import torch

DEPTH = 1


class ChunkPipeline:
    """At most ``DEPTH`` dispatched, unretired chunks on ``device``'s
    current stream.

    ``push(handle, payload)`` registers a dispatched chunk and retires
    the chunks beyond the window, returning their ``(payload, handle)``
    pairs, oldest first; a retired handle is on the host (or the CPU)
    and ready. ``drain()`` retires every chunk and closes the window;
    ``finish()`` closes the window without waiting (a later read of the
    results waits for the tail)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._inflight: deque = deque()
        self._window_start = None
        self._gap_started = None
        self.gap_s = 0.0
        self.wall_s = 0.0            # closed windows only

    def push(self, handle=None, payload=None) -> list:
        """Register a dispatched chunk (``handle``, a small tensor the
        caller wants to read later, may be None); wait until at most
        ``DEPTH`` chunks are in flight; return the retired pairs."""
        now = time.monotonic()
        if self._window_start is None:
            self._window_start = now
        if self._gap_started is not None:
            self.gap_s += now - self._gap_started
            self._gap_started = None
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

    def drain(self) -> list:
        """Retire every chunk in flight (waiting for them), then close
        the window; returns the retired pairs."""
        retired = []
        while self._inflight:
            retired.append(self._retire())
        self.finish()
        return retired

    def finish(self) -> None:
        """Close the accounting window without waiting. Idempotent."""
        if self._window_start is None:
            return
        end = (self._gap_started if self._gap_started is not None
               and not self._inflight else time.monotonic())
        self.wall_s += max(end - self._window_start, 0.0)
        self._window_start = None
        self._gap_started = None

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
