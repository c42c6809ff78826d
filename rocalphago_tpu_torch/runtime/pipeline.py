"""Pipelined chunk dispatch: one chunk of simulations in flight while
the host decides whether to send the next.

The port of the reference's ``runtime/pipeline.py`` at its default
depth of 1, on CUDA events. PyTorch queues a chunk's kernels and
returns; :meth:`ChunkPipeline.push` records an event after the chunk
and then waits on the previous chunk's event, so the host stays at
most one chunk ahead of the card. Between chunks the caller checks its
deadline; on expiry at most one chunk is still in flight, and its
simulations count. On the CPU every operation has finished when it
returns, so the pipeline has nothing to wait for.
"""

from __future__ import annotations

import torch


class ChunkPipeline:
    """At most one dispatched, unfinished chunk on ``device``'s current
    stream."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._prev: torch.cuda.Event | None = None

    def push(self) -> None:
        """Mark the end of a dispatched chunk; wait until the chunk
        before it has finished."""
        if self.device.type != "cuda":
            return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        if self._prev is not None:
            self._prev.synchronize()
        self._prev = event

    def drain(self) -> None:
        """Wait for the chunk in flight."""
        if self._prev is not None:
            self._prev.synchronize()
            self._prev = None
