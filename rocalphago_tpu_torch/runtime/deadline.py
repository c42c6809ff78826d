"""Hard wall-clock deadlines for the serving path.

A copy of the reference's ``runtime/deadline.py`` (standard library
only). :class:`~rocalphago_tpu_torch.search.clock.MoveClock` predicts
how many simulations fit a move's budget; :class:`Deadline` enforces
it: an absolute ``time.monotonic`` timestamp that the chunked search
checks between chunks. On expiry the search stops where it is and the
caller serves the anytime answer (argmax of the visits so far). The
floor is one chunk: the first chunk always runs.
"""

from __future__ import annotations

import time


class Deadline:
    """Absolute wall-clock cutoff (``time.monotonic`` domain);
    ``Deadline(None)`` is unlimited: never expired, and ``remaining()``
    is None."""

    __slots__ = ("at",)

    def __init__(self, at: float | None):
        self.at = at                  # monotonic timestamp, or None

    @classmethod
    def after(cls, seconds: float | None) -> "Deadline":
        """Deadline ``seconds`` from now (None = unlimited; a negative
        budget is an already-expired deadline)."""
        if seconds is None:
            return cls(None)
        return cls(time.monotonic() + max(float(seconds), 0.0))

    @property
    def unlimited(self) -> bool:
        return self.at is None

    def expired(self) -> bool:
        return self.at is not None and time.monotonic() >= self.at

    def remaining(self) -> float | None:
        """Seconds left (clamped at 0.0), or None when unlimited."""
        if self.at is None:
            return None
        return max(0.0, self.at - time.monotonic())

    def __repr__(self) -> str:
        if self.at is None:
            return "Deadline(unlimited)"
        return f"Deadline(in {self.at - time.monotonic():+.3f}s)"
