"""GTP move clock: a per-move seconds budget → a simulation budget.

A copy of the reference's ``search/clock.py`` (standard library only),
kept in the port so that the port imports nothing of the JAX package.
The device player converts the per-move budget the GTP engine hands it
(``set_move_time``) into simulations through a measured rate.

Rate hygiene: a sample is folded in only when its ``key`` (the
granularity at which the caller builds its programs -- here one
searcher per komi) has run before. A key's first run pays the kernel
build and cuDNN's choice of convolution algorithms; folding its wall
time in would collapse the next budgets far below what the clock
affords. The rate is the median of the last ``WINDOW`` samples, so one
outlier (a pause, a busy host) does not move the next move's budget.

The clock is the planner only; the enforcer is
:class:`~rocalphago_tpu_torch.runtime.deadline.Deadline`, checked
between chunks of simulations.
"""

from __future__ import annotations

import statistics
from collections import deque


class MoveClock:
    """Per-move wall budget and a warmed-keyed units/sec estimate."""

    WINDOW = 5      # samples kept; the median of these is the rate

    def __init__(self) -> None:
        self.move_time: float | None = None   # seconds; None = off
        self.rate: float | None = None        # units/sec estimate
        self._warmed: set = set()
        self._samples: deque = deque(maxlen=self.WINDOW)

    def set_move_time(self, seconds) -> None:
        """Per-move wall budget in seconds (None = no clock)."""
        self.move_time = (None if seconds is None
                          else max(float(seconds), 0.0))

    def allowed_units(self) -> int | None:
        """Units the budget affords, or None (no clock, or no estimate
        yet: callers run their full budget, which seeds the estimate)."""
        if self.move_time is None or self.rate is None:
            return None
        return int(self.move_time * self.rate)

    def note(self, key, units: int, wall: float) -> None:
        """Record a finished search: ``units`` ran in ``wall`` seconds
        under ``key``. A key's first run only warms it."""
        if key not in self._warmed:
            self._warmed.add(key)
            return
        if wall <= 0:
            return
        self._samples.append(units / wall)
        self.rate = statistics.median(self._samples)
