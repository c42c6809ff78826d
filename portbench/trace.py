"""The traced window and its reduction: device busy time as a union of
intervals, kernel counts, the device operations that took the most time
and the idle gaps by what the host was doing.

The traced run (``--trace 1``) measures the same window as any run and
then, once it has closed, runs more units of the same traffic with
``torch.profiler`` on for three phases of ``trace_units`` whole units
(steps, plies or simulations) after ``trace_skip`` of them
(:class:`Tracer`): the driver calls :meth:`Tracer.unit` at every unit
boundary, and the card is synchronised at both ends of each phase. The
card-only phase's window is read on the host's clock
(``time.time_ns``), the profiler's own time base. Host spans are the
harness's own ``record_function`` ranges named ``portbench.*`` around
its calls into the program; the program gets none.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

import torch

#: device activity that is not a kernel launch
NON_KERNEL_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")

#: the span that bounds the traced window
WINDOW_SPAN = "portbench.traced"


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to
    ``[lo, hi]``: time covered by at least one, overlaps counted once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The ``(start, end)`` stretches of ``[lo, hi]`` that no interval
    covers."""
    gaps, at = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


@dataclasses.dataclass
class TraceSummary:
    """The traced window, in seconds: its length, the device's busy
    time (union of every device operation), the number of kernels
    launched in it, the time by device operation and the idle time by
    host activity."""

    window_s: float
    busy_s: float
    kernels: int
    units: int
    device_ops: list
    gaps: list

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops[:10],
                "idle_gaps": self.gaps[:10]}


def summarize(device_events, window, units: int) -> TraceSummary:
    """The card's part of a traced window: ``device_events`` are
    ``(start, end, name)`` in nanoseconds, ``window`` its ``(start,
    end)``."""
    lo, hi = window
    dev = [(s, e, n) for s, e, n in device_events if e > lo and s < hi]
    busy = union_length([(s, e) for s, e, _ in dev], lo, hi)
    kernels = sum(1 for s, _, n in dev
                  if lo <= s < hi and not n.startswith(NON_KERNEL_PREFIXES))
    by_op: dict[str, float] = {}
    for s, e, n in dev:
        key = n[:160]
        by_op[key] = by_op.get(key, 0.0) + (min(e, hi) - max(s, lo)) * 1e-9
    return TraceSummary(
        window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9, kernels=kernels,
        units=units,
        device_ops=sorted(([k, v] for k, v in by_op.items()),
                          key=lambda kv: -kv[1]),
        gaps=[])


def host_gaps(device_events, host_spans, host_ops, window) -> list:
    """``[name, seconds]`` of the card's idle time by what the host was
    doing, most first: each gap named by the innermost ``portbench.*``
    span and the outermost host operation at its middle."""
    lo, hi = window
    ivals = [(s, e) for s, e, _ in device_events if e > lo and s < hi]
    spans = sorted(host_spans)
    starts = [sp[0] for sp in spans]
    tops = _top_level(host_ops)
    top_starts = [op[0] for op in tops]
    by_gap: dict[str, float] = {}
    for gs, ge in idle_gaps(ivals, lo, hi):
        mid = 0.5 * (gs + ge)
        span = _innermost(spans, starts, mid) or "harness"
        i = bisect.bisect_right(top_starts, mid) - 1
        op = tops[i][2] if i >= 0 and tops[i][1] >= mid else "python"
        key = f"{span} / {op}"
        by_gap[key] = by_gap.get(key, 0.0) + (ge - gs) * 1e-9
    return sorted(([k, v] for k, v in by_gap.items()), key=lambda kv: -kv[1])


def _innermost(spans, starts, t: float):
    """The latest-starting span that holds ``t`` (spans nest), not the
    window's own."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        s, e, n = spans[i]
        if e >= t and n != WINDOW_SPAN:
            return n
        i -= 1
    return None


def _top_level(ops):
    """The outermost of nested host operations, disjoint and sorted."""
    out = []
    for s, e, n in sorted(ops, key=lambda op: (op[0], -op[1])):
        if out and s < out[-1][1]:
            continue
        out.append((s, e, n))
    return out


class Tracer:
    """The traced units of a ``--trace 1`` run, after the window: after
    ``skip`` units, three phases of ``units`` units each. The first
    records the card's activity alone and is thrown away (the profiler
    meets each kernel for the first time there); the second records the
    card's activity alone (no host operation is recorded, so the host
    runs nearest its own pace) and gives the busy time, the kernels and
    the device operations; the third records host and card together
    for the idle gaps by what the host was doing (its host is slowed by
    the recording, so it names the gaps and the second phase sizes
    them)."""

    def __init__(self, enabled: bool, device: torch.device, skip: int,
                 units: int):
        self.enabled = enabled
        self.device = device
        self.skip = skip
        self.units = units
        self.count = 0
        self.armed = False
        self.phase = 0    # 0 before, 1 warm, 2 card only, 3 host too, 4 done
        self._profs = {}
        self._window = {}
        self._range = None

    @property
    def tracing(self) -> bool:
        """Whether traced units are still to run."""
        return self.enabled and self.phase < 4

    def span(self, name: str):
        """A ``record_function`` range while host activity is recorded;
        nothing otherwise."""
        if self.phase == 3:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _activities(self, phase: int):
        acts = []
        if phase == 3 or self.device.type != "cuda":
            acts.append(torch.profiler.ProfilerActivity.CPU)
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def arm(self) -> None:
        """Count units from here on (after the measured window). The
        profiler's first start on the card takes seconds (CUPTI sets
        itself up), so a throwaway session takes that cost here and
        the traced units start on time."""
        if self.enabled and self.device.type == "cuda":
            warm = torch.profiler.profile(activities=self._activities(3))
            warm.start()
            torch.ones(1, device=self.device).add_(1)
            self._sync()
            warm.stop()
        self.armed = True

    def unit(self) -> None:
        """A unit boundary: count it, and move to the next phase when
        due (``skip >= 1``)."""
        if not self.armed or not self.enabled or self.phase == 4:
            return
        self.count += 1
        if self.phase == 0 and self.count == self.skip:
            self._start(1)
        elif 1 <= self.phase <= 3 and \
                self.count == self.skip + self.phase * self.units:
            self._stop(self.phase)
            if self.phase < 3:
                self._start(self.phase + 1)
            else:
                self.phase = 4

    def _start(self, phase: int) -> None:
        self._sync()
        prof = torch.profiler.profile(activities=self._activities(phase))
        prof.start()
        self._profs[phase] = prof
        self.phase = phase
        if phase == 3:
            self._range = torch.profiler.record_function(WINDOW_SPAN)
            self._range.__enter__()
        self._window[phase] = [time.time_ns(), None, self.count]

    def _stop(self, phase: int) -> None:
        self._sync()
        self._window[phase][1] = time.time_ns()
        self._window[phase][2] = self.count - self._window[phase][2]
        if phase == 3:
            self._range.__exit__(None, None, None)
        self._profs[phase].stop()

    def finish(self) -> None:
        """Stop a phase the traffic's end cut short."""
        if self.phase in (1, 2, 3):
            self._stop(self.phase)
            self.phase = 4

    @staticmethod
    def _events(prof):
        cuda = torch.autograd.DeviceType.CUDA
        device, spans, ops, window, main = [], [], [], None, None
        for ev in prof.profiler.kineto_results.events():
            s, e, name = ev.start_ns(), ev.end_ns(), ev.name()
            on_device = ev.device_type() == cuda
            if name.startswith("portbench."):
                # the harness's ranges; the profiler mirrors them on the
                # device's timeline, where they are no device work
                if not on_device:
                    spans.append((s, e, name))
                    if name == WINDOW_SPAN:
                        window, main = (s, e), ev.start_thread_id()
            elif on_device:
                device.append((s, e, name))
            else:
                ops.append((s, e, name, ev.start_thread_id()))
        ops = [(s, e, n) for s, e, n, tid in ops if tid == main]
        return device, spans, ops, window

    def summary(self) -> TraceSummary | None:
        """The traced units reduced, or None when none was traced."""
        if 2 not in self._profs or self._window[2][1] is None:
            return None
        lo, hi, units = self._window[2]
        device, _, _, _ = self._events(self._profs[2])
        out = summarize(device, (lo, hi), units)
        if 3 in self._profs and self._window[3][1] is not None:
            device, spans, ops, window = self._events(self._profs[3])
            if window is not None:
                out.gaps = host_gaps(device, spans, ops, window)
        return out


def idle_percent(summary: TraceSummary | None):
    """The device's idle share of a traced window in percent, or None
    where no device operation was traced."""
    if summary is None or summary.busy_s <= 0 or summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
