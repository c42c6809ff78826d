"""The input pipeline's counters (``data/pipeline.py::device_prefetch``)
on the CPU, each test on a private registry.

The worker records each staged batch's ``read``, ``pin`` and ``put``
stages (wall seconds, and its own CPU seconds in ``read`` and
``pin``); the consumer counts the batches it hands out and the gets
that found the queue empty. The only timing bounds asserted are the
ones a sleep decides by a wide margin, so the tests hold on a loaded
machine.
"""

import time

import numpy as np
import pytest

from rocalphago_tpu_torch.data import pipeline
from rocalphago_tpu_torch.obs import registry

STAGES = ("read", "pin", "put")


def batches(n: int, sleep_s: float = 0.0):
    for i in range(n):
        if sleep_s:
            time.sleep(sleep_s)
        yield (np.full((4, 3), i, np.uint8), np.arange(4, dtype=np.int32))


class Series:
    """The prefetcher's series in ``reg``, read raw (unrounded)."""

    def __init__(self, reg):
        self.stage = {s: reg.histogram("prefetch_stage_seconds", stage=s)
                      for s in STAGES}
        self.cpu = {s: reg.counter("prefetch_stage_cpu_seconds_total",
                                   stage=s).value for s in STAGES[:2]}
        self.handed = reg.counter("prefetch_batches_total").value
        self.starved = reg.counter("prefetch_starved_total").value
        self.starved_s = reg.counter("prefetch_starved_seconds_total").value

    def counts(self) -> list:
        return [self.stage[s].count for s in STAGES]

    def wall(self, *stages) -> float:
        return sum(self.stage[s].sum for s in stages)

    def cpu_s(self, *stages) -> float:
        return sum(self.cpu[s] for s in stages)

    def offcpu_share(self) -> float:
        return 1.0 - self.cpu_s("read", "pin") / self.wall("read", "pin")

    def consistent(self) -> None:
        """The invariants every run keeps, finished or closed early."""
        staged = self.counts()
        assert staged[0] == staged[1] == staged[2] >= self.handed
        assert 0 <= self.starved <= self.handed
        assert self.starved_s >= 0
        for s in ("read", "pin"):
            assert 0 <= self.cpu[s] <= self.stage[s].sum


def test_every_batch_is_counted_once_a_stage():
    reg = registry.Registry()
    got = list(pipeline.device_prefetch(batches(7), "cpu", registry=reg))
    assert [int(p[0, 0]) for p, _ in got] == list(range(7))
    s = Series(reg)
    assert s.handed == 7
    assert s.counts() == [7, 7, 7]
    s.consistent()


def test_a_slow_host_iterator_starves_the_consumer_off_cpu():
    reg = registry.Registry()
    n = 12
    got = list(pipeline.device_prefetch(batches(n, sleep_s=0.02), "cpu",
                                        registry=reg))
    assert len(got) == n
    s = Series(reg)
    s.consistent()
    assert s.handed == n
    assert s.starved / s.handed > 0.8
    assert s.starved_s > 0
    # a sleeping iterator is read off the CPU
    assert s.offcpu_share() > 0.8


def test_a_slow_consumer_is_not_starved_and_the_worker_waits_to_put():
    reg = registry.Registry()
    n, size = 8, 2
    put = reg.histogram("prefetch_stage_seconds", stage="put")
    it = pipeline.device_prefetch(batches(n), "cpu", size=size,
                                  registry=reg)
    got = []
    for i in range(n):
        # the worker starts at the first get, which may find the queue
        # empty; before each later one it fills the queue, and every
        # get is followed by a slow step
        deadline = time.monotonic() + 10.0
        while i and put.count < min(i + size, n) \
                and time.monotonic() < deadline:
            time.sleep(0.001)
        got.append(next(it))
        time.sleep(0.02)
    with pytest.raises(StopIteration):
        next(it)
    assert len(got) == n
    s = Series(reg)
    s.consistent()
    assert s.handed == n
    assert s.starved <= 1
    assert s.wall("put") > 0


def test_closing_mid_run_leaves_consistent_totals():
    reg = registry.Registry()
    it = pipeline.device_prefetch(batches(50), "cpu", size=2,
                                  registry=reg)
    for _ in range(3):
        next(it)
    it.close()
    s = Series(reg)
    s.consistent()
    assert s.handed == 3
    assert 3 <= s.counts()[0] < 50


def test_an_iterator_that_raises_leaves_consistent_totals():
    reg = registry.Registry()

    def failing():
        yield from batches(2)
        raise OSError("shard vanished")

    it = pipeline.device_prefetch(failing(), "cpu", registry=reg)
    assert len([next(it), next(it)]) == 2
    with pytest.raises(OSError, match="vanished"):
        next(it)
    s = Series(reg)
    s.consistent()
    assert s.handed == 2 and s.counts() == [2, 2, 2]


def test_the_default_registry_gets_the_series():
    registry.reset()
    try:
        list(pipeline.device_prefetch(batches(3), "cpu"))
        snap = registry.snapshot()
        assert snap["counters"]["prefetch_batches_total"] == 3
        assert {f'prefetch_stage_seconds{{stage="{s}"}}' for s in STAGES} \
            <= set(snap["histograms"])
    finally:
        registry.reset()
