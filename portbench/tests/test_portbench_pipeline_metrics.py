"""The input pipeline's four readers on a fabricated default registry
(reset before and after): each returns the value its series give, and
None where they are absent, as on a program without them."""

import pytest

from portbench import harness
from rocalphago_tpu_torch.obs import registry

READING = harness.Reading(cell={}, workload={}, config={}, counters={},
                          trace=None)

#: the value each reader gives on :func:`fabricate`'s series
WANT = {
    "data_starved_share.train": 100.0 * 2 / 8,
    "data_read_ms.train": 1e3 * (0.010 + 0.030) / 2,
    "data_pin_ms.train": 1e3 * (0.004 + 0.006) / 2,
    "data_offcpu_share.train": 100.0 * (1.0 - (0.030 + 0.006) / 0.050),
}


@pytest.fixture
def reg():
    registry.reset()
    yield registry.REGISTRY
    registry.reset()


def fabricate(reg) -> None:
    stage = {s: reg.histogram("prefetch_stage_seconds", stage=s)
             for s in ("read", "pin", "put")}
    for v in (0.010, 0.030):
        stage["read"].observe(v)
    for v in (0.004, 0.006):
        stage["pin"].observe(v)
    for v in (0.002, 0.0):
        stage["put"].observe(v)
    reg.counter("prefetch_stage_cpu_seconds_total", stage="read").inc(0.030)
    reg.counter("prefetch_stage_cpu_seconds_total", stage="pin").inc(0.006)
    reg.counter("prefetch_batches_total").inc(8)
    reg.counter("prefetch_starved_total").inc(2)
    reg.counter("prefetch_starved_seconds_total").inc(0.015)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reads_its_series(reg, name):
    fabricate(reg)
    assert harness.load_reader(name).read(READING) == pytest.approx(
        WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_absent_series_read_none(reg, name):
    reg.counter("train_data_wait_seconds_unrelated_total").inc()
    assert harness.load_reader(name).read(READING) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_series_made_but_empty_read_none(reg, name):
    # the series exist before any batch is staged or handed out
    reg.histogram("prefetch_stage_seconds", stage="read")
    reg.histogram("prefetch_stage_seconds", stage="pin")
    for s in ("read", "pin"):
        reg.counter("prefetch_stage_cpu_seconds_total", stage=s)
    reg.counter("prefetch_batches_total")
    reg.counter("prefetch_starved_total")
    assert harness.load_reader(name).read(READING) is None


def test_the_readers_are_in_the_benchmark():
    bench = harness.load_json(f"{harness.ROOT}/BENCHMARK.json")
    got = {m["name"]: m for m in harness.cell_metrics(
        bench, "policy192.sl-train", "per_layer")}
    for name in WANT:
        assert got[name]["source"] == "program_counter"
        assert got[name]["layer"] == "input pipeline (data/pipeline.py)"
        assert got[name]["moves"] == "train_positions_per_s"
