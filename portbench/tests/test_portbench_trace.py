"""The traced window's reduction on synthetic traces: busy time is the
union of device intervals (overlaps once), idle gaps are what it leaves
of the window, each named by the host span and operation under it."""

import pytest

from portbench import trace


def test_union_counts_overlaps_once():
    ivals = [(0, 10), (5, 15), (12, 14), (20, 30), (25, 26), (40, 50)]
    assert trace.union_length(ivals, 0, 60) == 15 + 10 + 10


def test_union_clips_to_window():
    assert trace.union_length([(-5, 5), (55, 70)], 0, 60) == 10


def test_idle_gaps():
    ivals = [(5, 10), (8, 12), (20, 30)]
    assert trace.idle_gaps(ivals, 0, 40) == [(0, 5), (12, 20), (30, 40)]


def test_summary_and_idle_share():
    device = [(0, 10, "k1"), (5, 15, "k2"), (20, 30, "Memcpy HtoD"),
              (40, 50, "k1")]
    s = trace.summarize(device, (0, 60), units=3)
    assert s.busy_s == pytest.approx(35e-9)
    assert s.window_s == pytest.approx(60e-9)
    assert s.kernels == 3 and s.units == 3
    assert trace.idle_percent(s) == pytest.approx(100 * 25 / 60)
    assert dict(s.device_ops)["k1"] == pytest.approx(20e-9)
    assert set(s.breakdown()) == {"device_ops", "idle_gaps"}


def test_gaps_named_by_host_activity():
    device = [(0, 10, "k1"), (5, 15, "k2"), (20, 30, "Memcpy HtoD"),
              (40, 50, "k1")]
    spans = [(0, 60, trace.WINDOW_SPAN), (12, 45, "portbench.step"),
             (16, 18, "portbench.data")]
    ops = [(11, 19, "aten::add"), (12, 13, "aten::mul"),
           (31, 39, "cudaStreamSynchronize")]
    gaps = dict(trace.host_gaps(device, spans, ops, (0, 60)))
    assert gaps["portbench.data / aten::add"] == pytest.approx(5e-9)
    assert gaps["portbench.step / cudaStreamSynchronize"] == \
        pytest.approx(10e-9)
    assert gaps["harness / python"] == pytest.approx(10e-9)


def test_no_device_time_reads_nothing():
    s = trace.summarize([], (0, 60), 1)
    assert trace.idle_percent(s) is None
    assert trace.idle_percent(None) is None
