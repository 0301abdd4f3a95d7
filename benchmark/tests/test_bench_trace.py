"""The trace reader's interval arithmetic and the latency percentiles, on
made-up traces."""

import math

import pytest

from benchmark.lib import stats, trace
from benchmark.lib.trace import Event, Window


def window():
    return Window(
        t0=0.0, t1=100.0,
        kernels=[Event("a", 10, 20), Event("b", 20, 20), Event("c", 70, 10)],
        copies=[Event("Memcpy HtoD", 35, 10), Event("Memset", 95, 20)],
        host=[Event("cudaGraphLaunch", 0, 5), Event("cudaStreamSynchronize",
                                                    48, 20),
              Event("cudaMemcpyAsync", 30, 2)],
        ops=[Event("aten::copy_", 80, 14)])


def test_union_of_overlapping_intervals():
    w = window()
    # [10, 45) from a, b and the copy; [70, 80); [95, 100) clipped
    assert w.busy() == [(10, 45), (70, 80), (95, 100)]
    assert w.busy_seconds() == pytest.approx(50e-6)
    assert w.idle_pct() == pytest.approx(50.0)
    assert w.gaps() == [(0, 10), (45, 70), (80, 95)]
    assert w.kernel_seconds() == pytest.approx(50e-6)
    assert w.launches() == 2


def test_idle_gaps_go_to_what_the_host_was_doing():
    got = dict(window().idle_by_host())
    assert got == pytest.approx({"cudaGraphLaunch": 10e-6,
                                 "cudaStreamSynchronize": 25e-6,
                                 "aten::copy_": 15e-6})


def test_parse_keeps_the_labelled_window():
    ev = [dict(ph="X", cat="user_annotation", name="window", ts=100, dur=50),
          dict(ph="X", cat="kernel", name="k", ts=110, dur=5,
               args=dict(grid=[4, 1, 1])),
          dict(ph="X", cat="kernel", name="before", ts=10, dur=5),
          dict(ph="X", cat="gpu_memcpy", name="m", ts=140, dur=20),
          dict(ph="X", cat="cuda_runtime", name="cudaGraphLaunch", ts=101,
               dur=2),
          dict(ph="i", cat="kernel", name="instant", ts=120)]
    w = trace.parse({"traceEvents": ev}, "window")
    assert (w.t0, w.t1) == (100, 150)
    assert [e.name for e in w.kernels] == ["k"] and w.kernels[0].grid == (
        4, 1, 1)
    assert w.busy() == [(110, 115), (140, 150)]
    assert w.launches() == 1
    with pytest.raises(ValueError):
        trace.parse({"traceEvents": ev}, "other")


def test_percentile_is_nearest_rank_with_failures_last():
    v = list(range(1, 101))
    assert stats.percentile(v, 0.5) == 50
    assert stats.percentile(v, 0.95) == 95
    assert stats.percentile([3.0, math.inf, 1.0, 2.0], 0.5) == 2.0
    assert stats.percentile([1.0, math.inf], 0.95) == math.inf


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 11.0, 9.0, 10.0, 12.0, 8.0]
    q1, q2, q3 = 8.75, 10.0, 11.25          # statistics.quantiles, n=4
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)
