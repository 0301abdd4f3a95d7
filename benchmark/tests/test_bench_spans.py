"""The program's spans in a traced window (lib/spans.py) and the two
readers of them, on made-up windows and spans, as test_bench_trace.py does
for the trace; the trace clock the spans are recorded on; a tiny traced run
on the CPU through the harness prints the readers it can."""

import contextlib
import dataclasses
import io
import json

import pytest
import torch

from benchmark.lib import cell as cells
from benchmark.lib import spans as lspans
from benchmark.lib.trace import Event, Window
from benchmark.program import spans as pspans

PERIOD_NS = 7_889_238 * 10**9


@dataclasses.dataclass(eq=False)
class S:
    """A span as the program records it (times in µs on the trace's
    clock)."""

    name: str
    id: int
    parent: int | None
    ts: float
    end: float
    device_ms: float | None = None
    end_ns: int | None = 0


def window(t0, t1, busy):
    return Window(t0=t0, t1=t1, kernels=[Event("k", a, b - a)
                                         for a, b in busy])


def test_gaps_split_exactly_over_the_innermost_spans():
    # gaps (0, 10) and (20, 30); A [2, 25] holds B [4, 8]; C [22, 40]
    # starts inside A, so it is the innermost there; D never covers a gap
    A = S("a", 1, None, 2, 25)
    B = S("b", 2, 1, 4, 8)
    C = S("c", 3, None, 22, 40)
    D = S("d", 4, None, 11, 19)
    pieces = lspans.split([(0, 10), (20, 30)], [C, B, D, A])
    assert pieces == {None: 2, A: 2 + 2 + 2, B: 4, C: 8}
    assert sum(pieces.values()) == 20
    assert lspans.in_stage(pieces, [A, B, C, D], "a") == 10
    assert lspans.in_stage(pieces, [A, B, C, D], "b") == 4
    assert lspans.in_stage(pieces, [A, B, C, D], "d") == 0


def test_a_gap_inside_one_span_and_a_span_inside_one_gap():
    A = S("a", 1, None, 0, 100)
    B = S("b", 2, 1, 40, 41)
    pieces = lspans.split([(10, 50), (60, 70)], [A, B])
    assert pieces == {A: 39 + 10, B: 1}


def test_window_readers_clip_and_keep_what_overlaps():
    w = window(10, 50, [(10, 20), (30, 50)])       # idle (20, 30)
    spans = [S("x", 1, None, 0, 25), S("x", 2, None, 40, 60),
             S("y", 3, None, 50, 70), S("open", 4, None, 15, 16,
                                        end_ns=None)]
    assert [s.id for s in lspans.inside(w, spans)] == [1, 2]
    assert lspans.idle_in(w, spans, "x") == 5
    assert lspans.inside(w, []) is None and lspans.inside(w, None) is None
    assert lspans.idle_in(w, None, "x") is None
    assert lspans.idle_in(w, [], "x") is None


def _read(monkeypatch, name, t, spans):
    mod = cells.module("metrics", name)
    monkeypatch.setattr(mod, "recorded", lambda: spans)
    return mod.read(t)


def _plan_window():
    """Two plan calls in (0, 100): the device busy in (10, 30) and
    (60, 80)."""
    w = window(0, 100, [(10, 30), (60, 80)])
    spans = []
    for k, base in enumerate((0, 50)):
        i = 10 * k
        spans += [S("plan.call", i + 1, None, base + 1, base + 45),
                  S("plan.prepare", i + 2, i + 1, base + 1, base + 5),
                  S("graph.replay", i + 3, i + 1, base + 6, base + 12),
                  S("graph.loop", i + 4, i + 1, base + 12, base + 38),
                  S("graph.replay", i + 5, i + 4, base + 12, base + 14),
                  S("graph.flag_wait", i + 6, i + 4, base + 20, base + 33)]
    return dict(window=w, counts=dict(calls=2)), spans


def test_plan_readers(monkeypatch):
    t, spans = _plan_window()
    # a call's idle: (base, base + 10) and (base + 30, base + 50)
    assert _read(monkeypatch, "idle_prepare_ms.single", t, spans) == \
        pytest.approx(4e-3)
    # the replay at (base + 6, base + 10) and the loop's idle
    # (base + 30, base + 38) lie outside plan.prepare
    pieces = lspans.split(t["window"].gaps(), spans)
    assert lspans.in_stage(pieces, spans, "graph.replay") == 2 * 4
    assert lspans.in_stage(pieces, spans, "graph.loop") == 2 * 8
    name = "idle_prepare_ms.single"
    assert _read(monkeypatch, name, t, None) is None
    assert _read(monkeypatch, name, t, []) is None
    far = [dataclasses.replace(s, ts=s.ts + 500, end=s.end + 500)
           for s in spans]
    assert _read(monkeypatch, name, t, far) is None


def test_mpc_readers(monkeypatch):
    w = window(0, 1000, [(100, 990)])
    spans = [S("mpc.init", 1, None, 5, 60),
             S("mpc.run", 2, None, 70, 995)]
    spans += [S("mpc.tick", 10 + i, 2, 100 + 8 * i, 108 + 8 * i,
                device_ms=float(i + 1)) for i in range(100)]
    t = dict(window=w, counts=dict(ticks=100))
    name = "tick_device_p90_ms.mpc"
    # nearest rank: the 90th of 1..100
    assert _read(monkeypatch, name, t, spans) == 90.0
    pending = spans[:-1] + [dataclasses.replace(spans[-1], device_ms=None)]
    assert _read(monkeypatch, name, t, pending) is None
    assert _read(monkeypatch, name, t, None) is None
    assert _read(monkeypatch, name, t, []) is None
    assert _read(monkeypatch, name, t, spans[:2]) is None     # no tick


def test_the_programs_spans_or_none(monkeypatch):
    from tpustomp_torch.utils import tracing

    rec = tracing.Recorded([S("x", 1, None, 0, 1)], 0)
    monkeypatch.setattr(tracing, "recorded", lambda: rec)
    assert pspans.recorded() == rec.spans
    rec.dropped = 3                          # a full buffer: no reading
    assert pspans.recorded() is None
    monkeypatch.delattr(tracing, "recorded")  # a program with no spans
    assert pspans.recorded() is None


def test_trace_us_against_a_hand_computed_base():
    from tpustomp_torch.utils.tracing import trace_us

    # Unix time late in 2026 lies in period 227: base 227 × 7,889,238 s
    base = 227 * PERIOD_NS
    assert base == 1_790_857_026_000_000_000
    ns = base + 3_600 * 10**9 + 123_456
    assert trace_us(ns) == pytest.approx(3_600e6 + 123.456)
    assert trace_us(base) == 0.0
    assert trace_us(base - 1_000) == pytest.approx(PERIOD_NS / 1e3 - 1.0)


@pytest.mark.parametrize("name,readers", [
    ("stomp7_tabletop.single", {"idle_prepare_ms.single"}),
    ("stomp7_tabletop.batch1024", set()),
    ("stomp7_mpc.fleet10k", set())])
def test_a_tiny_traced_run_prints_the_span_readers(name, readers):
    """The harness's traced run on the CPU at a tiny size (the tests of
    test_bench_run.py): the program records its spans under the
    profiler, and each reader that can read on the CPU prints (the tick's
    device ms need a card)."""
    from benchmark import run as harness
    from benchmark.tests.test_bench_run import tiny
    from tpustomp_torch.utils import tracing

    args = harness.parse(["--workload", name, "--seed", str(2**33 + 5),
                          "--seconds", "0.1", "--trace", "1"])
    out = io.StringIO()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(out):
            rc = harness.run(args, tiny(name), device=torch.device("cpu"))
    finally:
        torch.set_num_threads(n)
        tracing.clear_spans()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0
    assert readers <= set(line["metrics"])
    assert all(line["metrics"][r]["value"] >= 0 for r in readers)
    assert "tick_device_p90_ms.mpc" not in line["metrics"]
