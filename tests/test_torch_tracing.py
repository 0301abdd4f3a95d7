"""The port's spans (tpustomp_torch/utils/tracing.py): off, a span site
reads no clock and records nothing; on (`tracing.spans()` or a
torch.profiler), the plan call's and the MPC episode's stages nest under
one request per public call, on the profiler trace's clock; `profile()`
exports its block's spans and takes them out of the buffer; the buffer is
bounded.

The solver's graphs are emulated on the CPU as in tests/test_torch_graph.py
(a capture runs the region's host code once and puts its buffers back, a
replay runs it again), so the graph's spans show; this file imports no
JAX, for its `cuda` test. That test runs on the card (skips without one):
every cudaGraphLaunch of a graphed `plan` inside a `graph.replay` span,
and an episode's `mpc.tick` device ms against its events' span and its
wall time.
"""

import json
import os
import time
import types

import numpy as np
import pytest
import torch

from tpustomp_torch import PlannerConfig, ProblemSpec, plan, plan_batch
from tpustomp_torch.api import plan as tplan
from tpustomp_torch.api.config import NoiseConfig
from tpustomp_torch.engine import graph, mpc
from tpustomp_torch.robot.model import arm_7dof, planar_2r
from tpustomp_torch.utils import tracing
from tpustomp_torch.world.sdf import AnalyticWorld

_SPHERE = AnalyticWorld.make(spheres=[((1.88, 0.42, 0.0), 0.27)])
_PLANAR = planar_2r()     # one robot each: a graph's key names it by
_ARM = arm_7dof()         # identity
_BOXES = AnalyticWorld.make(boxes=[((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),
                                   ((0.68, -0.05, 0.62), (0.06, 0.06, 0.18))])
_CFG = PlannerConfig(num_timesteps=8, num_rollouts=4, max_iterations=3)
_MPC = PlannerConfig(num_timesteps=10, duration=1.2, num_rollouts=4,
                     noise=NoiseConfig(stddev=0.1, decay=0.98,
                                       num_rollouts_reused=1),
                     collision_clearance=0.05, max_iterations=3,
                     max_iterations_after_collision_free=1,
                     record_metrics=False)


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test runs on one CPU thread (restored after), with an empty
    span buffer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.clear_spans()
    yield
    tracing.clear_spans()
    torch.set_num_threads(n)


class _Replay:
    """An emulated graph: a replay runs the captured region's host code
    again, the kernel counters left as they were."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        counts = [dict(c) for c in graph._COUNTERS]
        self.body()
        for c, saved in zip(graph._COUNTERS, counts):
            c.update(saved)

    def reset(self):
        self.body = None


_CAPTURING = []


def _capture(body, stream, generator=None):
    bufs = body.__self__.buffers()
    saved = [v.clone() for v in bufs]
    _CAPTURING.append(True)
    try:
        body()
    finally:
        _CAPTURING.pop()
    for v, s in zip(bufs, saved):
        v.copy_(s)
    return _Replay(body), 0.0, 0.0, 0


@pytest.fixture
def emulated(monkeypatch):
    """The graph path on CPU tensors."""
    real = graph.eager_reason
    monkeypatch.setattr(graph, "eager_reason", lambda *a, **k: (
        None if real(*a, **k) == "cpu" else real(*a, **k)))
    monkeypatch.setattr(graph, "_stream", lambda *a, **k: None)
    monkeypatch.setattr(graph, "_on", lambda stream, fn: fn())
    monkeypatch.setattr(graph, "_capture", _capture)
    monkeypatch.setattr(graph, "_if_node", lambda pred, fn: fn() if (
        _CAPTURING or bool(pred)) else None)
    graph.clear()
    graph.reset_counts()
    yield
    graph.clear()


def _batch(B=2):
    rng = np.random.default_rng(0)
    return ProblemSpec(q0=rng.uniform(-0.1, 0.1, (B, 2)).astype(np.float32),
                       qN=np.ones((B, 2), np.float32))


def _states(B=3, seed=0):
    rng = np.random.default_rng(seed)
    q0 = (np.array([-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0])
          + rng.uniform(-0.03, 0.03, (B, 7))).astype(np.float32)
    qN = (np.array([0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0])
          + rng.uniform(-0.03, 0.03, (B, 7))).astype(np.float32)
    centers = rng.uniform(0.4, 0.7, (B, 1, 3)).astype(np.float32)
    return q0, qN, centers, rng.normal(0, 0.3, (B, 1, 3))


def _episode(state, ticks=3, device="cpu"):
    return mpc.run_mpc_batch(_ARM, _MPC, state, [0.12], ticks, 0.1,
                             static_world=_BOXES, device=device,
                             generator=torch.Generator(device).manual_seed(3))


def _by_id(spans):
    return {s.id: s for s in spans}


def _names(spans, request=None):
    return {s.name for s in spans if request in (None, s.request)}


def _ancestors(s, by_id):
    out = []
    while s.parent is not None:
        s = by_id[s.parent]
        out.append(s.name)
    return out


def _assert_nested(spans):
    """Every span lies inside its parent, in its parent's request; a root
    opens its own request."""
    by_id = _by_id(spans)
    for s in spans:
        assert s.end_ns >= s.start_ns, s
        if s.parent is None:
            assert s.request == s.id, s
            continue
        p = by_id[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
        assert s.request == p.request, (s, p)


def test_off_records_nothing_and_reads_no_clock(monkeypatch, emulated):
    reads = []
    real = tracing._clock
    monkeypatch.setattr(tracing, "_clock",
                        lambda: reads.append(1) or real())
    assert tracing.span("x") is tracing.OFF
    sol = plan_batch(_PLANAR, _SPHERE, _batch(), _CFG, device="cpu")
    sol.to("cpu")
    plan(_PLANAR, _SPHERE, ProblemSpec(q0=[0.0, 0.0], qN=[1.0, 1.0]),
         _CFG, device="cpu")
    state = mpc.init_mpc(_ARM, _MPC, *_states())
    _episode(state).to("cpu")
    _episode(state)                         # a cache hit: mpc.load's path
    assert reads == []
    rec = tracing.recorded()
    assert rec.spans == [] and rec.dropped == 0
    assert tracing.span("x") is tracing.OFF
    assert tracing.request("x") is tracing.OFF


@pytest.mark.parametrize("route", ["chunk", "per_iteration"])
def test_plan_spans_nest_under_one_request_per_call(emulated, route):
    cfg = _CFG
    prob = ProblemSpec(q0=_batch().q0, qN=_batch().qN,
                       goal_tolerance_below=0.05, goal_tolerance_above=0.05)
    with tracing.spans():
        assert tracing.span("x") is not tracing.OFF
        for _ in range(2):                   # a miss, then a hit
            if route == "per_iteration":
                with graph.per_iteration():
                    sol = plan_batch(_PLANAR, _SPHERE, prob, cfg,
                                     device="cpu")
            else:
                sol = plan_batch(_PLANAR, _SPHERE, prob, cfg,
                                 device="cpu")
        host = sol.to("cpu")
        one = plan(_PLANAR, _SPHERE,
                   ProblemSpec(q0=[0.0, 0.0], qN=[1.0, 1.0]), cfg,
                   device="cpu")
    assert host.cost.shape == (2,) and one.cost.shape == ()
    spans = tracing.recorded().spans
    _assert_nested(spans)
    roots = sorted((s for s in spans if s.parent is None),
                   key=lambda s: s.start_ns)
    # one request per public call: plan_batch twice, Solution.to, plan
    # (whose plan_batch opens none)
    assert [s.name for s in roots] == ["plan.call", "plan.call",
                                       "solution.copy", "plan.call"]
    assert [s.attrs.get("B") for s in roots] == [2, 2, None, 1]
    assert roots[2].attrs == {"to": "cpu"}
    assert len({s.request for s in spans}) == 4
    first, hit = roots[0].request, roots[1].request
    loop = {"plan.call", "plan.prepare", "graph.lookup", "graph.capture",
            "graph.load", "graph.replay", "graph.loop"}
    if route == "per_iteration":
        loop.add("graph.flag_wait")        # on the CPU a chunk reads no event
    assert _names(spans, first) == loop
    assert _names(spans, hit) == loop - {"graph.capture"}
    by_id = _by_id(spans)
    for s in spans:
        up = _ancestors(s, by_id)
        if s.name == "plan.prepare":
            assert up == ["plan.call"]
        if s.name == "graph.flag_wait":
            assert up[0] == "graph.loop"
        if s.name == "graph.replay":
            assert s.attrs["region"] in ("goal", "solve-in", "solve-out",
                                         "chunk", "iteration"), s
            assert "plan.call" in up
    # the goal band replays inside plan.prepare, the solve outside it
    regions = {(s.attrs["region"], _ancestors(s, by_id)[0])
               for s in spans if s.name == "graph.replay"
               and s.request == hit}
    body = "chunk" if route == "chunk" else "iteration"
    assert regions == {("goal", "plan.prepare"), ("solve-in", "plan.call"),
                       (body, "graph.loop"), ("solve-out", "plan.call")}
    loops = [s for s in spans if s.name == "graph.loop" and s.request == hit]
    assert loops and all(1 <= s.attrs["iterations"] <= 3
                         and s.attrs["chunks"] >= 1 for s in loops)
    caps = [s for s in spans if s.name == "graph.capture"]
    assert {s.attrs["region"] for s in caps} >= {"goal", "solve-in",
                                                 "solve-out", body}
    assert all("capture_ms" in s.attrs for s in caps)
    loads = [s for s in spans if s.name == "graph.load" and s.request == hit]
    assert loads and all(s.attrs["inputs"] == 0 for s in loads)


def test_mpc_spans_and_their_requests(emulated):
    with tracing.spans():
        state = mpc.init_mpc(_ARM, _MPC, *_states())
        _episode(state, ticks=3)             # a miss: tick 0 captures
        out = _episode(state, ticks=4)       # a hit
        host = out.to("cpu")
    assert host.q.shape == (3, 7)
    spans = tracing.recorded().spans
    _assert_nested(spans)
    roots = sorted((s for s in spans if s.parent is None),
                   key=lambda s: s.start_ns)
    assert [s.name for s in roots] == ["mpc.init", "mpc.run", "mpc.run",
                                       "state.copy"]
    assert roots[0].attrs["B"] == 3
    assert str(roots[0].attrs["device"]) == "cpu"
    assert [s.attrs["ticks"] for s in roots[1:3]] == [3, 4]
    assert len({s.request for s in spans}) == 4
    miss, hit = roots[1].request, roots[2].request
    # run_mpc_batch's own copy of the state opens no request, no span
    assert "state.copy" not in _names(spans, miss) | _names(spans, hit)
    assert _names(spans, hit) == {"mpc.run", "mpc.load", "mpc.tick",
                                  "graph.replay", "mpc.total_read",
                                  "mpc.copy_out"}
    assert "graph.capture" in _names(spans, miss)
    ticks = sorted(s.attrs["tick"] for s in spans
                   if s.name == "mpc.tick" and s.request == hit)
    assert ticks == [0, 1, 2, 3]
    by_id = _by_id(spans)
    regions = sorted(s.attrs["region"] for s in spans
                     if s.name == "graph.replay" and s.request == hit
                     and by_id[s.parent].attrs.get("tick") == 1)
    assert regions == ["chunk", "tick-in", "tick-out"]
    assert all(s.device_ms is None for s in spans)     # no card: no event


def test_eager_ticks_are_spans_too():
    with tracing.spans():
        out = _episode(mpc.init_mpc(_ARM, _MPC, *_states()), ticks=2)
    assert out.q.shape == (3, 7)
    spans = tracing.recorded().spans
    _assert_nested(spans)
    assert sorted(s.attrs["tick"] for s in spans
                  if s.name == "mpc.tick") == [0, 1]


def test_spans_of_threads_have_their_own_parents():
    import threading

    seen = {}

    def work(i):
        with tracing.span("outer", i=i) as s:
            with tracing.span("inner", i=i):
                pass
        seen[i] = s

    with tracing.spans():
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    spans = tracing.recorded().spans
    _assert_nested(spans)
    for s in spans:
        if s.name == "inner":
            assert s.parent == seen[s.attrs["i"]].id


def test_trace_us_is_the_traces_clock():
    period = 7_889_238 * 10**9
    ns = 227 * period + 1_234_567_891
    assert tracing.trace_us(ns) == pytest.approx(1_234_567.891)
    assert tracing.trace_us(228 * period - 1000) == pytest.approx(
        period / 1e3 - 1.0)


def _annotated_prepare(monkeypatch):
    """plan.prepare's work inside a profiler annotation "prepare_work"."""
    real = tplan._prepared

    def wrapped(*a, **k):
        with torch.profiler.record_function("prepare_work"):
            return real(*a, **k)

    monkeypatch.setattr(tplan, "_prepared", wrapped)


def test_spans_sit_on_the_profilers_clock(monkeypatch, tmp_path):
    """Under a torch.profiler (no spans() block) every plan.prepare span
    encloses its work's annotation and the aten ops inside it, within
    0.5 ms, in the exported trace and by trace_us."""
    _annotated_prepare(monkeypatch)
    taken, take = [], tracing._take      # the spans profile() exports
    monkeypatch.setattr(tracing, "_take", lambda *a: taken.append(
        take(*a)) or taken[-1])
    logdir = str(tmp_path / "trace")
    with tracing.profile(logdir):
        for _ in range(3):
            plan_batch(_PLANAR, _SPHERE, _batch(), _CFG, device="cpu")
    assert tracing.span("x") is tracing.OFF
    with open(os.path.join(logdir, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    work = sorted((e for e in events if e["name"] == "prepare_work"),
                  key=lambda e: e["ts"])
    exported = sorted((e for e in events if e.get("cat") == "tpustomp_span"
                       and e["name"] == "plan.prepare"),
                      key=lambda e: e["ts"])
    spans = sorted((s for s in taken[0][0] if s.name == "plan.prepare"),
                   key=lambda s: s.start_ns)
    assert len(work) == len(exported) == len(spans) == 3
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")]
    tol = 500.0
    for w, e, s in zip(work, exported, spans):
        lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        mine = [o for o in ops if lo <= o["ts"] and o["ts"] + o["dur"] <= hi]
        assert mine
        for t0, t1 in ((s.ts, s.end), (e["ts"], e["ts"] + e["dur"])):
            assert t0 - tol <= lo and hi <= t1 + tol, (t0, t1, lo, hi)
            for o in mine:
                assert t0 - tol <= o["ts"] and o["ts"] + o["dur"] <= t1 + tol


def test_profile_exports_the_spans(tmp_path):
    logdir = str(tmp_path / "trace")
    with tracing.profile(logdir):
        plan_batch(_PLANAR, _SPHERE, _batch(), _CFG, device="cpu")
    with open(os.path.join(logdir, "trace.json")) as f:
        trace = json.load(f)
    mine = [e for e in trace["traceEvents"]
            if e.get("cat") == "tpustomp_span"]
    assert {e["name"] for e in mine} == {"plan.call", "plan.prepare"}
    for e in mine:
        assert e["ph"] == "X" and e["pid"] == os.getpid() and e["dur"] >= 0
        assert {"id", "parent", "request"} <= set(e["args"])
    (call,) = [e for e in mine if e["name"] == "plan.call"]
    assert call["args"]["B"] == 2 and call["args"]["parent"] is None


def test_the_buffer_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setattr(tracing, "SPAN_LIMIT", 5)
    with tracing.spans():
        for i in range(8):
            with tracing.span("s", i=i) as s:
                s.set(j=i)
    rec = tracing.recorded()
    assert [s.attrs for s in rec.spans] == [dict(i=i, j=i) for i in range(5)]
    assert rec.dropped == 3
    tracing.clear_spans()
    rec = tracing.recorded()
    assert rec.spans == [] and rec.dropped == 0


def test_profile_takes_its_spans_out_of_the_buffer(monkeypatch, tmp_path):
    """A profile() block exports its spans and takes them out of the
    buffer, so a second block after one that filled it still exports
    its own; the first block's trace counts what it dropped."""
    monkeypatch.setattr(tracing, "SPAN_LIMIT", 3)
    with tracing.spans():
        with tracing.span("before"):
            pass
    traces = []
    for k, n in enumerate((5, 2)):
        logdir = str(tmp_path / f"trace{k}")
        with tracing.profile(logdir):
            for i in range(n):
                with tracing.span(f"block{k}", i=i):
                    pass
        with open(os.path.join(logdir, "trace.json")) as f:
            traces.append(json.load(f))
    mine = [[e["args"]["i"] for e in t["traceEvents"]
             if e.get("cat") == "tpustomp_span"] for t in traces]
    assert mine == [[0, 1], [0, 1]]
    assert traces[0]["tpustomp_spans_dropped"] == 3
    assert "tpustomp_spans_dropped" not in traces[1]
    rec = tracing.recorded()        # what was there before the blocks stays
    assert [s.name for s in rec.spans] == ["before"] and rec.dropped == 0


def test_an_eager_settle_of_a_cached_entry_is_no_capture(monkeypatch):
    """A cached entry whose layout does not fit the state settles eagerly
    inside the caller's span: no graph.capture span."""
    monkeypatch.setattr(graph, "_fits", lambda g, state: False)
    monkeypatch.setattr(graph, "_load_state", lambda *a, **k: None)
    monkeypatch.setattr(graph, "_settle", lambda g, step, state, it_limit,
                        count: (state, count + 1, False))
    e = types.SimpleNamespace(loop=types.SimpleNamespace(region="chunk"))
    with tracing.spans():
        with tracing.span("caller"):
            assert graph.ready(e, False, None, "state", 3, 0) == (
                "state", 1, False)
    assert [s.name for s in tracing.recorded().spans] == ["caller"]


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (graphed solves, CUDA events)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_on_the_card(cuda_device, tmp_path):
    """Every cudaGraphLaunch of a graphed plan lies inside a graph.replay
    span of the exported trace; an episode's mpc.tick device ms are
    positive, add up to within 5 % of the events around all its ticks
    and to most of the episode's wall time (device-bound at B = 2,048)."""
    cfg = PlannerConfig(num_timesteps=100, num_rollouts=50,
                        max_iterations=50,
                        max_iterations_after_collision_free=5)
    robot = arm_7dof().to(cuda_device)
    world = _BOXES
    prob = ProblemSpec(q0=[-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0],
                       qN=[0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0])
    gen = torch.Generator(cuda_device).manual_seed(0)
    for _ in range(2):                       # capture, then replay
        plan(robot, world, prob, cfg, device=cuda_device, generator=gen)
    torch.cuda.synchronize()
    logdir = str(tmp_path / "trace")
    with tracing.profile(logdir):
        for _ in range(3):
            plan(robot, world, prob, cfg, device=cuda_device,
                 generator=gen).to("cpu")
        torch.cuda.synchronize()
    with open(os.path.join(logdir, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    launches = [e for e in events if e["name"] in ("cudaGraphLaunch",
                                                   "cuGraphLaunch")]
    replays = sorted(((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("cat") == "tpustomp_span"
                      and e["name"] == "graph.replay"))
    assert len(launches) >= 3 * 3 and len(replays) >= len(launches)
    for e in launches:
        assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                   for a, b in replays), e

    B, ticks = 2048, 6
    rng = np.random.default_rng(0)
    q0 = (np.array([-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0])
          + rng.uniform(-0.03, 0.03, (B, 7))).astype(np.float32)
    qN = (np.array([0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0])
          + rng.uniform(-0.03, 0.03, (B, 7))).astype(np.float32)
    centers = np.stack([rng.uniform(0.9, 1.2, B), rng.uniform(-0.6, 0.6, B),
                        rng.uniform(0.3, 0.8, B)], 1)[:, None]
    vels = rng.normal(0, 0.2, (B, 1, 3))
    cfg5 = PlannerConfig(num_timesteps=50, duration=3.0, num_rollouts=16,
                         noise=NoiseConfig(stddev=0.25, decay=1.0,
                                           num_rollouts_reused=4),
                         collision_clearance=0.05, max_iterations=8,
                         max_iterations_after_collision_free=2,
                         record_metrics=False)
    state = mpc.init_mpc(robot, cfg5, q0, qN, centers, vels)
    gen = torch.Generator(cuda_device).manual_seed(1)
    mpc.run_mpc_batch(robot, cfg5, state, [0.12], 2, 0.1, static_world=world,
                      device=cuda_device, generator=gen)   # captures
    torch.cuda.synchronize()
    tracing.clear_spans()
    with tracing.spans():
        t0 = time.perf_counter()
        mpc.run_mpc_batch(robot, cfg5, state, [0.12], ticks, 0.1,
                          static_world=world, device=cuda_device,
                          generator=gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans = sorted((s for s in tracing.recorded().spans
                    if s.name == "mpc.tick"), key=lambda s: s.start_ns)
    assert [s.attrs["tick"] for s in spans] == list(range(ticks))
    assert all(s.device_ms is not None and s.device_ms > 0 for s in spans)
    whole = spans[0].events[0].elapsed_time(spans[-1].events[1])
    total = sum(s.device_ms for s in spans)
    assert abs(total - whole) <= 0.05 * whole, (total, whole)
    # the host queues every tick without a read between them, far ahead
    # of the device: events on the stream that runs the ticks read the
    # device's work, most of the episode's wall time; on a stream that
    # carries none of it they would read the host's launches, a few ms
    assert 0.5 * wall_ms <= total <= 1.01 * wall_ms, (total, wall_ms)
