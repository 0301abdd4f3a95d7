"""Profiling, spans and numeric checks (port of
``tpustomp/utils/tracing.py``).

  - `profile(logdir)`: ``torch.profiler`` over the enclosed work, CPU and
    (with a card) CUDA activity, exported as a Chrome trace into `logdir`,
    the program's spans of the block among its events.
  - `spans()`: record the program's spans inside the block. A span is one
    stage of a public call at a layer's boundary (the plan call's checks
    and copies, a graph's lookup, load, replays and loop, a read of the
    loop's condition, an MPC episode's ticks, the gradient of a CHOMP
    iteration on a loop of one iteration a replay or an eager loop,
    `chomp.grad`, a voxel field's build and its copy to a device,
    `world.*`): its name, its host start
    and end on the profiler trace's clock (`trace_us`), its parent, the
    request it belongs to (one public call: every span under one root)
    and its attributes. A span opened with ``device=True`` also records a
    CUDA timing event on the current stream at its start and at its end;
    they resolve to device ms when the spans are read, after the caller's
    synchronize (a span never synchronizes). Spans are recorded as well
    while a ``torch.profiler`` records, so a profiler window gets them with
    no other switch. Outside both a span site costs a call and one flag
    test, and gets the shared no-op OFF: no clock read, no event, no span.
    `recorded()` reads the spans, `clear_spans()` empties the buffer (at
    most SPAN_LIMIT spans; those beyond are counted as dropped). Spans stay
    in the buffer until taken out: `profile()` takes its block's spans
    with it; whoever runs a ``torch.profiler`` of their own, or a
    `spans()` block, reads `recorded()` and then calls `clear_spans()`.
  - `debug_mode()`: the counterpart of ``jax_debug_nans``. Inside it the
    solver's `run_until` checks the state after every iteration and raises
    FloatingPointError naming the iteration; autograd's anomaly mode is on
    for CHOMP's exact gradients. Outside it the loop adds no check and no
    device sync.
  - `checked_solve(...)`: ``solver.solve_batch`` under `debug_mode()`.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_DEBUG = contextvars.ContextVar("tpustomp_torch_debug", default=False)

# Spans the buffer holds; later ones are dropped and counted.
SPAN_LIMIT = 65_536

# The profiler's trace counts time from the start of the current
# 7,889,238 s period of Unix time (Kineto's ChromeTraceBaseTime, torch's
# baseTimeNanoseconds).
_TRACE_PERIOD_S = 7_889_238

_clock = time.time_ns          # the host clock of every span
_ON = 0                        # spans() blocks open
_PARENT = contextvars.ContextVar("tpustomp_torch_span", default=None)
_IDS = itertools.count(1)
_LOCK = threading.Lock()
_SPANS: list = []
_DROPPED = 0


def debug_enabled() -> bool:
    """True inside `debug_mode()`."""
    return _DEBUG.get()


def trace_us(ns: int) -> float:
    """Unix time in ns as a ``ts`` of torch.profiler's Chrome trace: µs
    since the start of the 7,889,238 s period that holds it."""
    base = ns // 10**9 // _TRACE_PERIOD_S * _TRACE_PERIOD_S * 10**9
    return (ns - base) / 1e3


@dataclasses.dataclass(eq=False)
class Span:
    """One recorded stage: `start_ns` / `end_ns` on the host (Unix ns),
    `ts` / `end` on the trace's clock (µs), `parent` the id of the span it
    ran in (None for a request's root), `thread` the Python ident of its
    thread (not the native id: a system call, tens of µs on some hosts),
    `device_ms` the current stream's time between its two events
    (device=True; None until they are read done)."""

    name: str
    id: int
    parent: int | None
    request: int
    thread: int
    attrs: dict
    start_ns: int = 0
    end_ns: int | None = None
    events: tuple | None = None
    device_ms: float | None = None
    _token: object = dataclasses.field(default=None, repr=False)

    @property
    def ts(self) -> float:
        return trace_us(self.start_ns)

    @property
    def end(self) -> float:
        return trace_us(self.end_ns)

    def set(self, **attrs) -> None:
        """Attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self._token = _PARENT.set(self)
        if self.events is not None:
            self.events[0].record()
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc) -> None:
        global _DROPPED
        if self.events is not None:
            self.events[1].record()
        self.end_ns = _clock()
        _PARENT.reset(self._token)
        self._token = None
        with _LOCK:
            if len(_SPANS) < SPAN_LIMIT:
                _SPANS.append(self)
            else:
                _DROPPED += 1


class _Off:
    """What a span site gets while nothing records: enters, sets and
    exits as a span does, and records nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None


OFF = _Off()


def span(name: str, device: bool = False, **attrs):
    """``with span("graph.load") as s: ...; s.set(inputs=n)``: one span
    of the current request (a new request where none is open), or OFF
    when nothing records. device=True: also CUDA timing events on the
    current stream (where CUDA is initialized)."""
    if not (_ON or _autograd_profiler._is_profiler_enabled):
        return OFF
    parent = _PARENT.get()
    sid = next(_IDS)
    s = Span(name, sid, None if parent is None else parent.id,
             sid if parent is None else parent.request,
             threading.get_ident(), attrs)
    if device and torch.cuda.is_initialized():
        s.events = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
    return s


def request(name: str, **attrs):
    """The root span of a public call, which opens a request; OFF inside
    another span (a public call made by another opens none) or when
    nothing records."""
    if not (_ON or _autograd_profiler._is_profiler_enabled):
        return OFF
    if _PARENT.get() is not None:
        return OFF
    return span(name, **attrs)


@contextlib.contextmanager
def spans():
    """Record the program's spans inside the block (see module doc)."""
    global _ON
    with _LOCK:
        _ON += 1
    try:
        yield
    finally:
        with _LOCK:
            _ON -= 1


@dataclasses.dataclass
class Recorded:
    """The buffer's spans, in the order they ended, and how many were
    dropped because it was full."""

    spans: list
    dropped: int


def recorded() -> Recorded:
    """The spans recorded so far (their device ms resolved where both
    events are done) and the count dropped."""
    with _LOCK:
        out = Recorded(list(_SPANS), _DROPPED)
    _resolve(out.spans)
    return out


def _resolve(spans: list) -> None:
    """Each span's device ms where both its events are done."""
    for s in spans:
        if s.device_ms is None and s.events is not None \
                and s.events[1].query():
            s.device_ms = s.events[0].elapsed_time(s.events[1])


def clear_spans() -> None:
    """Empty the buffer and its count of drops."""
    global _DROPPED
    with _LOCK:
        _SPANS.clear()
        _DROPPED = 0


def _trace_events(spans: list, base_ns: int | None) -> list:
    """`spans` as Chrome trace "X" events on this process, a track per
    thread, `ts` from the trace's base (or `trace_us`)."""
    pid = os.getpid()

    def us(ns):
        return trace_us(ns) if base_ns is None else (ns - base_ns) / 1e3

    return [{"ph": "X", "cat": "tpustomp_span", "name": s.name, "pid": pid,
             "tid": f"spans {s.thread}", "ts": us(s.start_ns),
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"id": s.id, "parent": s.parent, "request": s.request,
                      **({} if s.device_ms is None
                         else {"device_ms": s.device_ms}),
                      **{k: v if isinstance(v, (int, float, str, bool))
                         else str(v) for k, v in s.attrs.items()}}}
            for s in spans]


@contextlib.contextmanager
def profile(logdir: str = "tpustomp_trace"):
    """``with profile(dir) as prof: plan_batch(...)`` writes
    ``dir/trace.json`` (chrome://tracing, Perfetto) when the block ends,
    the program's spans of the block ("tpustomp_span" events) above the
    profiler's, and the count of the block's spans the full buffer
    dropped ("tpustomp_spans_dropped"), if any; `prof` is the
    ``torch.profiler.profile`` (``key_averages()``, ``events()``). The
    block's spans leave the buffer with the export."""
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    dropped0 = _DROPPED
    t0 = _clock()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    t1 = _clock()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    mine, dropped = _take(t0, t1, dropped0)
    if not (mine or dropped):
        return
    with open(path) as f:
        trace = json.load(f)
    trace.setdefault("traceEvents", []).extend(
        _trace_events(mine, trace.get("baseTimeNanoseconds")))
    if dropped:
        trace["tpustomp_spans_dropped"] = dropped
    with open(path, "w") as f:
        json.dump(trace, f)


def _take(t0: int, t1: int, dropped0: int) -> tuple:
    """Take the spans that started in [t0, t1] out of the buffer (their
    device ms resolved) and the drops counted since `dropped0` out of its
    count: (spans, drops)."""
    global _DROPPED
    with _LOCK:
        mine = [s for s in _SPANS if t0 <= s.start_ns <= t1]
        _SPANS[:] = [s for s in _SPANS if not t0 <= s.start_ns <= t1]
        dropped = max(0, _DROPPED - dropped0)
        _DROPPED -= dropped
    _resolve(mine)
    return mine, dropped


@contextlib.contextmanager
def debug_mode():
    """Check every solver iteration for NaN/inf state (see module doc)."""
    token = _DEBUG.set(True)
    try:
        with torch.autograd.set_detect_anomaly(True):
            yield
    finally:
        _DEBUG.reset(token)


def check_state(state, iteration: int) -> None:
    """Raise FloatingPointError if a float field of the solver state holds
    a NaN, or a trajectory field an inf (best_cost is inf until a
    collision-free iterate is found). One host sync."""
    bad = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if not v.is_floating_point():
            continue
        ok = (torch.isfinite(v) if v.dim() >= 3 else ~torch.isnan(v)).all()
        if not bool(ok):
            bad.append(f.name)
    if bad:
        raise FloatingPointError(
            f"non-finite solver state after iteration {iteration}: {bad}")


def checked_solve(robot, world, cfg, ops, Q0, QN, noise_fn, **kw):
    """``solver.solve_batch`` (same arguments) under `debug_mode()`: raises
    FloatingPointError at the first iteration that leaves a NaN/inf in the
    state, instead of returning a poisoned Solution."""
    from tpustomp_torch.engine import solver

    with debug_mode():
        return solver.solve_batch(robot, world, cfg, ops, Q0, QN, noise_fn,
                                  **kw)
