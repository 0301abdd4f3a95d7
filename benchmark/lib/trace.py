"""A profiler window over the enclosed work, read back from its trace.

`record(label)` wraps work in torch.profiler (CPU and CUDA activity) and a
`label` annotation that ends after a device synchronize, exports the trace
into a temporary directory under TMPDIR and parses it into a `Window`:
the annotation's span, the device's kernels and copies and the host's
CUDA runtime and driver calls inside it (microseconds, the profiler's
clock). The busy time is the union of the device intervals, so work on
two streams at once counts once.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

# runtime and driver calls that put work on the device
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                 "cudaMemcpyAsync", "cudaMemsetAsync")
HOST_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Event:
    name: str
    ts: float            # µs
    dur: float           # µs
    grid: tuple = ()

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclass
class Window:
    t0: float = 0.0
    t1: float = 0.0
    kernels: list = field(default_factory=list)
    copies: list = field(default_factory=list)
    host: list = field(default_factory=list)      # runtime / driver calls
    ops: list = field(default_factory=list)       # host operators

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy(self) -> list:
        """Merged device-busy intervals [(start, end)] inside the window."""
        spans = sorted((max(e.ts, self.t0), min(e.end, self.t1))
                       for e in self.kernels + self.copies)
        merged = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [tuple(m) for m in merged]

    def busy_seconds(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def idle_pct(self) -> float | None:
        if self.t1 <= self.t0 or not self.kernels:
            return None
        return 100.0 * (1.0 - self.busy_seconds() / self.seconds)

    def kernel_seconds(self) -> float:
        return sum(e.dur for e in self.kernels) / 1e6

    def launches(self) -> int:
        return sum(e.name in HOST_LAUNCHES for e in self.host)

    def gaps(self) -> list:
        """Idle intervals [(start, end)] of the device inside the window."""
        out, at = [], self.t0
        for a, b in self.busy():
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            out.append((at, self.t1))
        return out

    def idle_by_host(self, top: int = 10) -> list:
        """[[what the host was doing, idle seconds]], the largest first: each
        idle gap of the device goes to the innermost runtime call running
        at its midpoint, else to the innermost host operator, else to
        "host_python" (the host was in neither)."""
        gaps = self.gaps()
        mids = [(a + b) / 2 for a, b in gaps]
        names = [_innermost(self.host, mids), _innermost(self.ops, mids)]
        totals = {}
        for i, (a, b) in enumerate(gaps):
            name = names[0][i] or names[1][i] or "host_python"
            totals[name] = totals.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(totals.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def kernel_totals(self, top: int = 10, width: int = 120) -> list:
        """[[kernel name, device seconds]], the largest first."""
        totals = {}
        for e in self.kernels:
            key = e.name[:width]
            totals[key] = totals.get(key, 0.0) + e.dur / 1e6
        return [[k, v] for k, v in sorted(totals.items(),
                                          key=lambda kv: -kv[1])[:top]]


def _innermost(events: list, times: list) -> list:
    """For each of the ascending `times`, the name of the latest-starting
    event running then, or None: one sweep."""
    events = sorted(events, key=lambda e: e.ts)
    out, active, k = [], [], 0
    for t in times:
        while k < len(events) and events[k].ts <= t:
            active.append(events[k])
            k += 1
        active = [e for e in active if e.end >= t]
        out.append(active[-1].name if active else None)
    return out


def parse(trace: dict, label: str) -> Window:
    """The Window of a Chrome trace from torch.profiler whose work ran
    inside a `label` user annotation."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    spans = [e for e in events if e.get("name") == label
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise ValueError(f"{len(spans)} '{label}' annotations in the trace")
    w = Window(t0=float(spans[0]["ts"]),
               t1=float(spans[0]["ts"]) + float(spans[0]["dur"]))
    for e in events:
        cat = e.get("cat")
        ev = Event(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0)),
                   tuple(e.get("args", {}).get("grid", ())))
        if ev.end <= w.t0 or ev.ts >= w.t1:
            continue
        if cat == "kernel":
            w.kernels.append(ev)
        elif cat in ("gpu_memcpy", "gpu_memset"):
            w.copies.append(ev)
        elif cat in HOST_CATS:
            w.host.append(ev)
        elif cat == "cpu_op":
            w.ops.append(ev)
    w.kernels.sort(key=lambda e: e.ts)
    return w


@contextlib.contextmanager
def record(label: str):
    """with record("window") as out: work(); then out["window"] is the
    Window (after the block)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    out = {}
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=activities) as prof:
            with record_function(label):
                yield out
                if cuda:
                    torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["window"] = parse(json.load(f), label)
