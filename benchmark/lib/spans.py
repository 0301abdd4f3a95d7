"""The program's spans in a traced Window (lib/trace.py).

The program records its spans (benchmark/program/spans.py) while a
torch.profiler records, on the trace's clock (µs), so they sit on the same
time line as the Window's kernels and gaps. `inside` keeps the spans that
overlap the window; `split` cuts each idle gap of the device at every span
boundary inside it and gives each piece to the innermost span that covers
it (the latest-starting one), or to None where no span does; `in_stage`
adds up what fell to a named span or to any span it encloses. A span here
is anything with the program's span's name, id, parent, ts, end (µs) and
end_ns (None while open). Each reader gives None where the program
recorded no span in the window (or none at all, or dropped some).
"""

from __future__ import annotations

import bisect
import heapq


def inside(window, spans: list | None) -> list | None:
    """The ended spans that overlap [window.t0, window.t1], or None when
    there are none (or no spans were recorded)."""
    found = [s for s in spans or () if s.end_ns is not None
             and s.end > window.t0 and s.ts < window.t1]
    return found or None


def split(gaps: list, spans: list) -> dict:
    """{span or None: µs}: each gap (start, end), ascending and disjoint,
    cut at every span boundary inside it, each piece given to the
    innermost span covering it (None: no span covers it). Exact: the
    pieces of a gap add up to it."""
    points = sorted({p for s in spans for p in (s.ts, s.end)})
    order = sorted(spans, key=lambda s: s.ts)
    out, active, k = {}, [], 0
    for a, b in gaps:
        cuts = points[bisect.bisect_right(points, a):
                      bisect.bisect_left(points, b)]
        edges = [a, *cuts, b]
        for lo, hi in zip(edges, edges[1:]):
            if hi <= lo:
                continue
            mid = (lo + hi) / 2       # coverage is constant on (lo, hi)
            while k < len(order) and order[k].ts <= mid:
                heapq.heappush(active, (-order[k].ts, order[k].end, k,
                                        order[k]))
                k += 1
            while active and active[0][3].end <= mid:
                heapq.heappop(active)     # ended: never covers again
            owner = active[0][3] if active else None
            out[owner] = out.get(owner, 0.0) + (hi - lo)
    return out


def in_stage(pieces: dict, spans: list, name: str) -> float:
    """µs of `pieces` (split's) that fell to a span named `name` or to
    any span it encloses."""
    by_id = {s.id: s for s in spans}

    def within(s) -> bool:
        while s is not None:
            if s.name == name:
                return True
            s = by_id.get(s.parent)
        return False

    return sum(us for s, us in pieces.items() if s is not None
               and within(s))


def idle_in(window, spans: list | None, name: str) -> float | None:
    """Device-idle µs of the window while the host was in a span named
    `name` (or one it encloses); None without spans in the window."""
    found = inside(window, spans)
    if found is None:
        return None
    return in_stage(split(window.gaps(), found), found, name)

