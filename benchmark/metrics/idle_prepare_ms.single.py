"""Device-idle ms a plan call while the host was in `plan.prepare` (the
checks, the query's device copies, the goal band): the traced window's
idle gaps split over the program's spans (lib.spans), per call:
api.plan."""

from benchmark.lib import spans
from benchmark.program.spans import recorded


def read(t):
    us = spans.idle_in(t["window"], recorded(), "plan.prepare")
    calls = t["counts"].get("calls")
    return us / 1e3 / calls if us is not None and calls else None
