"""Device ms of a CHOMP iteration's gradient (the point Jacobians through
the J^T sum, and the smoothness gradient): the mean over the `chomp.grad`
spans of the traced run's spans window (per-iteration route, spans on, no
profiler), each timed by its CUDA events: engine.chomp. None where the
program records no such span."""

from benchmark.lib import spans
from benchmark.program.spans import recorded


def read(t):
    window = t.get("spans")
    ms = [s.device_ms for s in (spans.inside(window, recorded()) or ()
                                if window is not None else ())
          if s.name == "chomp.grad"]
    if not ms or None in ms:
        return None
    return sum(ms) / len(ms)
