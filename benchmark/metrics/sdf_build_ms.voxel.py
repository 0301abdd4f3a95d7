"""Host ms of a field's build (the program's `world.sdf` span: both EDT
passes and the packed corner table), the mean over the spans window of
the traced run (the field built once more, spans on, no profiler): the
world-build layer, paid in set-up. None where the program records no such
span."""

from benchmark.lib import spans
from benchmark.program.spans import recorded


def read(t):
    window = t.get("spans")
    ms = [(s.end - s.ts) / 1e3
          for s in (spans.inside(window, recorded()) or ()
                    if window is not None else ())
          if s.name == "world.sdf"]
    return sum(ms) / len(ms) if ms else None
