"""The p90 (nearest rank) of an MPC tick's device ms over the traced
episode's ticks: the CUDA events of each `mpc.tick` span, around its
enter, chunk and leave replays on the stream: engine.mpc."""

from benchmark.lib import spans, stats
from benchmark.program.spans import recorded


def read(t):
    ms = [s.device_ms for s in spans.inside(t["window"], recorded()) or ()
          if s.name == "mpc.tick"]
    if not ms or None in ms:
        return None
    return stats.percentile(ms, 0.90)
