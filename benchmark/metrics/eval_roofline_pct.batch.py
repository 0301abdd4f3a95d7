"""The evaluator's share of its roofline (K3, rollout_analytic) at the
cell's shape: lib.roofline.evaluator_pct."""

from benchmark.lib.roofline import evaluator_pct


def read(t):
    return evaluator_pct(t)
