"""The evaluator's share of its roofline (K3, rollout_analytic) at one
trajectory a scenario, C = 1,024 and T = 102: lib.roofline.evaluator_pct."""

from benchmark.lib.roofline import evaluator_pct


def read(t):
    return evaluator_pct(t)
