"""The evaluator's share of its roofline (K3-pcw,
rollout_analytic:per_cand_world) at the cell's shape:
lib.roofline.evaluator_pct."""

from benchmark.lib.roofline import evaluator_pct


def read(t):
    return evaluator_pct(t)
