"""Percentiles of a window's latencies and spreads of a cell's runs."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The nearest-rank q-quantile (0 < q <= 1): the smallest value with at
    least q of the values at or below it. Infinite values (answers that
    never came right) sort last and may be the result."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(1, math.ceil(q * len(s))) - 1]


def spread(values) -> float:
    """(third quartile - first quartile) / median, with the quartiles of
    statistics.quantiles(values, n=4)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
