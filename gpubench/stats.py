"""Percentiles and spreads, as the benchmark's metrics and bounds use them."""

from __future__ import annotations

import math
import statistics

__all__ = ["percentile", "spread"]


def percentile(values, p: float) -> float:
    """The nearest-rank ``p``-th percentile (0 < p <= 100): the smallest
    value with at least p % of the sample at or below it. Every value it
    returns is a measured one, so a tail is never interpolated away."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of an empty sample")
    if not 0 < p <= 100:
        raise ValueError(f"p must lie in (0, 100], got {p}")
    return xs[max(0, math.ceil(p / 100 * len(xs)) - 1)]


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median, with ``statistics.quantiles(values, n=4)``'s quartiles."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
