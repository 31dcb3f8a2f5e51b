"""Percentiles in which a miss counts, and the spread of repeated runs.

The reference's report (``loadgen/report.py``) drops failed requests from
its percentiles; here a request that failed, was shed or had no first
token by the drain limit is +inf, so it sits at the top of the order.
"""

from __future__ import annotations

import math
import statistics


def percentile(values: list, p: float) -> float:
    """Linear interpolation between closest ranks (numpy's default); any
    +inf at or above the rank gives +inf. NaN for no values."""
    if not values:
        return math.nan
    xs = sorted(values)
    r = (len(xs) - 1) * p / 100.0
    lo, hi = math.floor(r), math.ceil(r)
    if math.isinf(xs[hi]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)


def spread(values: list) -> float:
    """Distance between the first and third quartile as a share of the
    median (Python's ``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
