"""Window statistics: a rate is all the work of the window over all its
time; a tail is the nearest-rank percentile of every request; a spread is
the distance between the quartiles (``statistics.quantiles``, n=4) over
the median."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def rate(work: float, seconds: float) -> float:
    return work / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least ``q``% of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def spread(values: Sequence[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
