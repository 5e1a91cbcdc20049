"""Statistics the readers share."""

from __future__ import annotations

import math
import statistics


def mean(values) -> float | None:
    values = list(values)
    return statistics.fmean(values) if values else None


def percentile(values, q: float) -> float | None:
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest value
    with at least q% of the values at or below it."""
    values = sorted(values)
    if not values:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(values)))
    return values[rank - 1]
