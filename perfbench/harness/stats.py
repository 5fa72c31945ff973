"""Percentiles and rates over a window, taken over every sample."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, interpolated
    linearly between the order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        return math.nan
    at = (len(xs) - 1) * q / 100.0
    lo = math.floor(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


def rate(count: float, seconds: float) -> float:
    """``count`` over ``seconds``; nan for an empty window."""
    return count / seconds if seconds > 0 else math.nan
