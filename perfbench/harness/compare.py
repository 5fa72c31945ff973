"""The numbers the checks compare: gaps between the program's readings
and the reference's."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def worst_leaf(got: Dict[str, float], want: Dict[str, float],
               leaves: Optional[Iterable[str]] = None) -> float:
    """The largest gap between two norms of a leaf (the program's and
    the reference's), over the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    names = list(want if leaves is None else leaves)
    floor = statistics.median(want[k] for k in names)
    return max(abs(got[k] - want[k]) / max(want[k], floor) for k in names)


def moving(grad_raw: Dict[str, float], share: float = 1e-3):
    """The leaves whose gradient, in the reference, is not nought to
    rounding: at least ``share`` of the median leaf's."""
    floor = statistics.median(grad_raw.values())
    return [k for k, g in grad_raw.items() if g >= share * floor]
