"""The comparison that decides ``correct``: each number against its
limit from ``limits/<cell>.json`` (a number passes at or under it)."""

from __future__ import annotations

import math
from typing import Dict, Tuple


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number within its limit, {name: {value, limit}}). A number
    that is missing or not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        good = (value is not None and math.isfinite(value)
                and value <= limit)
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out


def lines(checks: Dict[str, Dict[str, float]]) -> str:
    return "\n".join(f"check {name} {c['value']!r} limit {c['limit']!r}"
                     for name, c in checks.items())
