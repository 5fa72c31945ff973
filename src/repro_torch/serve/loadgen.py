"""Open-loop Poisson load generator for the serving plane.

Closed-loop drivers (issue → wait → issue) hide saturation: the
arrival rate collapses to whatever the server sustains and tail
latency looks flat. The open-loop generator submits on a fixed
Poisson schedule regardless of completions — the standard
serving-benchmark discipline — so queueing delay and admission
rejections show up in the percentiles instead of being absorbed by
the driver.

The generator is engine-agnostic: it drives any ``submit(i, tenant)``
callable that returns a ticket exposing ``wait(timeout)`` plus
``submitted_s`` / ``finished_s`` stamps (duck-typed against
:class:`repro_torch.serve.cluster_engine.ServeTicket`), and treats
:class:`repro_torch.serve.admission.AdmissionError` as a counted rejection,
not a failure.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .admission import AdmissionError

__all__ = ["LoadResult", "open_loop"]


def _pct(xs: List[float], q: float) -> Optional[float]:
    if not xs:
        return None
    return float(np.percentile(np.asarray(xs), q))


@dataclass
class LoadResult:
    offered: int = 0                  # requests the schedule issued
    completed: int = 0
    failed: int = 0                   # errored after admission
    rejected: int = 0                 # explicit admission rejections
    duration_s: float = 0.0
    offered_rps: float = 0.0
    throughput_rps: float = 0.0
    e2e_ms: Dict[str, float] = field(default_factory=dict)
    queue_ms: Dict[str, float] = field(default_factory=dict)
    per_tenant: Dict[str, Dict[str, int]] = field(default_factory=dict)
    reject_reasons: Dict[str, int] = field(default_factory=dict)

    def as_row(self) -> Dict[str, object]:
        return {
            "offered": self.offered, "completed": self.completed,
            "failed": self.failed, "rejected": self.rejected,
            "duration_s": round(self.duration_s, 6),
            "offered_rps": round(self.offered_rps, 3),
            "throughput_rps": round(self.throughput_rps, 3),
            "e2e_ms": self.e2e_ms, "queue_ms": self.queue_ms,
            "per_tenant": self.per_tenant,
            "reject_reasons": self.reject_reasons,
        }


def open_loop(submit: Callable[[int, str], object], *, requests: int,
              rate_rps: float, tenants: Sequence[str] = ("tenant-a",),
              seed: int = 0, wait_timeout_s: float = 120.0) -> LoadResult:
    """Drive ``submit`` with Poisson arrivals at ``rate_rps``.

    Inter-arrival gaps are exponential (pre-drawn from ``seed`` so a
    coalesced and a naive run see the *same* schedule); tenants are
    assigned round-robin. Submission never blocks on a previous
    request; after the schedule drains, every accepted ticket is
    awaited and the percentiles are computed from its stamps."""
    if rate_rps <= 0:
        raise ValueError("rate_rps must be > 0 for an open-loop run")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=requests)
    res = LoadResult(offered=requests)
    tickets: List[tuple] = []   # (tenant, ticket)

    t_start = time.perf_counter()
    due = t_start
    for i in range(requests):
        due += float(gaps[i])
        delay = due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        tenant = tenants[i % len(tenants)]
        per = res.per_tenant.setdefault(
            tenant, {"requests": 0, "completed": 0, "rejected": 0})
        per["requests"] += 1
        try:
            tickets.append((tenant, submit(i, tenant)))
        except AdmissionError as e:
            res.rejected += 1
            per["rejected"] += 1
            res.reject_reasons[e.reason] = \
                res.reject_reasons.get(e.reason, 0) + 1

    e2e, queue = [], []
    for tenant, tk in tickets:
        per = res.per_tenant[tenant]
        try:
            tk.wait(wait_timeout_s)
        except Exception:
            res.failed += 1
            continue
        res.completed += 1
        per["completed"] += 1
        if tk.finished_s is not None:
            e2e.append((tk.finished_s - tk.submitted_s) * 1e3)
        if getattr(tk, "started_s", None) is not None:
            queue.append((tk.started_s - tk.submitted_s) * 1e3)
    res.duration_s = time.perf_counter() - t_start
    res.offered_rps = requests / res.duration_s if res.duration_s else 0.0
    res.throughput_rps = (res.completed / res.duration_s
                          if res.duration_s else 0.0)
    for name, xs in (("e2e_ms", e2e), ("queue_ms", queue)):
        if xs:
            getattr(res, name).update(
                {"p50": round(_pct(xs, 50), 3),
                 "p95": round(_pct(xs, 95), 3),
                 "p99": round(_pct(xs, 99), 3),
                 "mean": round(float(np.mean(xs)), 3)})
    return res
