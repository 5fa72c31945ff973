"""Admission control for the multi-tenant serving plane.

Every request entering :class:`repro_torch.serve.cluster_engine.ClusterServeEngine`
passes through one :class:`AdmissionController` before it may occupy
queue space: a global bounded queue (backpressure toward the load
balancer, not unbounded memory growth on the head) plus per-tenant
quotas — a max-in-flight cap and a token-bucket rate budget. Rejection
is **explicit** (an :class:`AdmissionError` carrying a machine-readable
reason) and **counted** per tenant, so a saturated fleet degrades into
measured 429s instead of latency collapse.

The controller is pure bookkeeping — no threads, no cluster handle —
and takes an injectable monotonic ``clock`` so quota math unit-tests
without sleeping.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

__all__ = ["TenantQuota", "AdmissionError", "AdmissionController"]

# rejection reasons (stable strings: they key telemetry dicts)
REASON_QUEUE_FULL = "queue_full"
REASON_INFLIGHT = "quota_inflight"
REASON_RATE = "rate"


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission budget.

    ``max_inflight`` bounds requests admitted but not yet finished;
    ``rate_per_s`` is a token-bucket refill rate (``inf`` = unmetered)
    with ``burst`` tokens of headroom (defaults to ``rate_per_s`` so a
    one-second burst is always admissible, min 1)."""

    max_inflight: int = 8
    rate_per_s: float = math.inf
    burst: Optional[float] = None

    def burst_tokens(self) -> float:
        if self.burst is not None:
            return max(1.0, float(self.burst))
        if math.isinf(self.rate_per_s):
            return math.inf
        return max(1.0, float(self.rate_per_s))


class AdmissionError(RuntimeError):
    """Explicit rejection: ``reason`` is one of ``queue_full`` /
    ``quota_inflight`` / ``rate``."""

    def __init__(self, tenant: str, reason: str, detail: str = ""):
        self.tenant = tenant
        self.reason = reason
        msg = f"request rejected for tenant {tenant!r}: {reason}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


class _Bucket:
    __slots__ = ("tokens", "stamp")

    def __init__(self, tokens: float, stamp: float):
        self.tokens = tokens
        self.stamp = stamp


class AdmissionController:
    """Bounded queue + per-tenant quotas with explicit, counted
    rejection.

    ``admit(tenant)`` either raises :class:`AdmissionError` or records
    one in-flight request; the engine must pair every successful admit
    with exactly one ``release(tenant)`` when the request finishes
    (success or failure). ``queued`` is tracked here too so the global
    bound covers admitted-but-not-yet-dispatched requests.
    """

    def __init__(self, quotas: Optional[Dict[str, TenantQuota]] = None,
                 *, default: TenantQuota = TenantQuota(),
                 max_queue: int = 64,
                 clock: Callable[[], float] = time.monotonic):
        self.quotas = dict(quotas or {})
        self.default = default
        self.max_queue = max_queue
        self.clock = clock
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {}
        self._buckets: Dict[str, _Bucket] = {}
        self.queued = 0
        # telemetry: {tenant: count} / {tenant: {reason: count}}
        self.admitted: Dict[str, int] = {}
        self.rejected: Dict[str, Dict[str, int]] = {}

    def quota_for(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self.default)

    def _reject(self, tenant: str, reason: str, detail: str = ""):
        by = self.rejected.setdefault(tenant, {})
        by[reason] = by.get(reason, 0) + 1
        raise AdmissionError(tenant, reason, detail)

    def admit(self, tenant: str) -> None:
        """Admit one request for ``tenant`` or raise
        :class:`AdmissionError`. On success the request counts as both
        queued and in-flight until :meth:`release`."""
        q = self.quota_for(tenant)
        with self._lock:
            if self.queued >= self.max_queue:
                self._reject(tenant, REASON_QUEUE_FULL,
                             f"{self.queued}/{self.max_queue} queued")
            inflight = self._inflight.get(tenant, 0)
            if inflight >= q.max_inflight:
                self._reject(tenant, REASON_INFLIGHT,
                             f"{inflight}/{q.max_inflight} in flight")
            if not math.isinf(q.rate_per_s):
                now = self.clock()
                b = self._buckets.get(tenant)
                if b is None:
                    b = _Bucket(q.burst_tokens(), now)
                    self._buckets[tenant] = b
                b.tokens = min(q.burst_tokens(),
                               b.tokens + (now - b.stamp) * q.rate_per_s)
                b.stamp = now
                if b.tokens < 1.0:
                    self._reject(tenant, REASON_RATE,
                                 f"{q.rate_per_s}/s budget exhausted")
                b.tokens -= 1.0
            self._inflight[tenant] = inflight + 1
            self.queued += 1
            self.admitted[tenant] = self.admitted.get(tenant, 0) + 1

    def dequeued(self) -> None:
        """A request left the queue for execution (still in-flight)."""
        with self._lock:
            self.queued = max(0, self.queued - 1)

    def release(self, tenant: str) -> None:
        """A request finished (fulfilled or failed after admission)."""
        with self._lock:
            n = self._inflight.get(tenant, 0)
            if n > 0:
                self._inflight[tenant] = n - 1

    def inflight(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is not None:
                return self._inflight.get(tenant, 0)
            return sum(self._inflight.values())

    def telemetry(self) -> Dict[str, object]:
        with self._lock:
            return {
                "queued": self.queued,
                "max_queue": self.max_queue,
                "inflight": dict(self._inflight),
                "admitted": dict(self.admitted),
                "rejected": {t: dict(r) for t, r in self.rejected.items()},
            }
