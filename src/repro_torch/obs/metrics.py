"""Unified metrics registry: one process-wide store behind every
telemetry surface.

Before this module each subsystem kept its own ad-hoc counter dict —
``ClusterRuntime.stats()/telemetry()``, ``CompiledKernel.stats()``,
``ServeEngine.telemetry()`` — with no way to ask "everything, now" or
to alias a counter into a bench row. The registry is their **single
backing store**: the legacy attributes/keys still read and write the
same names (via registry-backed descriptors), so existing callers and
tests see identical values, while :func:`MetricsRegistry.snapshot`
exposes the union under stable dotted names
(``cluster0.phase.gather_s``, ``kernel.stap#1.spec_hits``, …).

Metric kinds:
  * :class:`Counter` — monotonically-ish increasing number (``inc``;
    ``set`` exists because legacy code assigns zeros / test fixtures
    reset counters);
  * :class:`Gauge` — last-write-wins value;
  * :class:`Histogram` — count/total/min/max plus a bounded reservoir
    for percentiles;
  * :class:`DictMetric` — a ``dict`` subclass registered under a name,
    for structured legacy telemetry (``unit_backend``,
    ``chunks_executed``) that must keep full mapping semantics.

All mutation goes through a single registry lock; these are telemetry
paths, not inner loops.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, Optional

__all__ = ["Counter", "Gauge", "Histogram", "DictMetric", "Scope",
           "MetricsRegistry", "registry"]

_LOCK = threading.Lock()


class Counter:
    __slots__ = ("value",)

    kind = "counter"

    def __init__(self, value: float = 0):
        self.value = value

    def inc(self, n: float = 1) -> None:
        with _LOCK:
            self.value += n

    def set(self, v: float) -> None:
        self.value = v

    def snapshot(self):
        return self.value


class Gauge:
    __slots__ = ("value",)

    kind = "gauge"

    def __init__(self, value: float = 0):
        self.value = value

    def set(self, v: float) -> None:
        self.value = v

    def snapshot(self):
        return self.value


class Histogram:
    """Bounded-reservoir histogram: exact count/total/min/max, recent
    window for percentiles."""

    kind = "histogram"

    def __init__(self, window: int = 512):
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._window: deque = deque(maxlen=window)

    def observe(self, v: float) -> None:
        with _LOCK:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self._window.append(v)

    def percentile(self, q: float) -> Optional[float]:
        with _LOCK:
            window = sorted(self._window)
        if not window:
            return None
        idx = min(len(window) - 1, int(q / 100.0 * len(window)))
        return window[idx]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self):
        return {"count": self.count, "total": round(self.total, 9),
                "mean": round(self.mean, 9), "min": self.min,
                "max": self.max, "p50": self.percentile(50),
                "p95": self.percentile(95), "p99": self.percentile(99)}


class DictMetric(dict):
    """A dict that *is* the registry entry — structured legacy
    telemetry keeps its mapping API while living in the store."""

    kind = "dict"

    def snapshot(self):
        return {k: (dict(v) if isinstance(v, dict) else v)
                for k, v in self.items()}


class Scope:
    """Namespace view over the registry (``prefix.name`` keys)."""

    def __init__(self, reg: "MetricsRegistry", prefix: str):
        self._reg = reg
        self.prefix = prefix

    def _full(self, name: str) -> str:
        return f"{self.prefix}.{name}" if self.prefix else name

    def counter(self, name: str) -> Counter:
        return self._reg._get_or_create(self._full(name), Counter)

    def gauge(self, name: str) -> Gauge:
        return self._reg._get_or_create(self._full(name), Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._reg._get_or_create(self._full(name), Histogram)

    def dictmetric(self, name: str) -> DictMetric:
        return self._reg._get_or_create(self._full(name), DictMetric)

    def __getitem__(self, name: str) -> Counter:
        return self.counter(name)

    def inc(self, name: str, n: float = 1) -> None:
        self.counter(name).inc(n)

    def add_time(self, name: str, seconds: float) -> None:
        """Accumulate a duration counter (``*_s`` convention)."""
        self.counter(name).inc(seconds)

    def sub(self, name: str) -> "Scope":
        return Scope(self._reg, self._full(name))

    def snapshot(self) -> Dict[str, Any]:
        return self._reg.snapshot(self.prefix)

    def reset(self) -> None:
        self._reg.reset(self.prefix)


class MetricsRegistry:
    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._seq: Dict[str, int] = {}

    def _get_or_create(self, full: str, cls: Callable):
        m = self._metrics.get(full)
        if m is None:
            with _LOCK:
                m = self._metrics.get(full)
                if m is None:
                    m = cls()
                    self._metrics[full] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {full!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def scope(self, prefix: str) -> Scope:
        return Scope(self, prefix)

    def unique_scope(self, kind: str) -> Scope:
        """``kind#N`` scope with a process-unique suffix — one per
        runtime/kernel/engine instance."""
        with _LOCK:
            n = self._seq.get(kind, 0)
            self._seq[kind] = n + 1
        return Scope(self, f"{kind}#{n}")

    def get(self, full: str):
        return self._metrics.get(full)

    def names(self, prefix: str = "") -> list:
        return sorted(k for k in self._metrics
                      if not prefix or k == prefix
                      or k.startswith(prefix + "."))

    def snapshot(self, prefix: str = "") -> Dict[str, Any]:
        """Flat ``{name: value}`` view. With ``prefix``, keys are
        relative to it (``cluster0.phase`` → ``{"gather_s": ...}``)."""
        out: Dict[str, Any] = {}
        for name in self.names(prefix):
            key = name[len(prefix) + 1:] if prefix else name
            out[key or name] = self._metrics[name].snapshot()
        return out

    def reset(self, prefix: str = "") -> None:
        """Zero counters/gauges and clear dicts under ``prefix``
        (metric objects stay registered — live references held by
        subsystems keep working)."""
        for name in self.names(prefix):
            m = self._metrics[name]
            if isinstance(m, (Counter, Gauge)):
                m.set(0)
            elif isinstance(m, DictMetric):
                m.clear()
            elif isinstance(m, Histogram):
                m.__init__(window=m._window.maxlen or 512)


registry = MetricsRegistry()


class MetricAttr:
    """Class descriptor exposing a scoped registry counter as a plain
    numeric attribute, so legacy ``self.blob_hits += 1`` call sites and
    ``rt.blob_hits`` readers keep working verbatim while the value
    lives in the registry. Instances normally set their ``_mscope`` in
    ``__init__``; an instance without one (e.g. built via ``__new__``
    in tests) gets a unique scope lazily on first access."""

    def __init__(self, name: str):
        self.name = name

    @staticmethod
    def _scope_of(obj) -> Scope:
        sc = getattr(obj, "_mscope", None)
        if sc is None:
            sc = registry.unique_scope(type(obj).__name__.lower())
            obj._mscope = sc
        return sc

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return self._scope_of(obj).counter(self.name).value

    def __set__(self, obj, value):
        self._scope_of(obj).counter(self.name).set(value)
