"""repro_torch.obs — distributed tracing + unified metrics plane.

One import point for the whole instrument panel:

    from repro_torch import obs

    obs.enable()                        # or REPRO_TRACE=1 / optimize(trace=True)
    with obs.span("gather", cat="pfor", round=3):
        ...
    tok = obs.begin("chunk_inflight", cat="pfor", tid=...)  # cross-thread
    obs.end(tok)                        # any thread, idempotent

    obs.metrics.scope("cluster0").inc("blob_hits")
    obs.export_chrome_trace("trace.json")     # Perfetto-loadable
    # python -m repro_torch.obs.summarize trace.json  → text breakdown

Tracing is **off by default**: ``span``/``begin``/``end`` cost one flag
check when dark (a shared no-op context manager, no allocation). The
metrics registry is always live — it is the single backing store behind
``ClusterRuntime.stats()``, ``CompiledKernel.stats()`` and
``ServeEngine.telemetry()`` — because counters are how those surfaces
already work; only the *timeline* recording is gated.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

from . import chrome as _chrome
from .metrics import MetricAttr, registry as metrics  # noqa: F401
from .spans import WORKER_TID_BASE, SpanRecorder, SpanToken  # noqa: F401

__all__ = ["enabled", "enable", "disable", "span", "begin", "end",
           "recorder", "export_chrome_trace", "metrics", "MetricAttr",
           "worker_tid", "WORKER_TID_BASE"]

_enabled = os.environ.get("REPRO_TRACE", "") not in ("", "0", "false")
_recorder = SpanRecorder()


def enabled() -> bool:
    return _enabled


def enable(capacity: Optional[int] = None) -> None:
    """Turn span recording on (idempotent). ``capacity`` resizes the
    ring buffer (only when it changes — enabling mid-run never drops
    what was already recorded)."""
    global _enabled, _recorder
    if capacity is not None and capacity != _recorder.capacity:
        _recorder = SpanRecorder(capacity)
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def recorder() -> SpanRecorder:
    return _recorder


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "t0")

    def __init__(self, name: str, cat: str, args: Optional[Dict]):
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _recorder.record(self.name, self.cat, self.t0,
                         time.perf_counter(), args=self.args)
        return False


def span(name: str, cat: str = "app", **args: Any):
    """Context manager recording one span on the current thread.
    A no-op singleton when tracing is off."""
    if not _enabled:
        return _NULL
    return _Span(name, cat, args or None)


def begin(name: str, cat: str = "app",
          **args: Any) -> Optional[SpanToken]:
    """Start a cross-thread span; returns a token (or None when
    tracing is off) that any thread passes to :func:`end`."""
    if not _enabled:
        return None
    return _recorder.begin(name, cat, args or None)


def end(token: Optional[SpanToken],
        **extra: Any) -> None:
    if token is None:
        return
    _recorder.end(token, extra or None)


def worker_tid(wid: int) -> int:
    """Track id for worker ``wid`` on its node (head threads keep the
    small tids)."""
    return WORKER_TID_BASE + wid


def export_chrome_trace(path: str,
                        extra_meta: Optional[Dict[str, Any]] = None
                        ) -> str:
    """Write the recorded spans as Perfetto/chrome://tracing JSON."""
    return _chrome.export_chrome_trace(_recorder, path, extra_meta)
