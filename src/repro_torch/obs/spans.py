"""Low-overhead span recorder: the tracing half of the obs plane.

Design constraints:

  * tracing is OFF by default — every entry point is a cheap flag check
    and the :func:`span` context manager degrades to a shared no-op, so
    serving loops pay nothing when dark;
  * a **bounded ring buffer** holds the events (a serving loop tracing
    forever must not grow head memory);
  * spans can cross threads: :func:`begin` returns a token that any
    thread may :func:`end` (the cluster head begins a chunk's in-flight
    span on the dispatch thread and ends it on the receive thread);
  * events from *other processes* (workers) enter via
    :meth:`SpanRecorder.record_external` with a clock offset — the head
    aligns per-worker monotonic clocks onto its own timeline.

Timestamps are ``time.perf_counter()`` seconds (monotonic, per
process). The Chrome-trace exporter re-bases them to microseconds from
the earliest recorded event.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["SpanEvent", "SpanRecorder", "SpanToken"]

# Perfetto/chrome groups rows by (pid, tid). Head threads get small
# tids in registration order (main thread first); worker processes are
# offset so they sort below the head's threads on the same node row.
WORKER_TID_BASE = 100


class SpanEvent:
    """One completed span. Plain slots object — these are created on
    hot paths and held by the thousand in the ring."""

    __slots__ = ("name", "cat", "t0", "t1", "pid", "tid", "args")

    def __init__(self, name: str, cat: str, t0: float, t1: float,
                 pid: int, tid: int, args: Optional[Dict[str, Any]]):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.t1 = t1
        self.pid = pid
        self.tid = tid
        self.args = args

    @property
    def dur(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "cat": self.cat, "t0": self.t0,
                "t1": self.t1, "pid": self.pid, "tid": self.tid,
                "args": dict(self.args or {})}


class SpanToken:
    """Handle for a cross-thread span: created by ``begin`` on one
    thread, finished by ``end`` (possibly elsewhere). ``end`` is
    idempotent — a resubmitted task racing its own completion records
    the span once."""

    __slots__ = ("name", "cat", "t0", "tid", "args", "_done")

    def __init__(self, name: str, cat: str, t0: float, tid: int,
                 args: Optional[Dict[str, Any]]):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.tid = tid
        self.args = args
        self._done = False


class SpanRecorder:
    """Ring-buffered span store shared by one process."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = int(os.environ.get("REPRO_TRACE_CAPACITY",
                                          "65536"))
        self.capacity = max(16, capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dropped = 0          # events evicted by the ring bound
        self._tids: Dict[int, int] = {}       # thread ident → small tid
        self._tid_names: Dict[Tuple[int, int], str] = {}  # (pid,tid)→name
        self._pid_names: Dict[int, str] = {0: "node0"}

    # -- thread/track naming ------------------------------------------------
    def tid_for_current_thread(self) -> int:
        th = threading.current_thread()
        ident = th.ident or 0
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
                self._tid_names.setdefault((0, tid), f"head:{th.name}")
        return tid

    def name_track(self, pid: int, tid: int, name: str) -> None:
        with self._lock:
            self._tid_names[(pid, tid)] = name

    def name_node(self, pid: int, name: str) -> None:
        with self._lock:
            self._pid_names[pid] = name

    def track_names(self) -> Dict[Tuple[int, int], str]:
        with self._lock:
            return dict(self._tid_names)

    def node_names(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._pid_names)

    # -- recording ----------------------------------------------------------
    def record(self, name: str, cat: str, t0: float, t1: float,
               pid: int = 0, tid: Optional[int] = None,
               args: Optional[Dict[str, Any]] = None) -> None:
        if tid is None:
            tid = self.tid_for_current_thread()
        ev = SpanEvent(name, cat, t0, t1, pid, tid, args)
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(ev)

    def begin(self, name: str, cat: str,
              args: Optional[Dict[str, Any]] = None,
              tid: Optional[int] = None) -> SpanToken:
        if tid is None:
            tid = self.tid_for_current_thread()
        return SpanToken(name, cat, time.perf_counter(), tid, args)

    def end(self, token: Optional[SpanToken],
            extra: Optional[Dict[str, Any]] = None) -> None:
        if token is None or token._done:
            return
        token._done = True
        args = token.args
        if extra:
            args = dict(args or {})
            args.update(extra)
        self.record(token.name, token.cat, token.t0,
                    time.perf_counter(), tid=token.tid, args=args)

    def record_external(self, spans: Iterable[tuple], *, offset: float,
                        pid: int, tid: int,
                        base_args: Optional[Dict[str, Any]] = None
                        ) -> float:
        """Ingest spans measured on another process's monotonic clock.

        ``spans`` are ``(name, t0, t1[, args])`` tuples in the remote
        clock; ``offset`` maps remote → local time (``local = remote +
        offset``). Returns the total busy seconds ingested (consumers
        accumulate per-worker utilization from it)."""
        busy = 0.0
        for entry in spans:
            name, t0, t1 = entry[0], entry[1], entry[2]
            args = dict(entry[3]) if len(entry) > 3 and entry[3] else {}
            if base_args:
                args.update(base_args)
            self.record(name, "worker", t0 + offset, t1 + offset,
                        pid=pid, tid=tid, args=args or None)
            busy += max(0.0, t1 - t0)
        return busy

    # -- access -------------------------------------------------------------
    def events(self) -> List[SpanEvent]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0
