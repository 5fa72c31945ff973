"""Chrome-trace / Perfetto JSON export.

Emits the classic ``{"traceEvents": [...]}`` array format (loadable in
``chrome://tracing`` and https://ui.perfetto.dev): one complete-``X``
event per recorded span plus ``M`` metadata events naming the tracks.
Convention: **pid = node**, **tid = worker / head thread** —
head threads occupy small tids, worker processes sit at
``100 + wid`` on the node that hosts them, so one aligned timeline
shows head phases above the per-chunk worker spans they dispatched.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from .spans import SpanRecorder

__all__ = ["chrome_trace_events", "export_chrome_trace"]


def chrome_trace_events(rec: SpanRecorder) -> List[Dict[str, Any]]:
    events = rec.events()
    out: List[Dict[str, Any]] = []
    for pid, name in sorted(rec.node_names().items()):
        out.append({"ph": "M", "name": "process_name", "pid": pid,
                    "tid": 0, "args": {"name": name}})
    for (pid, tid), name in sorted(rec.track_names().items()):
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": name}})
        # sort_index keeps head threads above workers within a node
        out.append({"ph": "M", "name": "thread_sort_index", "pid": pid,
                    "tid": tid, "args": {"sort_index": tid}})
    if not events:
        return out
    epoch = min(ev.t0 for ev in events)
    for ev in events:
        entry: Dict[str, Any] = {
            "ph": "X", "name": ev.name, "cat": ev.cat,
            "ts": round((ev.t0 - epoch) * 1e6, 3),
            "dur": round(ev.dur * 1e6, 3),
            "pid": ev.pid, "tid": ev.tid,
        }
        if ev.args:
            entry["args"] = ev.args
        out.append(entry)
    return out


def export_chrome_trace(rec: SpanRecorder, path: str,
                        extra_meta: Dict[str, Any] = None) -> str:
    doc: Dict[str, Any] = {
        "traceEvents": chrome_trace_events(rec),
        "displayTimeUnit": "ms",
    }
    meta = {"recorder_capacity": rec.capacity, "dropped": rec.dropped}
    if extra_meta:
        meta.update(extra_meta)
    doc["otherData"] = meta
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
