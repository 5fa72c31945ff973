"""The device trace of a stretch of the window, reduced in memory.

``torch.profiler`` records the device's kernels, copies and sets, and
the host's CUDA runtime calls, over a stretch the caller opens and
closes (each end synchronised). Host ops are not recorded: recording
every op's event slowed a served tick several times over, which would
make the trace measure its own overhead. The benchmark's own spans
around its calls into the program (:meth:`DeviceTrace.span`) are kept
by the harness on the host's clock and placed on the trace's.

The reduction keeps: the stretch's length, the device's busy seconds
(the union of its operations' intervals), each kernel's count and
seconds by name, the operations that took most time, and the idle gaps
summed by what the host was doing as each began (the benchmark's span
around it, and the runtime call under way or ``host code`` between
calls). Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Tuple

#: gaps shorter than this, or past the LABELLED longest, are summed
#: under one label
LABEL_MIN_NS = 20_000
LABELLED = 2000
TOP = 10


def short(name: str) -> str:
    """A kernel's name without its argument list (a demangled name's
    last parenthesised group) and without ``void``."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    if name.startswith("void "):
        name = name[5:]
    return name.strip()[:160]


Row = Tuple[str, bool, int, int]     # name, on the device, start, end (ns)


class DeviceTrace:
    """One traced stretch: :meth:`start`, :meth:`stop`, then
    :meth:`summary` (after the window: reducing takes seconds)."""

    def __init__(self, torch):
        self.torch = torch
        self._prof = None
        self._offset = 0
        self.active = False
        self.bounds: Tuple[int, int] = (0, 0)
        self.spans: List[Tuple[str, int, int]] = []
        self.rows: List[Row] = []

    def _now(self) -> int:
        """The host's clock on the trace's (epoch ns)."""
        return time.perf_counter_ns() + self._offset

    def warm(self) -> None:
        """Start and stop the profiler once (set-up: its first start
        takes seconds)."""
        self.start()
        self.stop()
        self.rows, self.spans = [], []

    def start(self) -> None:
        torch = self.torch
        torch.cuda.synchronize()
        self._offset = time.time_ns() - time.perf_counter_ns()
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.active = True
        self.bounds = (self._now(), 0)

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.bounds = (self.bounds[0], self._now())
        self.active = False
        self._prof.__exit__(None, None, None)
        self.rows = [(e.name(), "CUDA" in str(e.device_type())
                      and not e.is_user_annotation(), e.start_ns(),
                      e.start_ns() + e.duration_ns())
                     for e in self._prof.profiler.kineto_results.events()]
        self._prof = None

    @contextlib.contextmanager
    def span(self, name: str):
        """The benchmark's span around a call into the program (kept
        while the stretch is traced)."""
        if not self.active:
            yield
            return
        t0 = self._now()
        try:
            yield
        finally:
            self.spans.append((name, t0, self._now()))

    def summary(self) -> Dict:
        return reduce_rows(self.rows, self.spans, self.bounds)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _covering(starts, rows, t: int, reach: int = 64) -> str:
    """The latest-starting (name, start, end) row that covers ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - reach), -1):
        name, s, e = rows[j]
        if e >= t:
            return name
    return ""


def reduce_rows(rows: List[Row], spans, bounds) -> Dict:
    """The stretch's reduction (see the module's docstring)."""
    if not rows:
        return {}
    w0 = min([bounds[0]] + [s for _, _, s, _ in rows])
    w1 = max([bounds[1]] + [e for _, _, _, e in rows])
    dev = [(s, e, name) for name, on_dev, s, e in rows if on_dev]
    busy = _union([(s, e) for s, e, _ in dev if e > s])
    kernels: Dict[str, List[float]] = {}
    for s, e, name in dev:
        k = kernels.setdefault(short(name), [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-9
    calls = sorted(((n, s, e) for n, on_dev, s, e in rows if not on_dev),
                   key=lambda r: r[1])
    call_starts = [r[1] for r in calls]
    ours = sorted(spans, key=lambda r: r[1])
    our_starts = [r[1] for r in ours]
    gaps, at = [], w0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if w1 > at:
        gaps.append((at, w1))
    idle: Dict[str, float] = {}
    gaps.sort(key=lambda g: g[0] - g[1])
    for i, (s, e) in enumerate(gaps):
        if e - s < LABEL_MIN_NS or i >= LABELLED:
            label = "shorter gaps"
        else:
            span = _covering(our_starts, ours, s) or "outside spans"
            call = _covering(call_starts, calls, s) or "host code"
            label = f"{span}/{call}"
        idle[label] = idle.get(label, 0.0) + (e - s) * 1e-9
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    top_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9,
            "kernels": kernels,
            "device_ops": [[n, v[1]] for n, v in top_ops],
            "idle_gaps": [[n, v] for n, v in top_gaps]}


def kernel_time(summary: Dict, fragments) -> Tuple[int, float]:
    """(launches, seconds) of the kernels whose name holds one of
    ``fragments``."""
    n, secs = 0, 0.0
    for name, (count, s) in summary.get("kernels", {}).items():
        if any(f in name for f in fragments):
            n += count
            secs += s
    return n, secs
