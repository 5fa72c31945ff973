"""Dynamic tracer: observe call-site signatures of unhinted kernels.

The paper's pipeline needs per-parameter (dtype, rank) facts before it can
compile anything; when the programmer has not written hints, this module
harvests them from live calls. Each traced call records the runtime
:class:`~repro_torch.core.types.TypeInfo` of every argument plus its concrete
shape, and per-call wall latency — enough for hint synthesis
(:mod:`repro_torch.profiler.hints`) and for the specializer's hot-call-site
promotion.

Overhead discipline: after ``full_sample`` calls with an already-seen
signature, per-call recording degrades to a counter bump (signature key
lookup only, no new allocation), so tracing a hot loop stays cheap.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.types import (TypeInfo, nested_list_shape,
                              runtime_typeinfo)


@dataclass(frozen=True)
class ArgObservation:
    """One argument position as observed at runtime."""

    name: str
    kind: str                      # 'scalar' | 'array' | 'list' | 'unknown'
    dtype: Optional[str]
    rank: int
    shape: Tuple[int, ...]         # () for scalars
    # concrete value of integer scalars (structure parameters like N drive
    # the cost model, so distinct values are distinct signatures and the
    # profitability calibrator can recover per-call problem sizes)
    ivalue: Optional[int] = None

    @staticmethod
    def of(name: str, value: Any) -> "ArgObservation":
        ti = runtime_typeinfo(value)
        shape: Tuple[int, ...] = ()
        ivalue: Optional[int] = None
        if isinstance(value, np.ndarray):
            shape = tuple(int(s) for s in value.shape)
        elif hasattr(value, "shape") and not isinstance(value, (int, float)):
            try:
                shape = tuple(int(s) for s in value.shape)
            except Exception:
                shape = ()
        elif isinstance(value, list):
            shape = nested_list_shape(value)
        elif isinstance(value, (int, np.integer)) and not isinstance(
                value, bool):
            ivalue = int(value)
        return ArgObservation(name, ti.kind, ti.dtype, ti.rank, shape,
                              ivalue)

    def signature(self) -> Tuple:
        return (self.name, self.kind, self.dtype, self.rank, self.shape,
                self.ivalue)


@dataclass
class CallRecord:
    """Aggregate stats for one distinct call signature."""

    args: Tuple[ArgObservation, ...]
    calls: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.calls if self.calls else 0.0

    def observe(self, dt: float) -> None:
        self.calls += 1
        self.total_s += dt
        if dt < self.min_s:
            self.min_s = dt
        if dt > self.max_s:
            self.max_s = dt


@dataclass
class FunctionTrace:
    """Everything the tracer learned about one function."""

    fn_name: str
    param_names: List[str]
    records: Dict[Tuple, CallRecord] = field(default_factory=dict)
    calls: int = 0
    total_s: float = 0.0

    @property
    def signatures(self) -> List[CallRecord]:
        """Records ordered hottest-first (by call count, then total time)."""
        return sorted(self.records.values(),
                      key=lambda r: (-r.calls, -r.total_s))

    @property
    def dominant(self) -> Optional[CallRecord]:
        sigs = self.signatures
        return sigs[0] if sigs else None

    def observations_by_param(self) -> Dict[str, List[ArgObservation]]:
        out: Dict[str, List[ArgObservation]] = {n: [] for n in
                                                self.param_names}
        for rec in self.records.values():
            for ob in rec.args:
                out.setdefault(ob.name, []).append(ob)
        return out


class Tracer:
    """Records call signatures for any number of functions.

    Use as a decorator factory::

        tr = Tracer()

        @tr.wrap
        def kernel(a, b, n): ...

    or as a context manager that forces recording on for the block and
    restores the previous recording state on exit (traces persist — the
    context form just scopes *recording*)::

        tr.pause()
        with tr:                 # recording on inside the block
            kernel(x, y, 8)
        # recording paused again here

    """

    def __init__(self, full_sample: int = 32):
        self.full_sample = full_sample
        self.traces: Dict[str, FunctionTrace] = {}
        self._owners: Dict[str, Callable] = {}   # key → underlying fn
        self._lock = threading.Lock()
        self._recording = True
        self._recording_stack: List[bool] = []

    # -- recording control ----------------------------------------------
    def pause(self) -> None:
        self._recording = False

    def resume(self) -> None:
        self._recording = True

    def __enter__(self) -> "Tracer":
        self._recording_stack.append(self._recording)
        self._recording = True
        return self

    def __exit__(self, *exc) -> None:
        self._recording = self._recording_stack.pop() \
            if self._recording_stack else True

    # -- wrapping -------------------------------------------------------
    @staticmethod
    def _key(fn: Callable) -> str:
        """Registry key: module-qualified so two same-named functions in
        different modules/classes never share a trace."""
        mod = getattr(fn, "__module__", None) or "?"
        qual = getattr(fn, "__qualname__", None) \
            or getattr(fn, "__name__", repr(fn))
        return f"{mod}.{qual}"

    def wrap(self, fn: Callable) -> Callable:
        import functools
        import inspect

        name = getattr(fn, "__name__", repr(fn))
        try:
            param_names = [p for p in inspect.signature(fn).parameters]
        except (TypeError, ValueError):
            param_names = []
        with self._lock:
            key = self._key(fn)
            owner = self._owners.get(key)
            if owner is not None and owner is not fn:
                # distinct function object under the same qualname (e.g.
                # closures minted in a loop): never share a trace
                key = f"{key}#{id(fn):x}"
            self._owners[key] = fn
            tr = self.traces.setdefault(key, FunctionTrace(name,
                                                           param_names))

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not self._recording:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            self._record(tr, args, kwargs, dt)
            return out

        wrapper.__trace__ = tr  # type: ignore[attr-defined]
        wrapper.__wrapped_fn__ = fn  # type: ignore[attr-defined]
        return wrapper

    __call__ = wrap

    def _record(self, tr: FunctionTrace, args, kwargs, dt: float) -> None:
        obs = []
        names = tr.param_names or [f"arg{i}" for i in range(len(args))]
        for n, v in zip(names, args):
            obs.append(ArgObservation.of(n, v))
        for k, v in kwargs.items():
            obs.append(ArgObservation.of(k, v))
        key = tuple(o.signature() for o in obs)
        with self._lock:
            rec = tr.records.get(key)
            if rec is None:
                rec = CallRecord(args=tuple(obs))
                tr.records[key] = rec
            rec.observe(dt)
            tr.calls += 1
            tr.total_s += dt

    # -- queries --------------------------------------------------------
    def trace_of(self, fn_or_name) -> FunctionTrace:
        if callable(fn_or_name):
            tr = getattr(fn_or_name, "__trace__", None)
            if tr is not None:
                return tr
            for key, owner in self._owners.items():   # identity first
                if owner is fn_or_name:
                    return self.traces[key]
            fn_or_name = self._key(fn_or_name)
        if fn_or_name in self.traces:
            return self.traces[fn_or_name]
        # bare-name lookup: accept iff unambiguous
        matches = [t for k, t in self.traces.items()
                   if k == fn_or_name or k.endswith("." + fn_or_name)]
        if len(matches) == 1:
            return matches[0]
        if not matches:
            raise KeyError(fn_or_name)
        raise KeyError(f"{fn_or_name!r} is ambiguous: "
                       f"{len(matches)} traced functions share the name")

    def report(self) -> str:
        lines = ["Tracer report:"]
        for name, tr in self.traces.items():
            lines.append(f"  {name}: {tr.calls} calls, "
                         f"{len(tr.records)} distinct signatures, "
                         f"{tr.total_s:.4f}s total")
            for rec in tr.signatures[:5]:
                sig = ", ".join(
                    f"{o.name}:{o.kind}[{o.dtype},{o.rank}]{list(o.shape)}"
                    for o in rec.args)
                lines.append(f"    {rec.calls}× mean={rec.mean_s:.6f}s  "
                             f"({sig})")
        return "\n".join(lines)


# Module-level convenience tracer (what ``optimize(profile=True)`` uses
# when the caller does not pass its own).
_default_tracer = Tracer()


def trace(fn: Optional[Callable] = None, *, tracer: Optional[Tracer] = None):
    """``@trace`` decorator using the module default tracer."""
    t = tracer or _default_tracer
    if fn is not None:
        return t.wrap(fn)
    return t.wrap


def default_tracer() -> Tracer:
    return _default_tracer
