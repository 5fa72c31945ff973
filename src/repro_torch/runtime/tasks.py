"""raylite TaskRuntime: the Ray-analogue DAG runtime (paper §2.2).

    rt = TaskRuntime(workers=4)
    ref = rt.submit(fn, a, other_ref)     # returns immediately (future)
    val = rt.get(ref)                     # blocks; recovers lost objects

Properties reproduced from the paper:
  * tasks spawn asynchronously; the DAG builds without waiting for
    intermediate results ("hide the latency of task instantiation",
    "extract pipeline parallelism");
  * immutable object store → no barriers, no coherence traffic;
  * lineage replay recovers evicted objects (node failures);
  * speculative duplicates mitigate stragglers (no MPI-style barrier to
    stall on);
  * elastic worker pool (scale_to) — tasks never bind to a fixed world
    size.

``device`` says where a compiled kernel's pfor chunks compute
(:mod:`repro_torch.core.pfor`). The default ``"cuda"`` needs a CUDA
device, checked here: each chunk runs the body's torch twin, which
computes on the torch backend's bound device (:mod:`repro_torch.core.txp`,
a card). ``device="cpu"`` runs each chunk's numpy body in the host
thread, as the reference package's raylite does. A body with no torch
twin runs its numpy body either way; ``stats()["pfor_chunks"]`` counts
the chunks of each kind.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .executor import WorkItem, WorkerPool
from .lineage import LineageGraph, TaskRecord
from .store import ObjectLostError, ObjectRef, ObjectStore


@dataclass
class TaskState:
    record: TaskRecord
    submitted_s: float
    started_s: Optional[float] = None
    finished_s: Optional[float] = None
    attempts: int = 0
    speculated: bool = False
    error: Optional[BaseException] = None


class TaskFailedError(RuntimeError):
    pass


def _check_device(device: str) -> str:
    """``"cpu"`` only when asked for, else a CUDA device that must exist:
    never a silent fall back to the CPU."""
    if device == "cpu":
        return device
    if not str(device).startswith("cuda"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    import torch

    from repro_torch.core.txp import DeviceUnavailable

    if not torch.cuda.is_available():
        raise DeviceUnavailable(
            f"TaskRuntime(device={device!r}) runs pfor chunks on a CUDA "
            f"device and torch sees none; pass device='cpu' to run their "
            f"numpy bodies in host threads")
    return device


class TaskRuntime:
    def __init__(self, workers: int = 4, max_attempts: int = 3,
                 speculation: bool = True,
                 straggler_factor: float = 4.0,
                 straggler_min_s: float = 0.05,
                 device: str = "cuda"):
        self.device = _check_device(device)
        # pfor chunks submitted, by the body they run (core/pfor.py)
        self.pfor_chunks: Dict[str, int] = {"torch": 0, "np": 0}
        self.store = ObjectStore()
        self.lineage = LineageGraph(self.store)
        self.pool = WorkerPool(workers)
        self.max_attempts = max_attempts
        self._tasks: Dict[int, TaskState] = {}
        self._task_ids = itertools.count(1)
        self._lock = threading.Lock()
        self._durations: List[float] = []
        self.speculation = speculation
        self.straggler_factor = straggler_factor
        self.straggler_min_s = straggler_min_s
        self._monitor: Optional[threading.Thread] = None
        self._shutdown = threading.Event()
        # test hook: {fn_qualname: fail_first_n_attempts}
        self.failure_injections: Dict[str, int] = {}
        if speculation:
            self._monitor = threading.Thread(
                target=self._speculate_loop, daemon=True,
                name="raylite-speculation")
            self._monitor.start()

    # -- submission -------------------------------------------------------
    def submit(self, fn: Callable, *args, num_returns: int = 1,
               **kwargs) -> Any:
        tid = next(self._task_ids)
        out_refs = tuple(self.store.new_ref(tid, i)
                         for i in range(num_returns))
        rec = TaskRecord(tid, fn, args, kwargs, out_refs)
        self.lineage.record(rec)
        st = TaskState(rec, time.perf_counter())
        with self._lock:
            self._tasks[tid] = st
        self._schedule(st)
        return out_refs[0] if num_returns == 1 else list(out_refs)

    def put(self, value: Any) -> ObjectRef:
        return self.store.put_value(value)

    def _schedule(self, st: TaskState) -> None:
        self.pool.dispatch(WorkItem(st.record.task_id,
                                    lambda: self._execute(st)))

    # -- execution -----------------------------------------------------------
    def _execute(self, st: TaskState) -> None:
        rec = st.record
        if all(self.store.available(r) for r in rec.out_refs):
            return  # speculative duplicate lost the race — discard
        st.started_s = time.perf_counter()
        st.attempts += 1
        try:
            args = [self._resolve(a) for a in rec.args]
            kwargs = {k: self._resolve(v) for k, v in rec.kwargs.items()}
            inject = self.failure_injections.get(
                getattr(rec.fn, "__qualname__", ""), 0)
            if st.attempts <= inject:
                raise RuntimeError(
                    f"injected failure (attempt {st.attempts})")
            result = rec.fn(*args, **kwargs)
        except BaseException as exc:  # noqa: BLE001 — worker must survive
            st.error = exc
            if st.attempts < self.max_attempts:
                self._schedule(st)
            else:
                for r in rec.out_refs:
                    self.store.fulfill(r, _TaskError(exc))
            return
        st.error = None
        st.finished_s = time.perf_counter()
        with self._lock:
            self._durations.append(st.finished_s - st.started_s)
        outs = result if len(rec.out_refs) > 1 else (result,)
        for r, v in zip(rec.out_refs, outs):
            self.store.fulfill(r, v)

    def _resolve(self, v: Any) -> Any:
        if isinstance(v, ObjectRef):
            return self.get(v)
        return v

    # -- retrieval -----------------------------------------------------------
    def get(self, ref_or_refs, timeout: Optional[float] = 60.0):
        if isinstance(ref_or_refs, list):
            return [self.get(r, timeout) for r in ref_or_refs]
        ref: ObjectRef = ref_or_refs
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.store.wait(ref, 0.05):
                break
            # Not fulfilled: if the producing task already completed once,
            # the object was evicted (node loss) → lineage replay.
            rec = self.lineage.producer_of(ref)
            if rec is not None:
                st = self._tasks.get(rec.task_id)
                if (st is not None and st.finished_s is not None
                        and not self.store.available(ref)):
                    break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"timed out waiting for {ref}")
        try:
            val = self.store.get_local(ref)
        except ObjectLostError:
            val = self.lineage.reconstruct(ref)
        if isinstance(val, _TaskError):
            raise TaskFailedError(str(val.exc)) from val.exc
        return val

    def wait(self, refs: List[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None):
        """ray.wait analogue: (ready, pending)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        ready, pending = [], list(refs)
        while len(ready) < num_returns and pending:
            progressed = False
            for r in list(pending):
                if self.store.available(r):
                    ready.append(r)
                    pending.remove(r)
                    progressed = True
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() > deadline:
                break
            if not progressed:
                time.sleep(0.002)
        return ready, pending

    # -- fault injection / recovery ------------------------------------------
    def kill_worker_and_evict(self) -> int:
        """Simulate a node failure: stop one worker and evict everything it
        would have held locally (we evict the most recent objects)."""
        victim = self.pool.kill_worker()
        evicted = 0
        if victim is not None:
            self.pool.add_worker()  # replacement node joins
        return evicted

    def evict(self, ref: ObjectRef) -> None:
        self.store.evict(ref)

    # -- stragglers ------------------------------------------------------------
    def _speculate_loop(self) -> None:
        while not self._shutdown.wait(0.02):
            with self._lock:
                durs = sorted(self._durations[-64:])
                median = durs[len(durs) // 2] if durs else None
                running = [st for st in self._tasks.values()
                           if st.started_s is not None
                           and st.finished_s is None
                           and st.error is None
                           and not st.speculated]
            if median is None:
                continue
            limit = max(self.straggler_min_s,
                        self.straggler_factor * median)
            now = time.perf_counter()
            for st in running:
                if now - st.started_s > limit:
                    st.speculated = True
                    self._schedule(st)  # duplicate; first fulfill wins

    # -- elasticity ------------------------------------------------------------
    def scale_to(self, n: int) -> None:
        self.pool.scale_to(n)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            done = [st for st in self._tasks.values()
                    if st.finished_s is not None]
            spec = sum(1 for st in self._tasks.values() if st.speculated)
            retries = sum(max(0, st.attempts - 1)
                          for st in self._tasks.values())
        return {
            "tasks": len(self._tasks),
            "completed": len(done),
            "speculated": spec,
            "retries": retries,
            "lineage_replays": self.lineage.replays,
            "store_objects": self.store.size(),
            "workers": self.pool.size,
            "pfor_chunks": dict(self.pfor_chunks),
        }

    def shutdown(self) -> None:
        self._shutdown.set()
        self.pool.shutdown()


@dataclass
class _TaskError:
    exc: BaseException

    def __str__(self) -> str:
        return repr(self.exc)
