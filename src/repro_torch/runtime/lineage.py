"""Lineage-based fault tolerance (paper §2.2, after Lineage Stash [22]).

"Data store immutability, combined with the deterministic nature of the
task graph, enable fault tolerance, as any missing object in the graph can
be recomputed by simply replaying the sub-graph leading up to and including
the object's parent vertex."

The lineage graph maps every ObjectRef to the (pure, deterministic) task
that produced it; ``reconstruct`` replays the minimal sub-graph for a lost
object, re-fetching transitively-lost inputs first.

Robustness contract (shared with the cluster runtime's replay path):
replays are *budgeted* per object — an object whose producer keeps
failing (or whose storage keeps evaporating under it) is **poisoned**
with a named cause after ``max_replays`` attempts, and every dependent
that tries to reconstruct through it fails with that cause attached
instead of looping forever. Retry → replay lineage → poison dependents,
in that order.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .store import ObjectLostError, ObjectRef, ObjectStore


class LineagePoisonedError(ObjectLostError):
    """Reconstruction hit an object whose replay budget is exhausted
    (or that was explicitly poisoned); the message names the root
    cause so dependents fail forensically, not anonymously."""


@dataclass
class TaskRecord:
    task_id: int
    fn: Callable
    args: Tuple[Any, ...]        # values or ObjectRefs
    kwargs: Dict[str, Any]
    out_refs: Tuple[ObjectRef, ...]


class LineageGraph:
    def __init__(self, store: ObjectStore, max_replays: int = 8):
        self.store = store
        self.max_replays = max_replays   # per-object replay budget
        self._by_task: Dict[int, TaskRecord] = {}
        self._producer: Dict[int, int] = {}  # object id → task id
        self._replay_counts: Dict[int, int] = {}
        self._poisoned: Dict[int, str] = {}  # object id → named cause
        self._lock = threading.Lock()
        self.replays = 0
        self.poisons = 0

    def record(self, rec: TaskRecord) -> None:
        with self._lock:
            self._by_task[rec.task_id] = rec
            for ref in rec.out_refs:
                self._producer[ref.id] = rec.task_id

    def producer_of(self, ref: ObjectRef):
        with self._lock:
            tid = self._producer.get(ref.id)
            return self._by_task.get(tid) if tid is not None else None

    # -- poisoning ----------------------------------------------------------
    def poison(self, ref: ObjectRef, cause: str) -> None:
        """Mark an object unreconstructable with a named cause; every
        dependent reconstruction through it raises that cause."""
        with self._lock:
            if ref.id not in self._poisoned:
                self._poisoned[ref.id] = cause
                self.poisons += 1

    def poison_cause(self, ref: ObjectRef) -> Optional[str]:
        with self._lock:
            return self._poisoned.get(ref.id)

    def _charge_replay(self, ref: ObjectRef) -> None:
        """Spend one unit of the object's replay budget; poison it (and
        raise, naming the exhaustion) when the budget runs dry."""
        with self._lock:
            cause = self._poisoned.get(ref.id)
            if cause is None:
                n = self._replay_counts.get(ref.id, 0) + 1
                self._replay_counts[ref.id] = n
                if n <= self.max_replays:
                    self.replays += 1
                    return
                cause = (f"{ref} exceeded its replay budget "
                         f"({self.max_replays}) — storage or producer "
                         f"is failing repeatedly")
                self._poisoned[ref.id] = cause
                self.poisons += 1
        raise LineagePoisonedError(cause)

    # -- recovery -----------------------------------------------------------
    def reconstruct(self, ref: ObjectRef) -> Any:
        """Return the object's value, replaying producers as needed.

        Idempotent under concurrent eviction: the replayed value is
        returned *directly* from the task's own output, never re-read
        through the store — so an eviction racing the replay (a worker
        killed mid-replay re-evicting what we just fulfilled) cannot
        turn a successful recomputation into an ObjectLostError. A
        racing second replay of the same object is harmless: tasks are
        pure and deterministic, both produce the same value."""
        if self.store.available(ref):
            try:
                return self.store.get_local(ref)
            except ObjectLostError:
                pass  # evicted between the check and the read: replay
        cause = self.poison_cause(ref)
        if cause is not None:
            raise LineagePoisonedError(cause)
        rec = self.producer_of(ref)
        if rec is None:
            raise ObjectLostError(
                f"{ref} lost and has no lineage (direct put?)")
        args = [self.reconstruct(a) if isinstance(a, ObjectRef) else a
                for a in rec.args]
        kwargs = {k: (self.reconstruct(v) if isinstance(v, ObjectRef)
                      else v)
                  for k, v in rec.kwargs.items()}
        self._charge_replay(ref)
        result = rec.fn(*args, **kwargs)
        outs = result if len(rec.out_refs) > 1 else (result,)
        value = None
        for r, v in zip(rec.out_refs, outs):
            self.store.fulfill(r, v)
            if r.id == ref.id:
                value = v
        return value
