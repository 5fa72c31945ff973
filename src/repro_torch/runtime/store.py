"""Immutable object store with globally-addressable ObjectRefs.

Reproduces the Ray properties the paper relies on (§2.2):
  * objects are immutable — "elides the need for expensive consistency
    protocols, state coherence protocols, and other synchronization";
  * every object is addressable by an ObjectRef (the paper's ObjectID);
  * objects may be *evicted* (simulating node loss); the lineage module
    reconstructs them by replaying the producing sub-graph.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class ObjectRef:
    """Future-like handle to an object in the store (paper: ObjectID)."""

    id: int
    task_id: Optional[int] = None   # producing task (lineage edge)
    index: int = 0                  # position among the task's outputs

    def __repr__(self) -> str:
        return f"ObjectRef(id={self.id}, task={self.task_id})"


class ObjectLostError(RuntimeError):
    pass


class ObjectStore:
    """In-memory immutable store. Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[int, Any] = {}
        self._events: Dict[int, threading.Event] = {}
        self._ids = itertools.count(1)
        self.puts = 0
        self.evictions = 0

    def new_ref(self, task_id: Optional[int] = None,
                index: int = 0) -> ObjectRef:
        with self._lock:
            ref = ObjectRef(next(self._ids), task_id, index)
            self._events[ref.id] = threading.Event()
            return ref

    def put_value(self, value: Any) -> ObjectRef:
        """Directly place a value (no producing task → not recoverable)."""
        ref = self.new_ref()
        self.fulfill(ref, value)
        return ref

    def fulfill(self, ref: ObjectRef, value: Any) -> None:
        with self._lock:
            if ref.id in self._data:
                # immutability: double-fulfill must carry the same object;
                # replays after eviction are allowed to re-store.
                pass
            self._data[ref.id] = value
            ev = self._events.setdefault(ref.id, threading.Event())
            self.puts += 1
        ev.set()

    def available(self, ref: ObjectRef) -> bool:
        with self._lock:
            return ref.id in self._data

    def wait(self, ref: ObjectRef, timeout: Optional[float] = None) -> bool:
        ev = self._events.get(ref.id)
        if ev is None:
            return False
        return ev.wait(timeout)

    def get_local(self, ref: ObjectRef) -> Any:
        """Fetch without recovery; raises if evicted/never produced."""
        with self._lock:
            if ref.id not in self._data:
                raise ObjectLostError(f"{ref} not in store")
            return self._data[ref.id]

    def evict(self, ref: ObjectRef) -> None:
        """Simulate object loss (node failure)."""
        with self._lock:
            if ref.id in self._data:
                del self._data[ref.id]
                self._events[ref.id] = threading.Event()
                self.evictions += 1

    def size(self) -> int:
        with self._lock:
            return len(self._data)
