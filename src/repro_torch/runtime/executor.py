"""Worker pool: the cluster stand-in.

Each Worker is a thread modelling one node-process. The pool is elastic
(workers can be added/removed live) and failure-injectable (a worker can be
"killed", which both stops the thread and evicts the objects it produced —
the combination the lineage module must recover from).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass
class WorkItem:
    task_id: int
    run: Callable[[], None]     # executes + fulfills; owns error handling


_POISON = object()


class Worker(threading.Thread):
    def __init__(self, pool: "WorkerPool", wid: int):
        super().__init__(name=f"raylite-worker-{wid}", daemon=True)
        self.pool = pool
        self.wid = wid
        self.alive = True
        self.killed = False
        self.current_task: Optional[int] = None
        self.produced: List[int] = []  # object ids this worker fulfilled

    def run(self) -> None:
        while self.alive:
            try:
                item = self.pool._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is _POISON:
                self.alive = False
                break
            if self.killed:
                # dead node: requeue for someone else
                self.pool._queue.put(item)
                break
            self.current_task = item.task_id
            try:
                item.run()
            finally:
                self.current_task = None
        self.pool._on_worker_exit(self)


class WorkerPool:
    def __init__(self, workers: int = 4):
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._workers: List[Worker] = []
        self._next_wid = 0
        self.scale_to(workers)

    # -- elasticity ------------------------------------------------------
    def scale_to(self, n: int) -> None:
        with self._lock:
            live = [w for w in self._workers if w.alive and not w.killed]
            delta = n - len(live)
        if delta > 0:
            for _ in range(delta):
                self.add_worker()
        elif delta < 0:
            for _ in range(-delta):
                self._queue.put(_POISON)

    def add_worker(self) -> Worker:
        with self._lock:
            w = Worker(self, self._next_wid)
            self._next_wid += 1
            self._workers.append(w)
        w.start()
        return w

    def _on_worker_exit(self, w: Worker) -> None:
        with self._lock:
            if w in self._workers:
                self._workers.remove(w)

    @property
    def size(self) -> int:
        with self._lock:
            return len([w for w in self._workers
                        if w.alive and not w.killed])

    def queue_depth(self) -> int:
        return self._queue.qsize()

    # -- failure injection -------------------------------------------------
    def kill_worker(self, wid: Optional[int] = None) -> Optional[Worker]:
        """Simulate a node failure: stop the worker; caller evicts its
        produced objects."""
        with self._lock:
            candidates = [w for w in self._workers
                          if w.alive and not w.killed]
            if not candidates:
                return None
            victim = candidates[0]
            if wid is not None:
                for w in candidates:
                    if w.wid == wid:
                        victim = w
                        break
            victim.killed = True
            victim.alive = False
            return victim

    # -- scheduling -------------------------------------------------------
    def dispatch(self, item: WorkItem) -> None:
        self._queue.put(item)

    def shutdown(self) -> None:
        with self._lock:
            n = len(self._workers)
        for _ in range(n):
            self._queue.put(_POISON)
