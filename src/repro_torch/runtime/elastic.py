"""Elastic autoscaling controller for the task runtimes.

Watches queue depth and resizes the fleet within
[min_workers, max_workers]. The same control loop drives both runtime
flavors, duck-typed on ``scale_to`` plus a size/depth probe:

  * :class:`repro_torch.runtime.tasks.TaskRuntime` — thread-backed pool
    (``rt.pool.size`` / ``rt.pool.queue_depth()``); scaling is instant.
  * :class:`repro_torch.distrib.cluster.ClusterRuntime` — real worker
    processes (``rt.workers_alive()`` / ``rt.queue_depth()``); growth
    spawns + profiles + pre-warms a worker, shrink marks one draining
    (it finishes in-flight work, hands objects back, then exits).

On real clusters this is the autoscaler requesting/releasing nodes;
here it exercises the same control loop against live fleets so
elasticity is a tested property of the runtimes, not an aspiration.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class ElasticPolicy:
    min_workers: int = 1
    max_workers: int = 16
    scale_up_queue_per_worker: float = 2.0   # queue/worker above → grow
    scale_down_idle_queue: int = 0           # queue at/below → shrink
    step: int = 2


class ElasticController:
    """Queue-depth autoscaler over any runtime exposing ``scale_to``.

    Size and depth are probed duck-typed: a thread-pool runtime exposes
    them on ``rt.pool``, the cluster runtime directly (a draining
    cluster worker no longer counts toward size, so the controller
    never double-shrinks a drain already in progress)."""

    def __init__(self, rt, policy: ElasticPolicy = None,
                 interval_s: float = 0.05,
                 depth_fn: Optional[Callable[[], int]] = None):
        self.rt = rt
        self.policy = policy or ElasticPolicy()
        self.interval_s = interval_s
        # external pressure signal (e.g. a serving engine's queue
        # depth) overriding the runtime's own task-queue probe — the
        # fleet scales with *request* backlog, not just tasks already
        # in flight
        self.depth_fn = depth_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.decisions: list = []

    def _size(self) -> int:
        pool = getattr(self.rt, "pool", None)
        if pool is not None:
            return int(pool.size)
        views = getattr(self.rt, "_views", None)
        if views is not None:
            # live, non-draining, attached workers — what placement
            # actually has to work with
            return len(views())
        return int(self.rt.workers_alive())

    def _depth(self) -> int:
        if self.depth_fn is not None:
            return int(self.depth_fn())
        pool = getattr(self.rt, "pool", None)
        if pool is not None:
            return int(pool.queue_depth())
        return int(self.rt.queue_depth())

    def tick(self) -> int:
        """One control-loop step; returns the new target size."""
        p = self.policy
        size = max(1, self._size())
        depth = self._depth()
        target = size
        if depth > p.scale_up_queue_per_worker * size:
            target = min(p.max_workers, size + p.step)
        elif depth <= p.scale_down_idle_queue and size > p.min_workers:
            target = max(p.min_workers, size - 1)
        if target != size:
            self.rt.scale_to(target)
            self.decisions.append((size, target, depth))
        return target

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                self.tick()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="raylite-elastic")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
