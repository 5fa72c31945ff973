"""Placement-aware scheduling over measured device profiles.

Score = capability + data locality − load, the three signals the paper's
Ray deployment gets from Ray's scheduler and we compute explicitly:

  * **capability** — the worker's measured GFLOP/s normalized across the
    fleet, plus a bonus when the task prefers a GPU and the worker has
    one, minus a penalty when the task prefers a CPU and the worker's
    GPU would sit idle under it (heterogeneous placement: jnp-body pfor
    chunks carry ``device_pref="gpu"``, their np twins ``"cpu"``, so a
    mixed fleet runs each body where it prices cheapest);
  * **locality** — the fraction of the task's input bytes already
    resident in the worker's object cache (results live where they were
    produced, so chained tasks gravitate to their producers);
  * **load** — outstanding tasks on the worker (queue-depth pressure).

The scheduler is deliberately stateless over ``WorkerView`` snapshots so
it unit-tests without any processes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .device import DeviceProfile
from .objects import TaskSpec


@dataclass
class WorkerView:
    """Scheduler-visible snapshot of one worker."""

    wid: int
    profile: DeviceProfile
    outstanding: int = 0
    resident: Dict[int, int] = field(default_factory=dict)  # oid → bytes


@dataclass(frozen=True)
class PlacementWeights:
    capability: float = 1.0
    locality: float = 2.0       # moving bytes beats moving flops
    load: float = 0.5
    gpu_bonus: float = 4.0
    # keep np-body chunks off GPU-capable workers (whose cycles the
    # hetero sharder already budgeted for jnp chunks); soft, so a
    # CPU-less fleet still runs everything
    cpu_pref_penalty: float = 2.0
    # stick a chunk to the worker its range was *sized for*
    # (proportional_chunks paired range i with view i's throughput);
    # soft — load pressure or a death still moves it elsewhere
    affinity: float = 2.0


class PlacementScheduler:
    def __init__(self, weights: PlacementWeights = PlacementWeights()):
        self.weights = weights

    def score(self, task: TaskSpec, view: WorkerView,
              max_gflops: float, arg_bytes: Dict[int, int]) -> float:
        w = self.weights
        cap = (view.profile.gflops / max_gflops) if max_gflops > 0 else 0.0
        s = w.capability * cap
        if task.device_pref == "gpu" and view.profile.has_gpu:
            s += w.gpu_bonus
        elif task.device_pref == "cpu" and view.profile.has_gpu:
            s -= w.cpu_pref_penalty
        if getattr(task, "pref_wid", None) == view.wid:
            s += w.affinity
        total = sum(arg_bytes.values())
        if total > 0:
            local = sum(nb for oid, nb in arg_bytes.items()
                        if oid in view.resident)
            s += w.locality * (local / total)
        s -= w.load * view.outstanding
        return s

    def place(self, task: TaskSpec, views: Sequence[WorkerView],
              arg_bytes: Optional[Dict[int, int]] = None) -> int:
        """Pick a worker id for ``task``; ties break to the lowest wid so
        placement is deterministic for tests."""
        if not views:
            raise RuntimeError("no live workers to place on")
        arg_bytes = arg_bytes or {}
        max_gflops = max(v.profile.gflops for v in views)
        best_wid, best_score = None, None
        for v in sorted(views, key=lambda v: v.wid):
            sc = self.score(task, v, max_gflops, arg_bytes)
            if best_score is None or sc > best_score:
                best_wid, best_score = v.wid, sc
        return best_wid

    @staticmethod
    def proportional_chunks(lo: int, hi: int,
                            weights: Sequence[float],
                            drop_empty: bool = True) -> List[range]:
        """Split [lo, hi) into one contiguous chunk per weight, sized
        proportional to the weights — the heterogeneous answer to equal
        tiling (a 2× faster worker gets a 2× larger chunk).

        ``drop_empty=False`` keeps zero-length ranges so the result
        stays index-aligned with ``weights`` — callers pairing chunks
        with per-worker metadata (e.g. the hetero sharder's
        backend-per-view table) need the alignment; a worker whose
        share rounds to zero must not shift every later chunk onto the
        wrong worker's backend."""
        n = hi - lo
        if n <= 0 or not weights:
            return []
        total = sum(max(1e-9, w) for w in weights)
        cuts, acc = [lo], 0.0
        for w in weights[:-1]:
            acc += max(1e-9, w)
            cuts.append(lo + int(round(n * acc / total)))
        cuts.append(hi)
        # enforce monotone non-overlapping cuts
        for i in range(1, len(cuts)):
            cuts[i] = min(hi, max(cuts[i], cuts[i - 1]))
        ranges = [range(cuts[i], cuts[i + 1])
                  for i in range(len(cuts) - 1)]
        if drop_empty:
            return [r for r in ranges if len(r) > 0]
        return ranges
