"""pfor execution: the generated `__pfor_run` hook.

Generated kernels call ``__pfor_run(body, lo, hi, tile)`` where ``body(lo,
hi)`` executes a contiguous chunk of dependence-free iterations, writing
disjoint regions of the output arrays in place.

Backends (a profitability decision, §4.3):
  * sequential      — one call; chosen for small iteration counts;
  * raylite DAG     — chunks submitted as tasks to the runtime/ package
    (the Ray analogue): futures, lineage fault tolerance, straggler
    duplicates all apply. On a card runtime (``TaskRuntime(device=
    "cuda")``, the default) each task runs the body's torch twin on the
    torch backend's bound device, which must then be a card; on
    ``device="cpu"`` it runs the numpy body;
  * cluster shards  — when the bound runtime is a
    :class:`repro_torch.distrib.ClusterRuntime` (it exposes ``pfor_shards``),
    chunks cross OS-process boundaries: the body closure ships to worker
    processes, chunk sizes follow measured device capability, and
    disjoint-region writes gather back on the head. The local-vs-
    distributed call is made per kernel from the fleet's device profiles
    (:func:`repro_torch.core.cost.cluster_distribute_profitable`).

The SPMD (shard_map) mapping of regular pfor loops lives in the LM planner
(core/planner.py) — numeric kernels distribute via the DAG or the cluster
runtime, matching the paper's Ray deployment.
"""

from __future__ import annotations

import inspect
import math
from typing import Callable, Optional, Tuple


class PforConfig:
    """Mutable knob block bound into each compiled kernel."""

    def __init__(self, runtime=None, tile: Optional[int] = None,
                 workers: int = 4, force_sequential: bool = False):
        self.runtime = runtime          # TaskRuntime | ClusterRuntime | None
        self.tile = tile
        self.workers = workers
        self.force_sequential = force_sequential
        # filled per call by the dispatcher (profitability input):
        self.estimated_flops = 0.0
        self.distribute_threshold = 1e7
        # arrays the schedule writes (set by the compiler) — lets the
        # cluster runtime diff only real outputs when gathering chunks
        self.written: Tuple[str, ...] = ()
        # arrays provably indexed only by the pfor var on their leading
        # axis (union over the kernel's pfor units, set by the compiler).
        # Fallback only: freshly generated bodies carry their own exact
        # per-unit ``__sliceable__`` attribute, which always wins; this
        # covers variants cached before the attribute existed (their
        # schedules predate the analysis too, so it stays empty — safe).
        self.sliceable: Tuple[str, ...] = ()
        # memoized signature probes for the bound runtime (legacy duck-
        # typed runtimes may predate the broadcast/sliced protocol):
        # (runtime object, decide accepts sliced_bytes, shards accepts
        # sliceable, shards accepts est_flops) — re-probed only when the
        # runtime is swapped. The memo holds the probed object itself,
        # never a raw id(): address reuse after a swap must not
        # resurrect a stale verdict.
        self._proto_probe: Tuple[object, bool, bool, bool] = (
            None, True, True, True)

    def _runtime_proto(self, shards) -> Tuple[bool, bool, bool]:
        """(decide takes sliced_bytes, pfor_shards takes sliceable,
        pfor_shards takes est_flops) for the current runtime, probed
        once per binding — not per call."""
        if self._proto_probe[0] is not self.runtime:
            def accepts(fn, kw):
                if fn is None:
                    return True
                try:
                    return kw in inspect.signature(fn).parameters
                except (TypeError, ValueError):
                    return True
            decide = getattr(self.runtime, "distribute_profitable", None)
            self._proto_probe = (self.runtime,
                                 accepts(decide, "sliced_bytes"),
                                 accepts(shards, "sliceable"),
                                 accepts(shards, "est_flops"))
        return self._proto_probe[1:]

    def make_runner(self) -> Callable:
        def __pfor_run(body, lo, hi, tile):
            n = max(0, hi - lo)
            if n == 0:
                return
            tile_ = tile or self.tile
            if tile_ is None:
                tile_ = max(1, math.ceil(n / max(1, self.workers)))
            if self.force_sequential or self.runtime is None or n <= 1:
                body(lo, hi)
                return
            shards = getattr(self.runtime, "pfor_shards", None)
            if shards is not None:
                # a cluster runtime instance exists, so repro_torch.distrib is
                # already imported — the shared sizing rule is free here
                from repro_torch.distrib.serial import payload_split_nbytes

                sliceable = getattr(body, "__sliceable__", None)
                if sliceable is None:
                    sliceable = self.sliceable
                # legacy duck-typed runtimes may predate the broadcast/
                # sliced protocol: signature-probe once per runtime
                # binding rather than catching TypeError per call (which
                # would also swallow genuine errors inside the model)
                split_ok, shards_sliceable, shards_flops = \
                    self._runtime_proto(shards)
                sliceable = tuple(sliceable) if shards_sliceable else ()
                # cluster tier: ask the device-profile cost model unless
                # the caller forced distribution (threshold <= 0)
                distribute = self.distribute_threshold <= 0
                if not distribute:
                    decide = getattr(self.runtime,
                                     "distribute_profitable", None)
                    if decide is not None:
                        bcast, sliced = payload_split_nbytes(
                            body, sliceable)
                        if split_ok:
                            distribute = decide(
                                self.estimated_flops, bcast,
                                max(1, math.ceil(n / tile_)),
                                sliced_bytes=sliced)
                        else:
                            distribute = decide(
                                self.estimated_flops, bcast + sliced,
                                max(1, math.ceil(n / tile_)))
                    else:
                        distribute = (self.estimated_flops
                                      >= self.distribute_threshold)
                if distribute:
                    kw = {"written": self.written}
                    if shards_sliceable:
                        kw["sliceable"] = sliceable
                    if shards_flops:
                        # the dispatcher's kernel-level FLOP estimate:
                        # the sharder prices per-(unit, backend, worker)
                        # cells from it when the body carries a jnp twin
                        kw["est_flops"] = self.estimated_flops
                    shards(body, lo, hi, tile or self.tile, **kw)
                else:
                    body(lo, hi)
                return
            if self.estimated_flops < self.distribute_threshold:
                body(lo, hi)
                return
            run, kind = self._raylite_body(body)
            futures = []
            t = lo
            while t < hi:
                up = min(t + tile_, hi)
                futures.append(self.runtime.submit(run, t, up))
                t = up
            counts = getattr(self.runtime, "pfor_chunks", None)
            if counts is not None:
                counts[kind] += len(futures)
            for f in futures:
                self.runtime.get(f)

        return __pfor_run

    def _raylite_body(self, body) -> Tuple[Callable, str]:
        """The body a raylite task runs, and its kind: the torch twin on
        a card runtime, else (a ``device="cpu"`` runtime, or a body with
        no twin) the numpy body."""
        twin = None
        if getattr(self.runtime, "device", "cpu") != "cpu":
            twin = getattr(body, "__torch__", None)
        if twin is None:
            return body, "np"
        from . import txp

        bound = txp.device()
        if bound.type != "cuda":
            raise ValueError(
                f"the runtime computes pfor chunks on "
                f"{self.runtime.device!r}, but the torch backend is bound "
                f"to {str(bound)!r}; bind a CUDA device with "
                f"txp.set_device, or make the runtime with device='cpu'")
        return twin, "torch"
