"""Multi-process cluster runtime (the paper's Ray deployment tier, §4.3).

raylite (:mod:`repro_torch.runtime`) models a cluster with threads inside
one process; this package crosses real OS-process boundaries:

  * a **head** scheduler (:class:`ClusterRuntime`) spawns worker
    *processes* and talks to them over pipes or — with
    ``transport="tcp"`` — authenticated sockets workers can join from
    any host (:mod:`.transport`: authkey handshake + rotation,
    reconnect with exponential backoff, heartbeats, elastic
    join/drain); :mod:`.chaos` injects deterministic faults into all
    of it;
  * each worker measures a **device profile** at startup (CPU count,
    memory, matmul GFLOP/s, memory bandwidth, GPU presence) that feeds a
    **placement-aware scheduler** with data-locality affinity;
  * a serialized **object plane**: results live where they were produced
    (ObjectRef ownership), move on demand, and survive worker-process
    death via lineage replay;
  * ``pfor`` loops compiled by :func:`repro_torch.core.compiler.optimize`
    shard dependence-free chunks across workers — chunk sizes
    proportional to measured capability — with disjoint-region writes
    gathered on the head.

    from repro_torch.distrib import ClusterRuntime
    rt = ClusterRuntime(workers=4)
    ck = compile_kernel(stap_kernel, runtime=rt)   # pfor → processes
    ref = rt.submit(fn, *args)                     # or raw DAG tasks
    rt.get(ref)
"""

from .chaos import ChaosPlan, ChaosWire
from .cluster import ClusterRuntime, ClusterTaskError
from .device import DeviceProfile, measure_profile
from .objects import ClusterRef, ObjectMeta, ObjectPlane, TaskSpec
from .placement import PlacementScheduler, PlacementWeights, WorkerView
from .serial import (ChunkSlice, ClosureParts, assemble_fn, dumps_fn,
                     loads_fn, payload_split_nbytes, rebase_chunk,
                     split_fn)
from .transport import (HeadListener, PipeLink, ReconnectingClient,
                        WorkerFencedError, new_authkey)

__all__ = [
    "ChaosPlan", "ChaosWire", "ChunkSlice", "ClosureParts",
    "ClusterRuntime", "ClusterTaskError", "ClusterRef", "DeviceProfile",
    "HeadListener", "ObjectMeta", "ObjectPlane", "PipeLink",
    "PlacementScheduler", "PlacementWeights", "ReconnectingClient",
    "TaskSpec", "WorkerFencedError", "WorkerView", "assemble_fn",
    "dumps_fn", "loads_fn", "measure_profile", "new_authkey",
    "payload_split_nbytes", "rebase_chunk", "split_fn",
]
