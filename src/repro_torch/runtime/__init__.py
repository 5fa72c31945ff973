"""raylite — the Ray-analogue distributed runtime (paper §2.2).

Public API mirrors the Ray calls the paper's generated code uses:

    from repro_torch.runtime import TaskRuntime
    rt = TaskRuntime(workers=8)
    ref = rt.submit(fn, *args)      # ray.remote(fn).remote(*args)
    rt.get(ref)                     # ray.get
    rt.wait(refs, num_returns=1)    # ray.wait

raylite is the paper's in-process runtime: its workers are host threads.
A compiled kernel's pfor chunks run there as the body's torch twin on the
card (``TaskRuntime(device="cuda")``, the default), or as its numpy body
when the caller asks for the CPU (``device="cpu"``); see
:mod:`repro_torch.core.pfor`. The multi-process fleet is
:class:`repro_torch.distrib.ClusterRuntime`.
"""

from .elastic import ElasticController, ElasticPolicy
from .lineage import LineageGraph, LineagePoisonedError
from .store import ObjectLostError, ObjectRef, ObjectStore
from .tasks import TaskFailedError, TaskRuntime

__all__ = [
    "ElasticController", "ElasticPolicy", "LineageGraph",
    "LineagePoisonedError", "ObjectLostError", "ObjectRef", "ObjectStore",
    "TaskFailedError", "TaskRuntime",
]
