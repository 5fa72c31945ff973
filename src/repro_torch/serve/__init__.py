"""Serving layer: single-process continuous batching over the port's LM
models (:mod:`repro_torch.serve.engine`, with :mod:`.request` and
:mod:`.kvcache`) and the multi-tenant cluster serving plane
(:mod:`repro_torch.serve.cluster_engine`) for compiled kernels, with its
admission control and open-loop load generator.

The reference package leaves :class:`ServeEngine` out of this package's
exports because its module imports jax; the port's imports torch, which
every process of the port loads anyway, so it is exported here. The
reference's ``ClusterLMEngine`` (and ``remote_lm``) is not ported yet.
"""

from .admission import AdmissionController, AdmissionError, TenantQuota
from .cluster_engine import BatchSpec, ClusterServeEngine, ServeTicket
from .engine import ServeEngine
from .loadgen import LoadResult, open_loop
from .request import Request

__all__ = [
    "AdmissionController", "AdmissionError", "TenantQuota",
    "BatchSpec", "ClusterServeEngine", "ServeTicket", "LoadResult",
    "open_loop", "Request", "ServeEngine",
]
