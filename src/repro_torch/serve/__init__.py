"""Serving layer: single-process continuous batching over the port's LM
models (:mod:`repro_torch.serve.engine`, with :mod:`.request` and
:mod:`.kvcache`) and the multi-tenant cluster serving plane
(:mod:`repro_torch.serve.cluster_engine`): compiled kernels behind
:class:`ClusterServeEngine`, and the LM with its state on a worker behind
:class:`ClusterLMEngine` (the worker's side is
:mod:`repro_torch.serve.remote_lm`), with admission control and an
open-loop load generator.

The reference package leaves :class:`ServeEngine` out of this package's
exports because its module imports jax; the port's imports torch, which
every process of the port loads anyway, so it is exported here.
"""

from .admission import AdmissionController, AdmissionError, TenantQuota
from .cluster_engine import (BatchSpec, ClusterLMEngine,
                             ClusterServeEngine, LMTicket, ServeTicket)
from .engine import ServeEngine
from .loadgen import LoadResult, open_loop
from .request import Request

__all__ = [
    "AdmissionController", "AdmissionError", "TenantQuota",
    "BatchSpec", "ClusterServeEngine", "ClusterLMEngine", "ServeTicket",
    "LMTicket", "LoadResult", "open_loop", "Request", "ServeEngine",
]
