"""Serving layer: the multi-tenant cluster serving plane
(:mod:`repro_torch.serve.cluster_engine`) for compiled kernels, with its
admission control and open-loop load generator.

The reference package's single-process LM engine (``engine.py``), its
request and KV-cache modules and ``ClusterLMEngine`` come with the LM
models; nothing exported here imports a model, so the package stays
importable on any process (cluster workers resolving shipped functions
by reference must import it cheaply).
"""

from .admission import AdmissionController, AdmissionError, TenantQuota
from .cluster_engine import BatchSpec, ClusterServeEngine, ServeTicket
from .loadgen import LoadResult, open_loop

__all__ = [
    "AdmissionController", "AdmissionError", "TenantQuota",
    "BatchSpec", "ClusterServeEngine", "ServeTicket", "LoadResult",
    "open_loop",
]
