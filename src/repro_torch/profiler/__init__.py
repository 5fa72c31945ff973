"""Dynamic profiler subsystem: close the hint→compile→dispatch loop.

The paper's front-end is driven by type hints that "can be supplied by the
programmer or obtained by dynamic profiler tools" (§1, §4.1). This package
is the second half of that sentence:

  * :mod:`tracer` — low-overhead call-site recorder for *unhinted*
    functions (dtype, rank, shape buckets, call counts, latency);
  * :mod:`hints` — folds observed signatures into the ``'ndarray[f64,2]'``
    hint strings the front-end already consumes, widening shapes into a
    legality-ordered set of guarded tiers (exact → power-of-two bucket →
    rank-only);
  * :mod:`cache` — persistent on-disk variant store keyed by
    ``(source hash, type signature, backend)``; a warm process skips
    parse → SCoP → schedule → codegen entirely;
  * :mod:`specializer` — background thread that watches dispatch stats,
    promotes hot call sites to shape-specialized fast paths, and hot-swaps
    them into the decision tree (original-function fallback preserved).

Entry points live on :func:`repro_torch.core.compiler.optimize`
(``optimize(profile=True)`` / ``optimize.from_trace``).
"""

from .tracer import ArgObservation, CallRecord, FunctionTrace, Tracer, trace
from .hints import HintTier, synthesize_hints, synthesize_hint_tiers
from .cache import VariantCache, CacheStats, cache_key, source_hash
from .specializer import Specialization, Specializer

__all__ = [
    "ArgObservation", "CallRecord", "FunctionTrace", "Tracer", "trace",
    "HintTier", "synthesize_hints", "synthesize_hint_tiers",
    "VariantCache", "CacheStats", "cache_key", "source_hash",
    "Specialization", "Specializer",
]
