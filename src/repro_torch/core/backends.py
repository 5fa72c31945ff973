"""Pluggable backend registry of the port: one object per code-variant
target.

A :class:`Backend` owns everything that makes codegen, pricing,
serialization and the cluster backend-aware:

  * its **module binding** — the namespace symbol the generated twin
    computes through (``__cuk`` → :mod:`repro_torch.kernels.api`, the
    hand-written CUDA kernels) and the importable module behind it
    (which is also how the twin ships to workers: a module global rides
    the serializer's module-by-name marker);
  * its **dtype map** — how annotation dtypes land on the device;
  * its **pfor-body codegen idiom** — an ``emit_twin`` hook the emitter
    calls per accelerator-feasible pfor unit (returning None when the
    unit does not fit this backend's shape);
  * its **compile hook** — the exec-namespace bindings a generated
    variant needs;
  * its **cost profile** — the gflops/membw/launch-overhead terms
    :func:`repro_torch.core.cost.pick_chunk_backend` prices a (unit,
    backend, worker) cell with;
  * its **serialization tag** — the token the variant-cache key and the
    cluster's per-chunk blob tagging derive from.

This slice registers two backends: ``np`` (the base body) and ``cuda``
(pattern-matched pfor units lowered onto the hand-written kernels), so
the degradation chain is ``cuda → np``. The registry is the port's own:
nothing here touches the reference package's registry, and the cache
token (``cuda2+np1``) differs from every token the reference files
variants under, so a shared cache directory never serves one package's
source to the other.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "Backend", "BackendUnavailable", "register", "unregister", "get",
    "is_registered", "names", "twin_backends", "twin_names",
    "degradation_chain", "cache_token",
]


class BackendUnavailable(RuntimeError):
    """A registered backend's runtime dependency is missing."""


# Default device dtype map (PolyBench float64 semantics preserved on
# accelerators via x64; integer index math stays 64-bit).
_NP_DTYPES = {"f32": "float32", "f64": "float64",
              "i32": "int32", "i64": "int64"}


@dataclass
class Backend:
    """One retargetable code-variant target (slope/Loo.py-style)."""

    name: str
    # namespace symbol the twin body computes through, and the module
    # imported behind it ("" for np: the base variant's own ``xp``)
    xp_binding: str = ""
    module: str = ""
    # serialization/cache token component; bumping it invalidates cached
    # variants generated with an older codegen idiom for this backend
    codegen_version: int = 1
    # placement preference for chunks routed to this backend in a
    # heterogeneous round ('' | 'cpu' | 'gpu')
    device_pref: str = "cpu"
    # routing preference order: ties and zero-flop estimates resolve to
    # the highest-priority feasible candidate; degradation walks down
    priority: int = 0
    # whether codegen emits a per-unit pfor twin body for this backend
    twin: bool = False
    dtype_map: Dict[str, str] = field(default_factory=lambda: dict(_NP_DTYPES))
    # (emitter, unit, body_name, idx, pending_syms) -> twin fn name | None
    emit_twin: Optional[Callable[..., Optional[str]]] = None
    # (emit_meta) -> exec-namespace bindings for variants whose meta
    # records twin units of this backend
    namespace: Optional[Callable[[Any], Dict[str, Any]]] = None
    # (flops, nbytes, profile) -> estimated seconds for one chunk
    chunk_seconds: Optional[Callable[[float, float, Any], float]] = None
    # (profile) -> chunk-sizing throughput weight
    effective_gflops: Optional[Callable[[Any], float]] = None
    # (profile) -> can this worker run the twin at all
    feasible: Optional[Callable[[Any], bool]] = None

    @property
    def attr(self) -> str:
        """Attribute name the np body carries this twin under."""
        return f"__{self.name}__"

    @property
    def tag(self) -> str:
        """Serialization/cache token component."""
        return f"{self.name}{self.codegen_version}"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Backend] = {}


def register(backend: Backend) -> Backend:
    """Register (or replace) a backend. Registration order is the twin
    emission order; pricing/degradation order comes from ``priority``."""
    if backend.name == "np" and backend.twin:
        raise ValueError("the np base backend cannot be a twin")
    _REGISTRY[backend.name] = backend
    return backend


def unregister(name: str) -> Optional[Backend]:
    """Remove a backend (test isolation for toy registrations). The np
    base backend cannot be removed."""
    if name == "np":
        raise ValueError("cannot unregister the np base backend")
    return _REGISTRY.pop(name, None)


def get(name: str) -> Backend:
    return _REGISTRY[name]


def is_registered(name: str) -> bool:
    return name in _REGISTRY


def names() -> List[str]:
    return list(_REGISTRY)


def twin_backends() -> List[Backend]:
    """Twin-emitting backends in registration (= emission) order."""
    return [b for b in _REGISTRY.values() if b.twin]


def twin_names() -> List[str]:
    return [b.name for b in _REGISTRY.values() if b.twin]


def degradation_chain(name: str) -> List[str]:
    """Backends a failing chunk of ``name`` degrades through, ordered by
    descending priority and always ending at ``np`` — the
    ``TaskSpec.alt`` chain (``cuda → np`` in this slice)."""
    start = _REGISTRY.get(name)
    pri = start.priority if start is not None else 0
    lower = sorted((b for b in _REGISTRY.values()
                    if b.twin and b.priority < pri and b.name != name),
                   key=lambda b: -b.priority)
    chain = [b.name for b in lower]
    if "np" not in chain and name != "np":
        chain.append("np")
    return chain


def cache_token(accel_ok: bool) -> str:
    """Registry-derived variant-cache token: sorted backend names, each
    with its codegen version. Twin backends are earned only when the
    accelerator runtime is actually importable (``accel_ok``), so a
    torch-less host files twin-less variants under the np-only token and
    recompiles with twins once torch appears. ``cuda2+np1`` differs from
    every token of the reference package, so neither package is ever
    served the other's cached source."""
    active = [b for b in _REGISTRY.values() if accel_ok or not b.twin]
    return "+".join(b.tag for b in sorted(active, key=lambda b: b.name))




# ---------------------------------------------------------------------------
# Cost-profile terms (imported by repro_torch.core.cost; kept here so a
# backend's pricing rides its registration)
#
# The three priors below were carried over from the TPU-era reference
# and have never been measured on any device: they are unmeasured
# guesses that only order the backends, not estimates of real time.
# ---------------------------------------------------------------------------

# Per-chunk accelerator overhead of a generic per-op twin (host→device
# staging + one launch per op); the torch twin that prices with it comes
# in a later slice, cost re-exports it. Unmeasured prior.
GPU_CHUNK_OVERHEAD_S = 5e-3

# Host↔device staging bandwidth fallback when the profile carries no
# measured number (PCIe-gen3-ish, GB/s).
GPU_XFER_GBS = 12.0

# Advantage of the hand-written CUDA kernel over a generic op stream:
# both the compute and transfer roofline terms improve by this factor.
# Unmeasured prior.
CUDA_FUSION_SPEEDUP = 1.6

# Per-chunk overhead of one hand-kernel chunk on a real device (staging
# the chunk's operands, one launch, reading the result back). Unmeasured
# prior.
CUDA_CHUNK_OVERHEAD_S = 2e-3


def _np_chunk_seconds(flops: float, nbytes: float, profile) -> float:
    rate = max(1e-3, getattr(profile, "gflops", 1.0))
    membw = max(1e-3, getattr(profile, "membw_gbs", 1.0))
    return max(flops / (rate * 1e9), nbytes / (membw * 1e9))


def _gpu_xfer_overhead(profile) -> tuple:
    """(xfer_gbs, real_device) staging terms of the accelerator backend.
    A *simulated* GPU (a CPU worker posing for CI) prices like an
    integrated accelerator — no staging overhead, memory bandwidth as
    the transfer term; real devices use the bandwidth the device probe
    measured, falling back to the PCIe-ish constant."""
    if getattr(profile, "gpu_kind", "") == "sim":
        return max(1e-3, getattr(profile, "membw_gbs", 1.0)), False
    h2d = getattr(profile, "h2d_gbs", 0.0) or 0.0
    d2h = getattr(profile, "d2h_gbs", 0.0) or 0.0
    measured = (min(b for b in (h2d, d2h) if b > 0)
                if (h2d > 0 or d2h > 0) else 0.0)
    return (measured if measured > 0 else GPU_XFER_GBS), True


def _cuda_chunk_seconds(flops: float, nbytes: float, profile) -> float:
    rate = max(1e-3, getattr(profile, "gpu_gflops", 0.0)) \
        * CUDA_FUSION_SPEEDUP
    xfer_gbs, real = _gpu_xfer_overhead(profile)
    xfer_gbs *= CUDA_FUSION_SPEEDUP
    overhead = CUDA_CHUNK_OVERHEAD_S if real else 0.0
    return max(flops / (rate * 1e9),
               nbytes / (xfer_gbs * 1e9)) + overhead


def _accel_feasible(profile) -> bool:
    return (getattr(profile, "has_gpu", False)
            and getattr(profile, "gpu_gflops", 0.0) > 0)


def _gpu_effective_gflops(profile) -> float:
    return max(1e-3, getattr(profile, "gpu_gflops", 0.0))


def _np_effective_gflops(profile) -> float:
    return max(1e-3, getattr(profile, "gflops", 1.0))


# ---------------------------------------------------------------------------
# Built-in backends
# ---------------------------------------------------------------------------

def _cuda_emit_twin(emitter, u, body_name: str, idx: int,
                    pending_syms) -> Optional[str]:
    from .patterns import match_pfor_unit

    m = match_pfor_unit(u)
    if m is None:
        return None
    name = f"{body_name}__cuda"
    emitter.w(f"def {name}(__lo, __hi):")
    emitter.depth += 1
    for line in m.body_lines:
        emitter.w(line)
    emitter.depth -= 1
    return name


def _cuda_namespace(meta) -> Dict[str, Any]:
    try:
        import repro_torch.kernels.api as _cuk
    except ImportError as exc:
        raise BackendUnavailable(
            f"cuda twin references repro_torch.kernels.api, which failed "
            f"to import: {exc}")
    return {"__cuk": _cuk}


register(Backend(
    name="np",
    codegen_version=1,
    device_pref="cpu",
    priority=10,
    twin=False,
    chunk_seconds=_np_chunk_seconds,
    effective_gflops=_np_effective_gflops,
    feasible=lambda profile: True,
))

register(Backend(
    name="cuda",
    xp_binding="__cuk",
    module="repro_torch.kernels.api",
    # 2: twins for attention- and scan-shaped units besides matmul
    codegen_version=2,
    device_pref="gpu",
    priority=30,
    twin=True,
    emit_twin=_cuda_emit_twin,
    namespace=_cuda_namespace,
    chunk_seconds=_cuda_chunk_seconds,
    effective_gflops=lambda p: _gpu_effective_gflops(p)
    * CUDA_FUSION_SPEEDUP,
    feasible=_accel_feasible,
))
