"""Program multi-versioning (paper §4.1).

Builds the runtime decision tree around the generated variants:

    legality (types/ranks match the hints?)          — correctness
      └─ profitability (enough FLOPs for the accelerator variant?)
           ├─ yes → torch variant  (the NumPy→CuPy analogue)
           ├─ no  → optimized NumPy variant
      └─ mismatch → original user function (always correct)

"All the conditions are organized as decision trees, where legality
conditions are located at higher levels while profitability conditions are
at lower levels."
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.obs.metrics import Counter

from . import cost
from .codegen import GeneratedVariant
from .schedule import Schedule
from .types import (TypeInfo, matches, nested_list_shape,
                    runtime_typeinfo)


@dataclass
class Variant:
    name: str                    # 'torch' | 'np' | 'original'
    fn: Callable
    generated: Optional[GeneratedVariant] = None

    def __post_init__(self):
        # per-variant call/latency cells: standalone Variants keep
        # private counters; once a CompiledKernel adopts the variant,
        # bind_metrics swaps in registry-backed ones under the kernel's
        # scope — same attribute API either way
        self._calls = Counter()
        self._total = Counter()

    def bind_metrics(self, scope) -> None:
        c, t = scope.counter(f"{self.name}.calls"), \
            scope.counter(f"{self.name}.total_s")
        c.set(self._calls.value)
        t.set(self._total.value)
        self._calls, self._total = c, t

    @property
    def calls(self) -> int:
        return self._calls.value

    @calls.setter
    def calls(self, v) -> None:
        self._calls.set(v)

    @property
    def total_s(self) -> float:
        return self._total.value

    @total_s.setter
    def total_s(self, v) -> None:
        self._total.set(v)


@dataclass
class DispatchRecord:
    variant: str
    legality_ok: bool
    flops: float
    profitable: bool


class CompiledKernel:
    """Callable decision tree over specialized variants.

    Dispatch counters live in the unified ``obs.metrics`` registry
    under a per-instance ``kernel.<name>#N`` scope (the MetricAttr
    descriptors and Variant metric cells keep every attribute
    read/write site unchanged)."""

    # stop recording novel signatures past this point (pathologically
    # dynamic shapes must not grow memory without bound)
    MAX_TRACKED_SIGS = 4096

    spec_hits = obs.MetricAttr("spec_hits")
    bucket_hits = obs.MetricAttr("bucket_hits")

    def __init__(self, original: Callable, params: List[Tuple[str, TypeInfo]],
                 sched: Schedule, variants: Dict[str, Variant],
                 pfor_config=None,
                 accel_threshold: float = cost.ACCEL_FLOP_THRESHOLD):
        self.original = original
        self.params = params
        self.sched = sched
        self.variants = variants
        self.pfor_config = pfor_config
        self.accel_threshold = accel_threshold
        self.__name__ = getattr(original, "__name__", "kernel")
        self.__doc__ = getattr(original, "__doc__", None)
        self._mscope = obs.metrics.unique_scope(
            f"kernel.{self.__name__}")
        for v in variants.values():
            v.bind_metrics(self._mscope.sub("variants"))
        # ring buffer: long-running serving processes dispatch millions
        # of times; keep only the recent window
        self.history: Deque[DispatchRecord] = deque(maxlen=10_000)
        self._flop_cache: Dict[Tuple, float] = {}
        # dispatch stats watched by the profiler's specializer: per exact
        # call-signature counts + the decision the full tree made for it
        self.shape_counts: Dict[Tuple, int] = {}
        self.last_decisions: Dict[Tuple, Tuple[str, float, bool]] = {}
        self.specializations: Dict[Tuple, Any] = {}
        self.spec_hits = 0
        # per-signature latency EMAs: tree-dispatched calls vs pinned
        # calls — the specializer's demotion sweep compares them to spot
        # regressions (a pin whose decision went stale)
        self.tree_latency: Dict[Tuple, float] = {}
        # bucket tier: pinned decisions also guard the enclosing
        # power-of-two shape bucket, so mild shape drift (batch 60 ↔ 64)
        # keeps the fast path instead of falling back to the full tree
        self.bucket_specs: Dict[Tuple, Any] = {}
        self.bucket_hits = 0
        self.from_cache: bool = False   # built from the persistent cache?

    # -- helpers --------------------------------------------------------
    def _bind(self, args, kwargs) -> Dict[str, Any]:
        names = [n for n, _ in self.params]
        bound = dict(zip(names, args))
        bound.update(kwargs)
        return bound

    def _legality(self, bound: Dict[str, Any]) -> bool:
        for name, hint in self.params:
            if name not in bound:
                return False
            if not matches(hint, runtime_typeinfo(bound[name])):
                return False
        return True

    def _size_env(self, bound: Dict[str, Any]) -> Dict[str, int]:
        env: Dict[str, int] = {}
        for name, val in bound.items():
            if isinstance(val, (int, np.integer)) and not isinstance(
                    val, bool):
                env[name] = int(val)
            arr = val
            if isinstance(arr, list):
                for d, s in enumerate(nested_list_shape(arr)):
                    env[f"{name}__d{d}"] = s
            elif hasattr(arr, "shape"):
                for d, s in enumerate(arr.shape):
                    env[f"{name}__d{d}"] = int(s)
        return env

    def estimate_flops(self, bound: Dict[str, Any]) -> float:
        key = tuple(sorted(self._size_env(bound).items()))
        if key not in self._flop_cache:
            self._flop_cache[key] = cost.schedule_flops(
                self.sched, dict(key))
        return self._flop_cache[key]

    @staticmethod
    def _bucket_sig(sig: Tuple) -> Tuple:
        """Widen an exact signature to its power-of-two shape bucket.

        Kind/dtype/rank survive verbatim (they decide legality — two
        signatures in the same bucket are legality-identical); only the
        extents are widened, so a pinned decision stays valid for every
        signature the bucket admits, with the FLOP estimate off by at most
        2× per dimension."""
        parts = []
        for part in sig:
            name, dtype, extra = part
            if isinstance(extra, tuple):
                parts.append((name, dtype,
                              tuple(cost.pow2_bucket(int(s))
                                    for s in extra)))
            elif dtype == "int" and isinstance(extra, int):
                parts.append((name, dtype, cost.pow2_bucket(extra)))
            else:
                parts.append(part)
        return tuple(parts)

    def _sig(self, bound: Dict[str, Any]) -> Tuple:
        """Exact call signature: (name, dtype, shape) per array param,
        integer values for int scalars (they drive the cost model)."""
        parts = []
        for name, _ in self.params:
            v = bound.get(name)
            if isinstance(v, np.ndarray):
                parts.append((name, str(v.dtype), v.shape))
            elif isinstance(v, (int, np.integer)) and not isinstance(
                    v, bool):
                parts.append((name, "int", int(v)))
            elif isinstance(v, list):
                parts.append((name, "list", nested_list_shape(v)))
            elif hasattr(v, "shape") and hasattr(v, "dtype"):
                parts.append((name, str(v.dtype), tuple(v.shape)))
            else:
                parts.append((name, type(v).__name__, None))
        return tuple(parts)

    # -- the decision tree ------------------------------------------------
    def select(self, bound: Dict[str, Any]) -> Tuple[Variant,
                                                     DispatchRecord]:
        legal = self._legality(bound)
        if not legal:
            rec = DispatchRecord("original", False, 0.0, False)
            return self.variants["original"], rec
        flops = self.estimate_flops(bound)
        profitable = cost.accel_profitable(flops, self.accel_threshold)
        if profitable and "torch" in self.variants:
            # the variant computes on txp's bound device: where that is
            # a card this host lacks, the call raises here, saying how
            # to bind the CPU, rather than stepping down to np unseen
            from . import txp
            txp.device()
            rec = DispatchRecord("torch", True, flops, True)
            return self.variants["torch"], rec
        if "np" in self.variants:
            rec = DispatchRecord("np", True, flops, profitable)
            return self.variants["np"], rec
        rec = DispatchRecord("original", True, flops, profitable)
        return self.variants["original"], rec

    def __call__(self, *args, **kwargs):
        bound = self._bind(args, kwargs)
        sig = self._sig(bound)
        bucket_hit = False
        spec = self.specializations.get(sig)
        if spec is None:
            # bucket tier: same dtype/rank, shape drifted within the
            # enclosing pow2 bucket → replay the pinned decision anyway.
            # Deliberately NOT recorded in last_decisions: a pin may only
            # ever replay a decision the full tree made for that exact
            # signature, and the borrowed one (FLOPs off by ≤2× per dim)
            # must stay transient, not get promoted by the specializer.
            spec = self.bucket_specs.get(self._bucket_sig(sig))
            if spec is not None:
                self.bucket_hits += 1
                bucket_hit = True
        if spec is not None:
            # hot path pinned by the specializer: replay the decision the
            # full tree made for this exact signature (legality included)
            variant = self.variants[spec.variant_name]
            rec = DispatchRecord(spec.variant_name, spec.legality_ok,
                                 spec.flops, True)
            spec.hits += 1
            self.spec_hits += 1
        else:
            variant, rec = self.select(bound)
            n = self.shape_counts.get(sig)
            if n is not None:
                self.shape_counts[sig] = n + 1
            elif len(self.shape_counts) < self.MAX_TRACKED_SIGS:
                self.shape_counts[sig] = 1
            if sig in self.shape_counts:
                self.last_decisions[sig] = (variant.name, rec.flops,
                                            rec.legality_ok)
        self.history.append(rec)
        if self.pfor_config is not None:
            self.pfor_config.estimated_flops = rec.flops
        t0 = time.perf_counter()
        out = self._invoke(variant, bound)
        dt = time.perf_counter() - t0
        variant.calls += 1
        variant.total_s += dt
        if spec is not None:
            # bucket-tier calls run a *different* shape (up to 2x per
            # dim) — folding their latency into the pin's EMA would fake
            # a regression against the exact-shape tree baseline
            if not bucket_hit:
                ema = getattr(spec, "latency_ema", None)
                spec.latency_ema = (dt if ema is None
                                    else 0.8 * ema + 0.2 * dt)
        elif sig in self.shape_counts:
            ema = self.tree_latency.get(sig)
            self.tree_latency[sig] = (dt if ema is None
                                      else 0.8 * ema + 0.2 * dt)
        return out

    # -- specialization hooks (repro_torch.profiler.specializer) ---------------
    def install_specialization(self, spec) -> None:
        """Hot-swap a pinned decision into the tree. The original
        function remains the fallback for every non-matching signature.
        The same decision also guards the enclosing pow2 shape bucket."""
        self.specializations[spec.sig] = spec
        self.bucket_specs[self._bucket_sig(spec.sig)] = spec

    def drop_specialization(self, sig: Tuple) -> None:
        spec = self.specializations.pop(sig, None)
        if spec is not None:
            bkey = self._bucket_sig(sig)
            if self.bucket_specs.get(bkey) is spec:
                self.bucket_specs.pop(bkey, None)

    def stats(self) -> Dict[str, Any]:
        """Dispatch/cache telemetry (consumed by serve.engine)."""
        fusion = getattr(self.sched, "fusion", None)
        return {
            "calls": sum(v.calls for v in self.variants.values()),
            "variants": {
                name: {"calls": v.calls,
                       "total_s": round(v.total_s, 6)}
                for name, v in self.variants.items()},
            "distinct_signatures": len(self.shape_counts),
            "specializations": len(self.specializations),
            "spec_hits": self.spec_hits,
            "bucket_specs": len(self.bucket_specs),
            "bucket_hits": self.bucket_hits,
            "fused_units": getattr(fusion, "fused_units", 0),
            "contracted_arrays": len(
                getattr(fusion, "contracted_arrays", ()) or ()),
            "pfor_torch_units": len(self.pfor_torch_units()),
            "pfor_batch_units": len(self.pfor_batch_units()),
            "pfor_twin_units": {name: len(units) for name, units
                                in self.pfor_twin_units().items()},
            "from_cache": self.from_cache,
        }

    def pfor_torch_units(self) -> List[int]:
        """pfor unit indices whose np body carries a torch twin — the
        units the heterogeneous cluster may run on a worker's device
        (empty for pfor-free or np-only kernels)."""
        return self.pfor_twin_units().get("torch", [])

    def pfor_batch_units(self) -> List[int]:
        """Subset of :meth:`pfor_torch_units` whose twin also carries a
        per-iteration function wired through ``__pfor_batch`` (the
        batched ``torch.func.vmap`` path)."""
        v = self.variants.get("np")
        if v is None or v.generated is None:
            return []
        return list(getattr(v.generated.meta, "pfor_batch_units", ())
                    or ())

    def pfor_twin_units(self) -> Dict[str, List[int]]:
        """Backend name → pfor unit indices carrying that backend's
        twin."""
        v = self.variants.get("np")
        if v is None or v.generated is None:
            return {}
        twins = getattr(v.generated.meta, "pfor_twin_units", None) or {}
        return {name: list(units) for name, units in twins.items()}

    def call_variant(self, name: str, *args, **kwargs):
        """Force a specific variant (benchmark harness hook)."""
        bound = self._bind(args, kwargs)
        if self.pfor_config is not None:
            self.pfor_config.estimated_flops = self.estimate_flops(bound)
        return self._invoke(self.variants[name], bound)

    def _invoke(self, variant: Variant, bound: Dict[str, Any]):
        names = [n for n, _ in self.params]
        args = [bound[n] for n in names]
        if variant.name == "original":
            return variant.fn(*args)
        result = variant.fn(*args)
        gen = variant.generated
        if gen is not None and gen.returns_written and result is not None:
            outs = result if isinstance(result, tuple) else (result,)
            for name, val in zip(gen.written, outs):
                orig = bound[name]
                self._copy_back(orig, val)
            return None
        return result

    @staticmethod
    def _copy_back(orig, val):
        if hasattr(val, "detach"):
            # a device tensor of the torch variant: bring it home
            val = val.detach().cpu().numpy()
        arr = np.asarray(val)
        if isinstance(orig, np.ndarray):
            np.copyto(orig, arr.astype(orig.dtype, copy=False))
        elif isinstance(orig, list):
            data = arr.tolist()
            orig[:] = data
        # scalars: caller keeps its own copy; nothing to write back

    # -- introspection ------------------------------------------------------
    def source(self, backend: str = "np") -> str:
        v = self.variants.get(backend)
        if v is None or v.generated is None:
            raise KeyError(f"no generated source for backend {backend!r}")
        return v.generated.source

    def explain(self) -> str:
        lines = [f"CompiledKernel({self.__name__})"]
        lines.append("  decision tree:")
        lines.append("    legality: type/rank hints "
                     f"{[(n, t.kind, t.dtype, t.rank) for n, t in self.params]}")
        lines.append(f"    profitability: flops >= {self.accel_threshold:g}"
                     " → accelerator variant")
        fusion = getattr(self.sched, "fusion", None)
        if fusion is not None and (fusion.fused_units
                                   or fusion.contracted_arrays):
            lines.append(
                f"  fusion: {fusion.fused_units} fused unit(s), "
                f"contracted {list(fusion.contracted_arrays)}")
        twin_units = self.pfor_twin_units()
        for bname, units in twin_units.items():
            lines.append(
                f"  hetero: pfor unit(s) {units} carry {bname} twin "
                "bodies — the cluster prices the backends per worker "
                "profile and routes chunks by device_pref")
        for name, v in self.variants.items():
            ops = (v.generated.meta.raised_ops if v.generated else [])
            lines.append(f"  variant {name}: calls={v.calls} "
                         f"time={v.total_s:.4f}s raised={ops}")
        return "\n".join(lines)
