"""Public compiler API: ``automphc.optimize`` — the whole paper in one call.

    from repro_torch.core.compiler import optimize

    @optimize                       # or optimize(distribute=True, ...)
    def kernel(data: 'ndarray[f64,2]', corr: 'ndarray[f64,2]', M: int, N: int):
        ...

Pipeline (paper Fig. 4): Front-end (parse + type inference) → SCoP
extraction (explicit+implicit loop unification) → dependence analysis →
scheduling (absorption / distribution / pfor) → operator raising → code
generation (the np variant, whose pfor bodies carry one twin per
registered accelerator backend) → multi-version dispatcher.

In this port the accelerator backend is torch. Every accelerator-feasible
pfor body gets a ``torch`` twin (computed through
:mod:`repro_torch.core.txp` on a worker's device, batched with
``torch.func.vmap`` where the body is row-parallel), and matmul-,
attention- and scan-shaped bodies also get a ``cuda`` twin that runs a
hand-written CUDA kernel. A pfor-free kernel gets a whole-kernel
``torch`` variant, which the dispatcher picks above its FLOP threshold;
it computes on the process's torch device (:func:`txp.set_device`, the
card unless bound otherwise). Compiling needs torch importable, not a
GPU.

Hints can be hand-written (above) or harvested by the dynamic profiler
(paper §1: "supplied by the programmer or obtained by dynamic profiler
tools"):

    @optimize(profile=True, warmup=8)   # no hints needed
    def kernel(data, corr, M, N): ...

    ck = optimize.from_trace(traced_fn)          # explicit trace → kernel

With ``cache=VariantCache(dir)`` (or a path string) compiled variants
persist on disk keyed by (source hash, type signature, backend); a warm
process rebuilds the dispatcher from stored source and skips
parse → SCoP → schedule → codegen entirely.
"""

from __future__ import annotations

import functools
import inspect
import time
from typing import Callable, Dict, Optional, Union

import numpy as np

from repro_torch import obs
from repro_torch.profiler.cache import (CacheEntry, VariantCache, source_hash)
from repro_torch.profiler.hints import (synthesize_hint_tiers, synthesize_hints,
                                  type_signature)
from repro_torch.profiler.tracer import FunctionTrace, Tracer

from . import backends, codegen, cost, parser, schedule as schedule_mod, scop
from .multiversion import CompiledKernel, Variant
from .pfor import PforConfig


def _stage(scope, kernel: str, name: str, t0: float, t1: float,
           tracing: bool) -> None:
    """File one compile-pipeline stage: duration into the kernel's
    ``compile.<name>`` metrics scope, and (when tracing) a span on the
    head timeline."""
    scope.add_time(name + "_s", t1 - t0)
    if tracing:
        obs.recorder().record(name, "compile", t0, t1,
                              args={"kernel": kernel})


def _exec_variant(gen: codegen.GeneratedVariant, xp, extra: Dict) -> Callable:
    ns: Dict = {"xp": xp}
    ns.update(extra)
    exec(compile(gen.source, f"<automphc:{gen.fn_name}>", "exec"), ns)
    return ns[gen.fn_name]


def _resolved_type_sig(fn: Callable,
                       hints: Optional[Dict[str, str]]) -> str:
    """Canonical per-param type signature (cache key component). Merges
    source annotations with override hints and delegates the encoding to
    :func:`repro_torch.profiler.hints.type_signature`. Uses only
    ``inspect.signature`` — deliberately cheap so the warm path never
    touches the AST."""
    try:
        names = [p for p in inspect.signature(fn).parameters
                 if p != "self"]
    except (TypeError, ValueError):
        names = []
    anns = dict(getattr(fn, "__annotations__", {}) or {})
    if hints:
        anns.update(hints)
    return type_signature(anns, names)


def _torch_ok() -> bool:
    """Is torch importable here? The twins' runtime surfaces need it on
    the workers; the head that compiles needs no GPU."""
    try:
        import torch  # noqa: F401
    except ImportError:
        return False
    return True


def _make_np_variant(gen_np: codegen.GeneratedVariant,
                     pfor_cfg: PforConfig) -> Variant:
    extra = {"__pfor_run": pfor_cfg.make_runner()}
    # hybrid variant: pfor bodies carry per-backend twins — each
    # recorded backend contributes its exec-namespace bindings (__txp,
    # __pfor_batch, __cuk) via its registry hook
    twin_units = dict(getattr(gen_np.meta, "pfor_twin_units", None) or {})
    for bname in twin_units:
        try:
            bk = backends.get(bname)
        except KeyError:
            raise codegen.EmitError(
                f"variant references unregistered backend {bname!r}")
        if bk.namespace is not None:
            extra.update(bk.namespace(gen_np.meta))
    np_fn = _exec_variant(gen_np, np, extra)
    return Variant("np", np_fn, gen_np)


def _make_torch_variant(gen: codegen.GeneratedVariant) -> Variant:
    from . import txp

    return Variant("torch", _exec_variant(gen, txp, {}), gen)


def compile_kernel(
    fn: Callable,
    *,
    distribute: bool = True,
    fuse: bool = True,
    runtime=None,
    tile: Optional[int] = None,
    workers: int = 4,
    accel_threshold: float = cost.ACCEL_FLOP_THRESHOLD,
    enable_accel: bool = True,
    hints: Optional[Dict[str, str]] = None,
    cache: Optional[Union[VariantCache, str]] = None,
    trace=None,
) -> CompiledKernel:
    if isinstance(cache, str):
        cache = VariantCache(cache)
    # trace=True (or REPRO_TRACE=1) records compile-pipeline spans; the
    # per-stage duration counters below are always on
    if trace:
        obs.enable()
    tracing = obs.enabled() if trace is None else bool(trace)
    kname = getattr(fn, "__name__", "kernel")
    cscope = obs.metrics.scope(f"compile.{kname}")

    pfor_cfg = PforConfig(runtime=runtime, tile=tile, workers=workers)
    pfor_cfg.distribute_threshold = cost.DISTRIBUTE_FLOP_THRESHOLD

    # backend tag carries every option that changes the *generated code*
    # (schedule shape included); runtime knobs (tile/workers/thresholds)
    # live in PforConfig / dispatch state rebuilt fresh on every load.
    # The token is registry-derived (sorted backend tags, each carrying
    # its codegen version): registering a backend or bumping a
    # backend's codegen_version re-keys the cache, so entries generated
    # with an older twin set miss into a recompile instead of serving
    # stale code. Twin tags are earned only when torch is *actually*
    # importable: a twin-less compile on a torch-less host files under
    # the np-only token, so installing torch later recompiles with twins
    # instead of serving the twin-less entry forever.
    twins_ok = enable_accel and _torch_ok()
    backend_tag = backends.cache_token(twins_ok) \
        + ("" if enable_accel else ":noaccel") \
        + (":dist" if distribute else ":nodist") \
        + (":fuse" if fuse else ":nofuse")
    src_h = type_sig = None
    if cache is not None:
        src_h = source_hash(fn)
        type_sig = _resolved_type_sig(fn, hints)
        entry = cache.get(src_h, type_sig, backend_tag)
        if entry is not None:
            tr0 = time.perf_counter()
            ck = _rebuild_from_entry(fn, entry, pfor_cfg, accel_threshold)
            if ck is not None:
                _stage(cscope, kname, "rebuild", tr0,
                       time.perf_counter(), tracing)
                cache.stats.codegen_skipped += 1
                return ck

    t0 = time.perf_counter()
    tir_fn = parser.parse_function(fn, hint_overrides=hints)
    t_parse = time.perf_counter()
    program = scop.extract(tir_fn)
    t_scop = time.perf_counter()
    # Each backend gets the fusion profile that matches its memory
    # behaviour: np mutates in place (contract temps, keep aug statements
    # distributed as library calls); the whole-kernel torch variant below
    # takes the functional profile, as the reference's jnp variant does
    sched = schedule_mod.schedule(program, distribute=distribute, fuse=fuse,
                                  fusion_profile="inplace")
    t_sched = time.perf_counter()
    _stage(cscope, kname, "parse", t0, t_parse, tracing)
    _stage(cscope, kname, "scop", t_parse, t_scop, tracing)
    _stage(cscope, kname, "schedule", t_scop, t_sched, tracing)
    # fusion + dependence ran inside schedule(); it leaves stamped
    # sub-stage intervals behind rather than importing obs itself
    for nm, s0, s1 in getattr(sched, "stage_spans", ()):
        _stage(cscope, kname, nm, s0, s1, tracing)
    # the cluster runtime diffs only schedule-written arrays when
    # gathering pfor chunk results from worker processes
    pfor_cfg.written = tuple(sched.written)
    pfor_cfg.sliceable = _sliceable_union(sched)

    variants: Dict[str, Variant] = {
        "original": Variant("original", fn),
    }

    # Optimized NumPy variant (always attempted; falls back statement-wise).
    # With pfor units and torch available it is a *hybrid*: seq units
    # stay np, every accelerator-feasible pfor body gets a torch twin
    # and every one the cuda matcher recognizes a cuda twin, which the
    # cluster routes GPU workers to (per-unit backend variants). Twins
    # are generated eagerly (not on first cluster dispatch) so the
    # cached entry is self-contained and a runtime can be bound to the
    # compiled kernel later.
    hybrid = twins_ok and sched.has_pfor
    t_cg0 = time.perf_counter()
    gen_np = codegen.generate(sched, "np", pfor_twins=hybrid)
    variants["np"] = _make_np_variant(gen_np, pfor_cfg)
    _stage(cscope, kname, "codegen", t_cg0, time.perf_counter(),
           tracing)

    # Whole-kernel torch variant (pfor-free, opaque-free kernels only)
    if twins_ok and not sched.has_opaque and not sched.has_pfor:
        t_cg0 = time.perf_counter()
        try:
            # with fusion off both profiles schedule identically
            sched_fn = sched if not fuse else schedule_mod.schedule(
                program, distribute=distribute, fuse=fuse,
                fusion_profile="functional")
            variants["torch"] = _make_torch_variant(
                codegen.generate(sched_fn, "torch"))
        except codegen.EmitError:
            pass
        _stage(cscope, kname, "codegen", t_cg0, time.perf_counter(),
               tracing)

    compile_s = time.perf_counter() - t0

    ck = CompiledKernel(fn, tir_fn.params, sched, variants,
                        pfor_config=pfor_cfg,
                        accel_threshold=accel_threshold)

    if cache is not None:
        generated = {name: v.generated for name, v in variants.items()
                     if v.generated is not None}
        t_cs0 = time.perf_counter()
        try:
            cache.put(CacheEntry(
                fn_name=ck.__name__, src_hash=src_h, type_sig=type_sig,
                backend=backend_tag, params=list(tir_fn.params),
                sched=sched, generated=generated, compile_s=compile_s))
        except Exception:
            pass  # cache write failure must never break compilation
        _stage(cscope, kname, "cache_store", t_cs0,
               time.perf_counter(), tracing)
    return ck


def _sliceable_union(sched) -> tuple:
    """Union of per-unit chunk-sliceable arrays (telemetry + fallback for
    generated bodies predating the ``__sliceable__`` attribute)."""
    names = {n
             for u in schedule_mod._flatten(sched.units)
             if isinstance(u, schedule_mod.PforUnit)
             for n in getattr(u, "sliceable", ())}
    return tuple(sorted(names))


def _rebuild_from_entry(fn: Callable, entry: CacheEntry,
                        pfor_cfg: PforConfig,
                        accel_threshold: float) -> Optional[CompiledKernel]:
    """Warm start: dispatcher from stored source, no front-end work."""
    try:
        pfor_cfg.written = tuple(getattr(entry.sched, "written", ()) or ())
        pfor_cfg.sliceable = _sliceable_union(entry.sched)
        variants: Dict[str, Variant] = {
            "original": Variant("original", fn),
        }
        for name, gen in entry.generated.items():
            if name == "np":
                variants["np"] = _make_np_variant(gen, pfor_cfg)
            elif name == "torch":
                variants["torch"] = _make_torch_variant(gen)
        ck = CompiledKernel(fn, entry.params, entry.sched, variants,
                            pfor_config=pfor_cfg,
                            accel_threshold=accel_threshold)
        ck.from_cache = True
        return ck
    except Exception:
        # a stale/incompatible entry degrades to a cold compile
        return None


# ---------------------------------------------------------------------------
# Profile-guided entry points (the dynamic-profiler half of §4.1)
# ---------------------------------------------------------------------------

class ProfiledFunction:
    """Wrapper returned by ``optimize(profile=True)``.

    Phase 1 (first ``warmup`` calls): run the original function under the
    tracer, recording call signatures. Phase 2: synthesize a
    legality-ordered hint set from the trace, compile through the normal
    pipeline, and dispatch every later call through the multi-version
    decision tree (original function stays the fallback)."""

    def __init__(self, fn: Callable, *, warmup: int = 8,
                 tracer: Optional[Tracer] = None,
                 specializer=None, calibrate: bool = True, **compile_kw):
        self.fn = fn
        self.warmup = max(1, warmup)
        self.tracer = tracer or Tracer()
        self.traced = self.tracer.wrap(fn)
        self.specializer = specializer
        # calibrate the accelerator FLOP threshold from traced latencies
        # unless the caller pinned an explicit threshold
        self.calibrate = calibrate and "accel_threshold" not in compile_kw
        self.compile_kw = compile_kw
        self.compiled: Optional[CompiledKernel] = None
        self.tiers = None
        functools.update_wrapper(self, fn)

    @property
    def trace(self) -> FunctionTrace:
        return self.traced.__trace__

    def __call__(self, *args, **kwargs):
        if self.compiled is not None:
            return self.compiled(*args, **kwargs)
        out = self.traced(*args, **kwargs)
        if self.trace.calls >= self.warmup:
            try:
                self.compile()
            except Exception:
                # stay on the traced original; retry next call is
                # pointless with the same trace, so disable by doubling
                self.warmup *= 2
        return out

    def compile(self) -> CompiledKernel:
        """Fold the trace into hints and build the dispatcher now."""
        if self.compiled is None:
            self.tiers = synthesize_hint_tiers(self.trace)
            # all tiers share hint strings; one compile serves them all
            hints = self.tiers[-1].hints
            self.compiled = compile_kernel(self.fn, hints=hints,
                                           **self.compile_kw)
            if self.calibrate:
                thr = self.calibrated_threshold()
                if thr is not None:
                    self.compiled.accel_threshold = thr
            if self.specializer is not None:
                self.specializer.register(self.compiled)
        return self.compiled

    def calibrated_threshold(self) -> Optional[float]:
        """Per-machine accelerator threshold from the warmup trace.

        The tracer timed the *original* function per signature; the
        compiled schedule converts each signature's shapes/int params into
        a FLOP estimate, and the roofline calibrator turns the measured
        FLOP rate into the break-even point against the fixed dispatch
        overhead. Returns None (→ keep the static default) when the trace
        carries no usable sample."""
        if self.compiled is None:
            return None
        samples = []
        for rec in self.trace.signatures:
            env: Dict[str, int] = {}
            for o in rec.args:
                if o.kind in ("array", "list") and o.shape:
                    for d, s in enumerate(o.shape):
                        env[f"{o.name}__d{d}"] = int(s)
                elif o.ivalue is not None:
                    env[o.name] = o.ivalue
            try:
                flops = cost.schedule_flops(self.compiled.sched, env)
            except Exception:
                continue
            if rec.mean_s > 0 and flops > 0:
                samples.append((flops, rec.mean_s))
        if not samples:
            return None
        return cost.calibrate_accel_threshold(samples)

    def stats(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "traced_calls": self.trace.calls,
            "distinct_signatures": len(self.trace.records),
            "compiled": self.compiled is not None,
        }
        if self.compiled is not None:
            out["dispatch"] = self.compiled.stats()
        return out


def optimize(fn: Optional[Callable] = None, *, profile: bool = False,
             warmup: int = 8, tracer: Optional[Tracer] = None,
             specializer=None, calibrate: bool = True, **kw):
    """Decorator form of :func:`compile_kernel`.

    ``profile=True`` defers compilation behind a tracing phase so the
    kernel needs no hand-written hints (and, with ``calibrate=True``,
    tunes the accelerator profitability threshold from the measured
    warmup latencies)."""
    def build(f):
        if profile:
            return ProfiledFunction(f, warmup=warmup, tracer=tracer,
                                    specializer=specializer,
                                    calibrate=calibrate, **kw)
        return compile_kernel(f, **kw)

    if fn is not None and callable(fn):
        return build(fn)
    return build


def from_trace(fn: Callable, trace: Optional[FunctionTrace] = None,
               **kw) -> CompiledKernel:
    """Compile using hints synthesized from an existing trace.

    ``fn`` may be a tracer-wrapped function (its trace is used
    automatically) or the bare function plus an explicit ``trace``."""
    if trace is None:
        trace = getattr(fn, "__trace__", None)
        if trace is None:
            raise ValueError(
                "from_trace needs a tracer-wrapped function or an "
                "explicit trace= argument")
    target = getattr(fn, "__wrapped_fn__", fn)
    hints = synthesize_hints(trace)
    return compile_kernel(target, hints=hints, **kw)


optimize.from_trace = from_trace  # type: ignore[attr-defined]
