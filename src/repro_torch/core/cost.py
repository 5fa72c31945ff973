"""Cost model: profitability conditions + roofline terms.

The paper's profitability conditions are "a threshold expression using loop
counts" (§4.3). We upgrade that to a roofline cost model — the same three
terms (compute / memory / collective) the launch-time planner uses —
while keeping the simple loop-count form
available for the kernel dispatcher.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from . import backends
from .isl_lite import Affine, Domain, LoopDim
from .schedule import (FFTUnit, OpaqueUnit, PforUnit, RaisedUnit, Schedule,
                       SeqLoopUnit, Unit)
from .scop import CanonStmt, VAccess, VBin, VReduce, VUnary, vexpr_accesses


# ---------------------------------------------------------------------------
# Hardware model (the H100 for the launch-time roofline; the CPU host for
# the kernel dispatcher)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: float        # FLOP/s (bf16 dense)
    hbm_bw: float            # bytes/s
    ici_bw: float            # bytes/s per link
    hbm_bytes: float
    vmem_bytes: float


# One H100 SXM (``nvidia-smi``: NVIDIA H100 80GB HBM3) at its 700 W power
# limit, from NVIDIA's data sheet (datasheet figures, not measured):
# bf16 dense tensor-core peak, HBM3 rate, NVLink 4 a direction, HBM
# size, and the shared memory an SM may give one block (228 KiB) as
# ``vmem_bytes``. The launch-time planner and dry run price every
# collective at the NVLink rate, those of an axis that crosses nodes
# too.
H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    hbm_bytes=80e9,
    vmem_bytes=228 * 2**10,
)

# A CPU host — used only for kernel-dispatch
# profitability thresholds, not for roofline reporting.
HOST_CPU = ChipSpec(
    name="host_cpu",
    peak_flops=5e10,
    hbm_bw=1e10,
    ici_bw=1e9,
    hbm_bytes=8 * 2**30,
    vmem_bytes=32 * 2**10,
)


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


# ---------------------------------------------------------------------------
# Kernel-level FLOP estimation (profitability for the dispatcher)
# ---------------------------------------------------------------------------

def _card(domain_dims: Iterable[LoopDim], env: Dict[str, int]) -> float:
    d = Domain(tuple(domain_dims))
    try:
        return float(d.cardinality(env))
    except Exception:
        # unbound symbol: assume a nominal extent
        total = 1.0
        for dim in d.dims:
            ext = dim.upper - dim.lower
            if ext.is_constant():
                total *= max(1, ext.const)
            else:
                total *= 256.0
        return total


def _expr_flops_per_point(e, env: Dict[str, int]) -> float:
    if isinstance(e, VReduce):
        inner = _expr_flops_per_point(e.child, env) + 1.0
        return inner * max(1.0, _card(e.dims, env))
    if isinstance(e, VBin):
        return 1.0 + _expr_flops_per_point(e.left, env) \
            + _expr_flops_per_point(e.right, env)
    if isinstance(e, VUnary):
        return 1.0 + _expr_flops_per_point(e.operand, env)
    return 0.0


def stmt_flops(stmt: CanonStmt, env: Dict[str, int]) -> float:
    # out-domain card × per-point flops (reductions folded in)
    dims = list(stmt.domain.dims)
    pts = _card(dims, env)
    return pts * max(1.0, _expr_flops_per_point(stmt.rhs, env))


def schedule_flops(sched: Schedule, env: Dict[str, int]) -> float:
    total = 0.0

    def rec(units: List[Unit], mult: float):
        nonlocal total
        for u in units:
            if isinstance(u, RaisedUnit):
                total += mult * stmt_flops(u.stmt, env)
            elif isinstance(u, FFTUnit):
                total += mult * 5e4  # nominal per-call
            elif isinstance(u, (SeqLoopUnit, PforUnit)):
                ext = u.dim.upper - u.dim.lower
                if ext.is_constant():
                    m = max(1, ext.const)
                else:
                    try:
                        m = max(1, ext.evaluate(env))
                    except Exception:
                        m = 64
                rec(u.body, mult * m)

    rec(sched.units, 1.0)
    return total


# ---------------------------------------------------------------------------
# Profitability thresholds (decision-tree leaves, paper §4.1/§4.3)
# ---------------------------------------------------------------------------

# Accelerator dispatch is worth it only above this many FLOPs per call
# (device transfer + dispatch overheads dominate below it).
ACCEL_FLOP_THRESHOLD = 5e6

# Per-call accelerator overhead (host→device transfer + dispatch) used to
# calibrate the FLOP threshold from measured original-function latencies.
ACCEL_DISPATCH_OVERHEAD_S = 2e-3

# Distributing a pfor across workers is worth it above this much work.
DISTRIBUTE_FLOP_THRESHOLD = 1e7

# Per-chunk accelerator launch overhead on a worker (host→device staging
# + kernel dispatch for the torch twin of a pfor body); conservative so
# tiny chunks stay on the np body. Owned by the backend registry (each
# backend's cost profile rides its registration); re-exported here for
# call sites that read the constants.
GPU_CHUNK_OVERHEAD_S = backends.GPU_CHUNK_OVERHEAD_S

# Host↔device staging bandwidth fallback when the profile carries no
# measured number (PCIe-gen3-ish, in GB/s).
GPU_XFER_GBS = backends.GPU_XFER_GBS

# Fixed per-task cost of dispatching one chunk to a worker process
# (serialize + pipe + schedule); measured on a CPU host's pipes.
CLUSTER_TASK_OVERHEAD_S = 1.5e-3

# Conservative pipe/socket bandwidth fallback when the runtime has no
# measured transport number yet.
CLUSTER_TRANSPORT_MBS = 400.0


def accel_profitable(flops: float,
                     threshold: float = ACCEL_FLOP_THRESHOLD) -> bool:
    return flops >= threshold


def distribute_profitable(flops: float,
                          threshold: float = DISTRIBUTE_FLOP_THRESHOLD) -> bool:
    return flops >= threshold


def cluster_distribute_profitable(
    flops: float,
    payload_bytes: float,
    profiles: Iterable,
    n_chunks: int = 1,
    local_gflops: float = 1.0,
    overhead_s: float = CLUSTER_TASK_OVERHEAD_S,
    sliced_bytes: float = 0.0,
) -> bool:
    """Local-vs-distributed decision from measured device profiles.

    The paper's threshold expression generalized to a two-sided time
    estimate: run on the head at its measured FLOP rate, or ship the
    closure payload over the measured transport, burn a fixed dispatch
    overhead per chunk, and compute at the fleet's *aggregate* measured
    rate. Distribution wins only when the estimated distributed wall
    time (transfer + dispatch + compute) beats local execution — so a
    fleet of slow workers behind a thin pipe correctly loses to a fast
    head for small kernels, and per-worker heterogeneity is captured by
    summing each profile's own rate.

    ``payload_bytes`` is the *broadcast* part of the closure — it rides
    to every worker, so it costs ``n_workers × bytes`` on the head's
    serial transport. ``sliced_bytes`` is the chunk-sliceable part: the
    workers collectively receive it exactly once (each gets its rows),
    so it costs ``bytes`` total regardless of fleet size. The split is
    what flips marginal kernels with large sliceable inputs to
    distributed."""
    profiles = list(profiles)
    if not profiles:
        return False
    t_local = flops / max(1e-9, local_gflops * 1e9)
    agg_gflops = sum(max(1e-3, p.gflops) for p in profiles)
    mbs = [p.transport_mbs for p in profiles if p.transport_mbs > 0]
    transport_bs = (min(mbs) if mbs else CLUSTER_TRANSPORT_MBS) * 1e6
    # dispatch is serial on the head (one send per chunk), so the
    # per-chunk overhead does NOT amortize across workers
    wire_bytes = len(profiles) * payload_bytes + sliced_bytes
    t_dist = (flops / (agg_gflops * 1e9)
              + wire_bytes / max(1.0, transport_bs)
              + overhead_s * max(1, n_chunks))
    return t_dist < t_local


# ---------------------------------------------------------------------------
# Per-(unit, backend, worker-profile) pricing (heterogeneous chunk routing)
# ---------------------------------------------------------------------------

def chunk_backend_seconds(flops: float, nbytes: float, profile,
                          backend: str) -> float:
    """Estimated seconds for one pfor chunk of ``flops``/``nbytes`` on
    ``profile`` executing the ``backend`` body — the roofline max of the
    compute and data-movement terms, plus the accelerator's per-chunk
    launch overhead. This is the cell of the (unit, backend, worker)
    table the cluster prices instead of one kernel-level threshold.

    The formula is the backend's own ``chunk_seconds`` cost profile
    (:mod:`repro_torch.core.backends`): np prices against host
    gflops/membw, torch against the (real or simulated) GPU with staging
    bandwidth the device probe measured, cuda like torch with both
    roofline terms scaled by its fused-kernel speedup."""
    bk = backends.get(backend)
    if bk.chunk_seconds is None:  # pragma: no cover — registry contract
        raise ValueError(f"backend {backend!r} has no cost profile")
    return bk.chunk_seconds(flops, nbytes, profile)


def _feasible(bk, profile) -> bool:
    return bk.feasible is None or bk.feasible(profile)


def pick_chunk_backend(flops: float, nbytes: float, profile,
                       candidates: Tuple[str, ...] = ()) -> str:
    """Choose the cheapest body backend for one worker's chunk.

    ``candidates`` are the twin backends whose bodies actually exist for
    the unit (none: the np body). Only workers the backend declares
    itself feasible on (e.g. a real or simulated GPU) are priced against
    it; a zero FLOP estimate (direct calls that bypassed the dispatcher)
    degrades to capability tags — the highest-priority feasible
    candidate wins. Ties price to np: a twin must be *strictly* cheaper
    to leave the always-correct body."""
    live = [backends.get(c) for c in candidates
            if backends.is_registered(c)]
    live = [bk for bk in live if _feasible(bk, profile)]
    if not live:
        return "np"
    live.sort(key=lambda bk: -bk.priority)
    if flops <= 0:
        return live[0].name
    t_np = chunk_backend_seconds(flops, nbytes, profile, "np")
    best, best_t = "np", t_np
    for bk in live:
        t = bk.chunk_seconds(flops, nbytes, profile)
        if t < best_t:
            best, best_t = bk.name, t
    return best


def unit_backend_table(flops_per_worker: float, nbytes_per_worker: float,
                       profiles: Iterable,
                       candidates: Tuple[str, ...] = ()) -> List[str]:
    """Backend choice per worker profile for one pfor unit (in profile
    order) — the row of the (unit, backend, worker) pricing table the
    sharder consumes."""
    return [pick_chunk_backend(flops_per_worker, nbytes_per_worker, p,
                               candidates)
            for p in profiles]


def backend_effective_gflops(profile, backend: str) -> float:
    """Throughput of ``profile`` when running its chosen backend — the
    chunk-sizing weight for heterogeneous fleets (a GPU worker on an
    accelerator body earns a proportionally larger chunk)."""
    bk = backends.get(backend)
    if bk.effective_gflops is None:  # pragma: no cover
        return max(1e-3, getattr(profile, "gflops", 1.0))
    return bk.effective_gflops(profile)


def calibrate_accel_threshold(
    samples: Iterable[Tuple[float, float]],
    default: float = ACCEL_FLOP_THRESHOLD,
    overhead_s: float = ACCEL_DISPATCH_OVERHEAD_S,
) -> float:
    """Per-machine FLOP threshold from tracer-recorded latencies.

    ``samples`` are ``(flops, seconds)`` pairs of the *original* function
    (the tracer measures it during warmup). Accelerator dispatch pays off
    once the non-accelerator alternative's runtime exceeds the fixed
    dispatch overhead, so the break-even is ``overhead × FLOP rate``
    (median across signatures). The measured rate of the interpreted
    original is a *lower bound* on the optimized np variant's rate — the
    variant the threshold actually arbitrates against — so the computed
    break-even is a lower bound on the true one: calibration only ever
    *raises* the threshold above the static default (a fast machine
    covers more FLOPs inside the dispatch overhead), never lowers it.
    Falls back to ``default`` when no usable trace exists; capped so one
    wild timing cannot disable the accelerator entirely."""
    rates = sorted(f / s for f, s in samples if f > 0 and s > 0)
    if not rates:
        return default
    med = rates[len(rates) // 2]
    thr = overhead_s * med
    return min(max(thr, default), default * 64.0)


# ---------------------------------------------------------------------------
# Fusion profitability (core/fusion.py gate)
# ---------------------------------------------------------------------------

# Allocator cost model for parallel temporaries (per backend). A fused
# producer whose array is contracted away also skips one allocation of
# ``points × dtype_bytes``; on the np backend that allocation is a malloc
# plus first-touch page faults (disproportionately expensive for large
# temps — the `elem_chain` np-vs-jnp anomaly in BENCH_fusion.json), while
# jnp's arena allocator amortizes it almost entirely.
# The "jnp" key is the functional fusion profile, under the name the
# copied fusion module (core/fusion.py) gives it.
ALLOC_BASE_S = {"np": 2e-6, "jnp": 5e-7}
ALLOC_BW = {"np": 8e9, "jnp": 80e9}   # first-touch bytes/s


def alloc_cost_s(backend: str, nbytes: float) -> float:
    """Seconds to materialize one fresh temp of ``nbytes`` on ``backend``."""
    base = ALLOC_BASE_S.get(backend, ALLOC_BASE_S["np"])
    bw = ALLOC_BW.get(backend, ALLOC_BW["np"])
    return base + nbytes / bw


def fusion_profitable(points: float, producer_flops_pp: float, uses: int,
                      dtype_bytes: int = 8,
                      spec: ChipSpec = HOST_CPU,
                      backend: str = "np") -> bool:
    """Contract a producer's array into its consumers?

    Roofline trade: contraction removes the intermediate's memory traffic
    (one store plus one load per use) *and* its allocation (the
    per-backend ``alloc_cost_s`` term), but re-evaluates the producer
    expression at every extra use site. Fuse when the time saved
    dominates the compute term added — i.e. exactly the paper-style
    "memory-traffic dominates" condition. A single-use contraction adds no
    compute and is always profitable."""
    if uses <= 1:
        return True
    saved_bytes = (1 + uses) * points * dtype_bytes
    extra_flops = (uses - 1) * producer_flops_pp * points
    saved_s = (saved_bytes / spec.hbm_bw
               + alloc_cost_s(backend, points * dtype_bytes))
    return extra_flops / spec.peak_flops <= saved_s


def pow2_bucket(n: int) -> Tuple[int, int]:
    """Enclosing power-of-two bucket (lo, hi], lo exclusive, hi inclusive.

    4 → (2, 4]; 100 → (64, 128]; 1 → (0, 1]. Shared by the profiler's
    hint tiers and the dispatcher's bucket-guard fast path."""
    if n <= 1:
        return (0, 1)
    hi = 1
    while hi < n:
        hi <<= 1
    return (hi >> 1, hi)


def expr_flops_per_point(e, env: Optional[Dict[str, int]] = None) -> float:
    """Public wrapper over the per-point FLOP estimator (fusion gate)."""
    return _expr_flops_per_point(e, env or {})


def domain_points(dims, env: Optional[Dict[str, int]] = None) -> float:
    """Public wrapper over domain cardinality with nominal fallbacks."""
    return _card(dims, env or {})


# ---------------------------------------------------------------------------
# Roofline helpers shared with the launch-time analysis
# ---------------------------------------------------------------------------

def roofline(flops: float, bytes_hbm: float, bytes_collective: float,
             chips: int, spec: ChipSpec = H100_SXM) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops / (chips * spec.peak_flops),
        memory_s=bytes_hbm / (chips * spec.hbm_bw),
        collective_s=bytes_collective / (chips * spec.ici_bw),
    )
