"""Polyhedral-lite scheduling (paper §4.2, built on the PolyAST policies).

Two optimization policies, exactly as the paper states them:

  * INTRA-NODE — "apply loop distribution to split different library calls
    while maximizing the iteration domain that can be mapped to a single
    library function call": explicit loops are *absorbed* into the domains
    of the canonical statements they enclose (turning accumulation loops
    into reductions), subject to dependence legality, so each statement
    becomes one maximal library call for raising.

  * INTER-NODE — "maximize outermost level parallelism": outermost loops
    that cannot be absorbed (e.g. they enclose materialization points like
    FFT) but are dependence-free across iterations become `pfor` units,
    tiled for distribution across workers (paper Fig 7c).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from . import dependence
from .isl_lite import Affine, Domain, LoopDim
from .scop import (CanonStmt, FFTStmt, Item, LoopItem, OpaqueItem,
                   ScopProgram, VAccess, VReduce, vexpr_accesses)


# ---------------------------------------------------------------------------
# Schedule units (consumed by codegen)
# ---------------------------------------------------------------------------

@dataclass
class RaisedUnit:
    stmt: CanonStmt


@dataclass
class FFTUnit:
    stmt: FFTStmt


@dataclass
class OpaqueUnit:
    item: OpaqueItem


@dataclass
class SeqLoopUnit:
    dim: LoopDim
    body: List["Unit"]


@dataclass
class PforUnit:
    """Iterations of ``dim`` are independent; body units treat dim.var as a
    bound scalar. ``tile`` is the distribution chunk (None = runtime).
    ``sliceable`` names captured arrays the body provably indexes only by
    ``dim.var`` on their leading axis — the cluster runtime ships each
    worker just its chunk's rows of those instead of broadcasting them
    (set by :func:`_pfor_sliceable` after fusion). ``accel_feasible`` is
    the schedule-level pre-check for a per-unit accelerator twin body
    (no black-box statements anywhere in the body); codegen still owns
    the final word, since loop fallbacks only surface at emit time."""

    dim: LoopDim
    body: List["Unit"]
    tile: Optional[int] = None
    sliceable: Tuple[str, ...] = ()
    accel_feasible: bool = True


Unit = Union[RaisedUnit, FFTUnit, OpaqueUnit, SeqLoopUnit, PforUnit]


@dataclass
class Schedule:
    program: ScopProgram
    units: List[Unit]
    # names of arrays written anywhere (for functional-backend returns)
    written: List[str] = field(default_factory=list)
    has_opaque: bool = False
    has_pfor: bool = False
    # telemetry from the producer–consumer fusion pass (core/fusion.py);
    # None when the pass was disabled or the entry predates it
    fusion: Optional[object] = None


# ---------------------------------------------------------------------------
# Loop absorption (intra-node maximization)
# ---------------------------------------------------------------------------

def _absorb_loop(loop: LoopItem) -> Optional[List[CanonStmt]]:
    """Try to fold the explicit loop into its statements' domains.
    Returns flattened CanonStmts or None if the loop must stay explicit."""
    flat: List[CanonStmt] = []
    for item in loop.body:
        if isinstance(item, CanonStmt):
            flat.append(item)
        elif isinstance(item, LoopItem):
            sub = _absorb_loop(item)
            if sub is None:
                return None
            flat.extend(sub)
        else:
            return None  # FFT / opaque: materialization point blocks

    v = loop.dim.var
    out: List[CanonStmt] = []
    for s in flat:
        writes_use = any(v in idx.vars() for idx in s.write_idx)
        rhs_use = any(
            v in a_idx.vars()
            for acc in vexpr_accesses(s.rhs) for a_idx in acc.idx)
        bounds_use = any(
            v in b.vars()
            for d in list(s.domain.dims) + list(s.reduce_dims())
            for b in (d.lower, d.upper))
        if writes_use:
            # v is an out iterator: prepend (outer-first domain order),
            # unless the rhs reads elements the loop wrote at an earlier
            # iteration (a recurrence — vectorizing would read stale data)
            if not dependence.absorption_write_legal(s, loop.dim):
                return None
            out.append(CanonStmt(
                write_array=s.write_array, write_idx=s.write_idx,
                domain=Domain((loop.dim,) + s.domain.dims),
                rhs=s.rhs, aug=s.aug, write_is_temp=s.write_is_temp,
                write_full=s.write_full, label=s.label, dtype=s.dtype))
        elif rhs_use or bounds_use:
            if s.aug == "+" and dependence.accumulation_legal(s, [loop.dim]):
                out.append(CanonStmt(
                    write_array=s.write_array, write_idx=s.write_idx,
                    domain=s.domain,
                    rhs=VReduce("sum", (loop.dim,), s.rhs),
                    aug="+", write_is_temp=s.write_is_temp,
                    write_full=s.write_full, label=s.label, dtype=s.dtype))
            else:
                return None  # last-value / recurrence: keep loop explicit
        else:
            reads_own_write = any(
                acc.array == s.write_array
                for acc in vexpr_accesses(s.rhs))
            if s.aug is None and not reads_own_write:
                out.append(s)  # loop-invariant: hoist (LICM)
            else:
                # aug or self-read: a recurrence independent of v —
                # executing it once is not executing it N times
                return None

    # Distribution legality: absorbing executes all iterations of each
    # statement before the next statement.
    if len(flat) > 1 and not dependence.distribution_legal(flat, [v]):
        return None
    return out


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def _schedule_items(items: List[Item], depth: int, distribute: bool,
                    params: frozenset) -> List[Unit]:
    units: List[Unit] = []
    for item in items:
        if isinstance(item, CanonStmt):
            units.append(RaisedUnit(item))
        elif isinstance(item, FFTStmt):
            units.append(FFTUnit(item))
        elif isinstance(item, OpaqueItem):
            units.append(OpaqueUnit(item))
        elif isinstance(item, LoopItem):
            absorbed = _absorb_loop(item)
            if absorbed is not None:
                units.extend(RaisedUnit(s) for s in absorbed)
                continue
            par = dependence.loop_parallel(item, params)
            body = _schedule_items(item.body, depth + 1, distribute, params)
            if par and depth == 0 and distribute:
                units.append(PforUnit(item.dim, body))
            else:
                units.append(SeqLoopUnit(item.dim, body))
        else:  # pragma: no cover
            raise TypeError(type(item))
    return units


def _pfor_sliceable(u: PforUnit) -> Tuple[str, ...]:
    """Per-array chunk sliceability for one pfor unit (the
    data-movement lever). Collects every access each array sees inside
    the body — reads, writes, aug-reads — and keeps arrays whose accesses
    are all provably ``arr[v, f(...)]`` with ``v`` the pfor iterator
    (:func:`dependence.access_chunk_sliceable`). Materialization points
    (FFT whole-array reads, opaque statements) and privatized locals
    (full overwrites / compiler temps — they never become closure cells)
    disqualify their arrays."""
    v = u.dim.var
    accesses: Dict[str, List] = {}
    disq: set = set()

    def add(acc) -> None:
        accesses.setdefault(acc.array, []).append(acc)

    def walk(units: List[Unit]) -> None:
        for unit in units:
            if isinstance(unit, RaisedUnit):
                s = unit.stmt
                if s.write_full or s.write_is_temp:
                    # assigned whole inside the body: a body-local
                    # (privatized) name, never a shipped closure cell
                    disq.add(s.write_array)
                else:
                    add(VAccess(s.write_array, s.write_idx, s.dtype))
                for acc in vexpr_accesses(s.rhs):
                    add(acc)
            elif isinstance(unit, FFTUnit):
                disq.add(unit.stmt.src)   # read whole per iteration
                disq.add(unit.stmt.out)
            elif isinstance(unit, OpaqueUnit):
                disq.update(unit.item.reads)
                disq.update(unit.item.writes)
            elif isinstance(unit, (SeqLoopUnit, PforUnit)):
                walk(unit.body)

    walk(u.body)
    return tuple(dependence.sliceable_partition(
        accesses, v, frozenset(disq)))


def _written_arrays(units: List[Unit]) -> List[str]:
    seen: List[str] = []

    def add(n: str):
        if n not in seen:
            seen.append(n)

    def rec(us: List[Unit]):
        for u in us:
            if isinstance(u, RaisedUnit):
                add(u.stmt.write_array)
            elif isinstance(u, FFTUnit):
                add(u.stmt.out)
            elif isinstance(u, OpaqueUnit):
                for w in u.item.writes:
                    add(w)
            elif isinstance(u, (SeqLoopUnit, PforUnit)):
                rec(u.body)

    rec(units)
    return seen


def schedule(program: ScopProgram, distribute: bool = True,
             fuse: bool = True,
             fusion_profile: str = "functional") -> Schedule:
    params = frozenset(n for n, _ in program.fn.params)
    units = _schedule_items(program.items, 0, distribute, params)
    sched = Schedule(program, units)
    # per-stage perf_counter stamps: the compiler turns these into
    # compile-pipeline spans/metrics (this module stays obs-free)
    stage_spans: List[Tuple[str, float, float]] = []
    if fuse:
        from . import fusion  # deferred: fusion → cost → schedule
        t0 = time.perf_counter()
        fusion.fuse(sched, profile=fusion_profile)
        stage_spans.append(("fusion", t0, time.perf_counter()))
    sched.written = _written_arrays(sched.units)
    # chunk-sliceability is a property of the *post-fusion* body: fusion
    # may rewrite accesses, so the analysis runs on what codegen will emit
    t0 = time.perf_counter()
    for u in _flatten(sched.units):
        if isinstance(u, PforUnit):
            u.sliceable = _pfor_sliceable(u)
            u.accel_feasible = not any(
                isinstance(b, OpaqueUnit) for b in _flatten(u.body))
    stage_spans.append(("dependence", t0, time.perf_counter()))
    sched.stage_spans = stage_spans
    sched.has_opaque = any(
        isinstance(u, OpaqueUnit) for u in _flatten(sched.units))
    sched.has_pfor = any(
        isinstance(u, PforUnit) for u in _flatten(sched.units))
    return sched


def _flatten(units: List[Unit]):
    for u in units:
        yield u
        if isinstance(u, (SeqLoopUnit, PforUnit)):
            yield from _flatten(u.body)
