"""Producer–consumer fusion with array contraction (post-scheduling pass).

The scheduler's distribution/absorption policies deliberately split the
kernel into maximal per-statement library calls; every unit then
materializes its full output before the next unit reads it. This pass runs
*after* scheduling and walks the unit lists looking for three patterns the
polyhedral literature calls profitable (Klöckner's loo.py fusion, the
data-centric Python map fusion of Ziogas et al.):

  1. SAME-ARRAY FLOW FUSION — ``W = e1`` (or ``W op= e1``) followed by
     ``W op= e2`` over an identical iteration domain collapses into a
     single statement ``W = combine(e1, e2)``. One full store+load round
     trip over W disappears (the PolyBench List idiom ``C *= beta;
     C += alpha·A@B`` becomes the single fused statement the hand-written
     NumPy version expresses directly).

  2. ARRAY CONTRACTION — a kernel-local intermediate written once and read
     only by later sibling statements is forward-substituted into its use
     sites and its definition deleted, so codegen never allocates the full
     array. Gated by the roofline model: substitution that would duplicate
     an expensive producer (e.g. a contraction feeding several reads) is
     rejected, keeping the single library call — the paper's "maximal
     library call" policy wins whenever compute dominates.

  3. LOOP FUSION — adjacent sequential loops with identical domains merge
     when every cross-loop dependence pins the same iteration
     (``dependence.fusion_legal``), which then exposes (1)/(2) across the
     former loop boundary.

All rewrites preserve the statement-atomic semantics both backends
guarantee (rhs fully evaluated before the store); the loop-fallback
emitter snapshots self-read arrays to keep that contract (codegen.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from . import cost, dependence
from .isl_lite import Affine, Domain, LoopDim
from .schedule import (FFTUnit, OpaqueUnit, PforUnit, RaisedUnit,
                       SeqLoopUnit, Unit)
from .scop import (CanonStmt, VAccess, VBin, VConst, VExpr, VParam, VReduce,
                   VUnary, fresh, substitute_array_reads, substitute_vexpr,
                   vexpr_accesses)


@dataclass
class FusionStats:
    """Telemetry recorded on the Schedule (surfaced via kernel stats)."""

    fused_units: int = 0
    contracted_arrays: List[str] = field(default_factory=list)
    loops_fused: int = 0
    rejected: int = 0
    log: List[str] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Expression / unit helpers
# ---------------------------------------------------------------------------

def _pure_var(a: Affine) -> Optional[str]:
    if a.const != 0 or len(a.coeffs) != 1:
        return None
    (v, c), = a.coeffs
    return v if c == 1 else None


def _freshen_reduce_vars(e: VExpr) -> VExpr:
    """Alpha-rename every VReduce iterator so substituting the producer
    into a consumer cannot capture the consumer's iterators."""
    if isinstance(e, VReduce):
        env: Dict[str, Affine] = {}
        dims = []
        for d in e.dims:
            nv = fresh("fz")
            # triangular bounds may reference earlier sibling iterators:
            # rename them too (with the env accumulated so far)
            lo, hi = d.lower.substitute(env), d.upper.substitute(env)
            env[d.var] = Affine.var(nv)
            dims.append(LoopDim(nv, lo, hi, d.step))
        child = substitute_vexpr(_freshen_reduce_vars(e.child), env)
        return VReduce(e.op, tuple(dims), child)
    if isinstance(e, VBin):
        return VBin(e.op, _freshen_reduce_vars(e.left),
                    _freshen_reduce_vars(e.right))
    if isinstance(e, VUnary):
        return VUnary(e.fn, _freshen_reduce_vars(e.operand))
    return e


def _stmt_read_arrays(s: CanonStmt) -> Set[str]:
    out = {a.array for a in vexpr_accesses(s.rhs)}
    if s.aug is not None:
        out.add(s.write_array)
    return out


def _unit_reads_writes(u: Unit) -> Tuple[Set[str], Set[str]]:
    if isinstance(u, RaisedUnit):
        return _stmt_read_arrays(u.stmt), {u.stmt.write_array}
    if isinstance(u, FFTUnit):
        return {u.stmt.src}, {u.stmt.out}
    if isinstance(u, OpaqueUnit):
        return set(u.item.reads), set(u.item.writes)
    reads: Set[str] = set()
    writes: Set[str] = set()
    for b in u.body:
        r, w = _unit_reads_writes(b)
        reads |= r
        writes |= w
    return reads, writes


def _stmt_affine_vars(s: CanonStmt) -> Set[str]:
    out: Set[str] = set()
    for d in list(s.domain.dims) + list(s.reduce_dims()):
        out.update(d.lower.vars())
        out.update(d.upper.vars())
    for idx in s.write_idx:
        out.update(idx.vars())
    for acc in vexpr_accesses(s.rhs):
        for idx in acc.idx:
            out.update(idx.vars())
    return out


def _unit_affine_vars(u: Unit) -> Set[str]:
    if isinstance(u, RaisedUnit):
        return _stmt_affine_vars(u.stmt)
    if isinstance(u, FFTUnit):
        return set(u.stmt.n.vars()) if u.stmt.n is not None else set()
    if isinstance(u, OpaqueUnit):
        return set()
    out = set(u.dim.lower.vars()) | set(u.dim.upper.vars())
    for b in u.body:
        out |= _unit_affine_vars(b)
    return out


def _subst_stmt_affines(s: CanonStmt, env: Dict[str, Affine]) -> CanonStmt:
    dims = tuple(LoopDim(d.var, d.lower.substitute(env),
                         d.upper.substitute(env), d.step)
                 for d in s.domain.dims)
    return CanonStmt(
        write_array=s.write_array,
        write_idx=tuple(i.substitute(env) for i in s.write_idx),
        domain=Domain(dims), rhs=substitute_vexpr(s.rhs, env), aug=s.aug,
        write_is_temp=s.write_is_temp, write_full=s.write_full,
        label=s.label, dtype=s.dtype)


def _is_const(e: VExpr, value: float) -> bool:
    return isinstance(e, VConst) and isinstance(e.value, (int, float)) \
        and float(e.value) == value


def _combine(op: str, left: VExpr, right: VExpr) -> VExpr:
    """left ∘ right with identity-element folding (0 + x → x, 1·x → x)."""
    if op == "+" and _is_const(left, 0.0):
        return right
    if op == "+" and _is_const(right, 0.0):
        return left
    if op == "*" and _is_const(left, 1.0):
        return right
    if op == "*" and _is_const(right, 1.0):
        return left
    return VBin(op, left, right)


def _stored_value(s: CanonStmt) -> Optional[VExpr]:
    """The full value the statement stores, as an expression over the
    statement's own iterators (aug forms expand their implicit read)."""
    if s.aug is None:
        return s.rhs
    if s.aug in ("+", "*"):
        return _combine(s.aug, VAccess(s.write_array, s.write_idx, s.dtype),
                        s.rhs)
    return None


# ---------------------------------------------------------------------------
# Domain matching (producer write space → consumer write space)
# ---------------------------------------------------------------------------

def _iter_env(p: CanonStmt, c: CanonStmt) -> Optional[Dict[str, Affine]]:
    """Positional iterator renaming that maps p's write onto c's write,
    requiring identical domains (bounds and step) after renaming."""
    if len(p.write_idx) != len(c.write_idx):
        return None
    if p.domain.rank() != c.domain.rank():
        return None
    names: Dict[str, str] = {}
    for ip, ic in zip(p.write_idx, c.write_idx):
        pv, cv = _pure_var(ip), _pure_var(ic)
        if pv is None and cv is None:
            if not ip.equals(ic):
                return None
            continue
        if pv is None or cv is None:
            return None
        if pv in names:
            if names[pv] != cv:
                return None
        else:
            names[pv] = cv
    pd = {d.var: d for d in p.domain.dims}
    cd = {d.var: d for d in c.domain.dims}
    for v, t in names.items():
        if v not in pd and v != t:
            return None  # enclosing bound iterator: must map to itself
    mapped = {}
    for v in pd:
        if v not in names or names[v] not in cd:
            return None
        mapped[v] = names[v]
    if len(set(mapped.values())) != len(cd):
        return None
    env = {k: Affine.var(v) for k, v in names.items()}
    for v, d in pd.items():
        d2 = cd[mapped[v]]
        if d.step != d2.step:
            return None
        if not d.lower.substitute(env).equals(d2.lower):
            return None
        if not d.upper.substitute(env).equals(d2.upper):
            return None
    return env


# ---------------------------------------------------------------------------
# Pattern 1: same-array flow fusion (W = e1 ; W op= e2)
# ---------------------------------------------------------------------------

def _reads_of_w_pinned(c: CanonStmt) -> bool:
    """Every explicit consumer read of its own write array must be at
    exactly the written element — reads at other elements would observe
    the producer's value at a different point in time."""
    for acc in vexpr_accesses(c.rhs):
        if acc.array != c.write_array:
            continue
        if len(acc.idx) != len(c.write_idx):
            return False
        for ia, iw in zip(acc.idx, c.write_idx):
            if not ia.equals(iw):
                return False
    return True


def _count_reads(e: VExpr, array: str) -> int:
    return sum(1 for a in vexpr_accesses(e) if a.array == array)


def _try_flow_fuse(p: CanonStmt, c: CanonStmt,
                   profile: str) -> Optional[CanonStmt]:
    if p.write_array != c.write_array:
        return None
    if p.write_full != c.write_full or p.write_is_temp != c.write_is_temp:
        return None
    if c.aug not in (None, "+", "*"):
        return None
    if profile == "inplace" and c.aug is not None:
        # the np backend executes `W op= e` in place — no temporary, no
        # separate store pass — so folding it into an expression + slice
        # store usually *adds* traffic. Only a plain constant fill
        # (`W = 0; W += e` → `W = e`) still saves a pass there; on the
        # functional profile every statement materializes the full array
        # (`.at[].set` copies), so all legal folds pay.
        if p.aug is not None or not isinstance(p.rhs, (VConst, VParam)):
            return None
    if not _reads_of_w_pinned(c):
        return None
    env = _iter_env(p, c)
    if env is None:
        return None
    value = _stored_value(p)
    if value is None:
        return None
    value = substitute_vexpr(_freshen_reduce_vars(value), env)
    # every consumer read of W — the implicit aug read AND any explicit
    # rhs access — observes the producer's stored value, so all of them
    # become the producer expression (duplication is cost-gated)
    uses = _count_reads(c.rhs, c.write_array)
    if uses:
        pts = cost.domain_points(list(c.domain.dims))
        pflops = cost.expr_flops_per_point(value)
        occurrences = uses + (1 if c.aug is not None else 0)
        if not cost.fusion_profitable(
                pts, pflops, occurrences,
                backend=_profile_backend(profile)):
            return None
        new_c_rhs = substitute_array_reads(c.rhs, c.write_array,
                                           lambda acc: value)
    else:
        new_c_rhs = c.rhs  # aug-less + no reads: dead store elimination
    if c.aug is not None:
        rhs = _combine(c.aug, value, new_c_rhs)
    else:
        rhs = new_c_rhs
    return CanonStmt(
        write_array=c.write_array, write_idx=c.write_idx, domain=c.domain,
        rhs=rhs, aug=None, write_is_temp=c.write_is_temp,
        write_full=c.write_full,
        label=f"fused:{p.label or p.write_array}+{c.label or c.write_array}",
        dtype=c.dtype or p.dtype)


def _flow_fuse_pass(units: List[Unit], stats: FusionStats,
                    profile: str) -> bool:
    for j, cu in enumerate(units):
        if not isinstance(cu, RaisedUnit):
            continue
        c = cu.stmt
        for i in range(j - 1, -1, -1):
            pu = units[i]
            if not isinstance(pu, RaisedUnit):
                break_reads, break_writes = _unit_reads_writes(pu)
                if c.write_array in (break_reads | break_writes):
                    break
                continue
            p = pu.stmt
            if p.write_array != c.write_array:
                # unrelated unit: legal to look past it only if it never
                # touches W and the producer's inputs are not written later
                continue
            fused = _try_flow_fuse(p, c, profile)
            if fused is not None and _between_clear(units, i, j, p):
                units[j] = RaisedUnit(fused)
                del units[i]
                stats.fused_units += 1
                stats.log.append(f"flow-fuse {p.write_array}: "
                                 f"{p.label} + {c.label}")
                return True
            break  # nearest same-array producer decides; don't skip it
    return False


def _between_clear(units: List[Unit], i: int, j: int,
                   p: CanonStmt) -> bool:
    """Units strictly between producer i and consumer j must not touch the
    fused array nor overwrite anything the producer reads (its evaluation
    moves to position j)."""
    w = p.write_array
    preads = _stmt_read_arrays(p)
    for k in range(i + 1, j):
        reads, writes = _unit_reads_writes(units[k])
        if w in reads or w in writes:
            return False
        if writes & preads:
            return False
    return True


# ---------------------------------------------------------------------------
# Pattern 2: array contraction (dead local temps)
# ---------------------------------------------------------------------------

def _walk_units(units: List[Unit]):
    for u in units:
        yield u
        if isinstance(u, (SeqLoopUnit, PforUnit)):
            yield from _walk_units(u.body)


def _uses_in(e: VExpr, array: str, in_reduce: bool = False):
    """Yield (access, in_reduce) for every read of ``array`` in e."""
    if isinstance(e, VAccess):
        if e.array == array:
            yield e, in_reduce
    elif isinstance(e, VBin):
        yield from _uses_in(e.left, array, in_reduce)
        yield from _uses_in(e.right, array, in_reduce)
    elif isinstance(e, VUnary):
        yield from _uses_in(e.operand, array, in_reduce)
    elif isinstance(e, VReduce):
        yield from _uses_in(e.child, array, True)


def _has_reduce(e: VExpr) -> bool:
    if isinstance(e, VReduce):
        return True
    if isinstance(e, VBin):
        return _has_reduce(e.left) or _has_reduce(e.right)
    if isinstance(e, VUnary):
        return _has_reduce(e.operand)
    return False


def _profile_backend(profile: str) -> str:
    """The cost-model backend a fusion profile arbitrates for (the
    per-backend ``alloc_cost`` term prices the eliminated temp)."""
    return "np" if profile == "inplace" else "jnp"


def _try_contract(units: List[Unit], root: List[Unit],
                  params: frozenset, stats: FusionStats,
                  profile: str) -> bool:
    for i, pu in enumerate(units):
        if not isinstance(pu, RaisedUnit):
            continue
        p = pu.stmt
        t = p.write_array
        if t in params or p.aug is not None:
            continue
        if not (p.write_full or p.write_is_temp):
            continue
        if any(_pure_var(idx) is None for idx in p.write_idx):
            continue
        writers = [u for u in _walk_units(root)
                   if isinstance(u, RaisedUnit) and u.stmt.write_array == t]
        if len(writers) != 1 or writers[0] is not pu:
            continue
        readers = []
        blocked = False
        for u in _walk_units(root):
            if isinstance(u, RaisedUnit):
                # aug re-writers of t need no clause here: any second
                # writer already failed the single-writer check above
                if any(True for _ in _uses_in(u.stmt.rhs, t)):
                    readers.append(u)
            elif isinstance(u, (FFTUnit, OpaqueUnit)):
                r, w = _unit_reads_writes(u)
                if t in r or t in w:
                    blocked = True
        if blocked or not readers:
            continue
        # every reader must be a later sibling at this level (a reader
        # nested one loop deeper would re-evaluate the producer per
        # iteration — never contract into a deeper nest)
        try:
            positions = [units.index(r) for r in readers]
        except ValueError:
            continue
        if any(pos <= i for pos in positions):
            continue
        # no unit may reference the temp's shape symbols except readers
        syms = {f"{t}__d{d}" for d in range(len(p.write_idx))}
        outside = False
        for u in _walk_units(root):
            if u is pu or u in readers:
                continue
            if isinstance(u, (SeqLoopUnit, PforUnit)):
                dvars = set(u.dim.lower.vars()) | set(u.dim.upper.vars())
                if dvars & syms:
                    outside = True
            elif _unit_affine_vars(u) & syms:
                outside = True
        if outside:
            continue
        if _contract_into(units, i, pu, readers, stats, profile):
            return True
    return False


def _contract_into(units: List[Unit], i: int, pu: RaisedUnit,
                   readers: List[RaisedUnit], stats: FusionStats,
                   profile: str) -> bool:
    p = pu.stmt
    t = p.write_array
    p_has_reduce = _has_reduce(p.rhs)
    uses = 0
    for r in readers:
        for acc, in_red in _uses_in(r.stmt.rhs, t):
            uses += 1
            if len(acc.idx) != len(p.write_idx):
                return False
            if in_red and p_has_reduce:
                # nested contraction would break einsum raising — keep
                # the producer as its own library call
                stats.rejected += 1
                return False
    pts = cost.domain_points(list(p.domain.dims))
    pflops = cost.expr_flops_per_point(p.rhs)
    if not cost.fusion_profitable(pts, pflops, uses,
                                  backend=_profile_backend(profile)):
        stats.rejected += 1
        return False
    # interference: between the producer and each reader no sibling may
    # overwrite anything the producer reads (readers themselves are
    # statement-atomic, so their own writes are safe)
    preads = _stmt_read_arrays(p)
    last = max(units.index(r) for r in readers)
    for k in range(i + 1, last + 1):
        u = units[k]
        reads, writes = _unit_reads_writes(u)
        if u in readers:
            if writes & preads and units.index(u) != last:
                return False
            continue
        if writes & preads:
            return False
    # substitute: T[f0..fk] → producer rhs with o_k := f_k, and the
    # temp's shape symbols → producer domain extents
    pvars = [_pure_var(idx) for idx in p.write_idx]
    dim_by_var = {d.var: d for d in p.domain.dims}
    sym_env = {}
    for d, v in enumerate(pvars):
        if v in dim_by_var:
            sym_env[f"{t}__d{d}"] = dim_by_var[v].extent()

    def builder(acc: VAccess) -> VExpr:
        value = _freshen_reduce_vars(p.rhs)
        env = {v: acc.idx[k] for k, v in enumerate(pvars)}
        return substitute_vexpr(value, env)

    for r in readers:
        pos = units.index(r)
        s = r.stmt
        new_rhs = substitute_array_reads(s.rhs, t, builder)
        ns = CanonStmt(
            write_array=s.write_array, write_idx=s.write_idx,
            domain=s.domain, rhs=new_rhs, aug=s.aug,
            write_is_temp=s.write_is_temp, write_full=s.write_full,
            label=s.label, dtype=s.dtype)
        units[pos] = RaisedUnit(_subst_stmt_affines(ns, sym_env))
    del units[i]
    stats.fused_units += 1
    stats.contracted_arrays.append(t)
    stats.log.append(f"contract {t} into {len(readers)} consumer(s)")
    return True


# ---------------------------------------------------------------------------
# Pattern 3: adjacent sequential-loop fusion
# ---------------------------------------------------------------------------

def _try_loop_fuse(u1: SeqLoopUnit, u2: SeqLoopUnit,
                   stats: FusionStats) -> Optional[SeqLoopUnit]:
    d1, d2 = u1.dim, u2.dim
    if d1.step != d2.step:
        return None
    if not (d1.lower.equals(d2.lower) and d1.upper.equals(d2.upper)):
        return None
    if not all(isinstance(b, RaisedUnit) for b in u1.body + u2.body):
        return None
    body2 = [b.stmt for b in u2.body]
    if d1.var != d2.var:
        used = set()
        for s in body2:
            used |= _stmt_affine_vars(s)
        if d1.var in used:
            return None  # renaming would capture
        env = {d2.var: Affine.var(d1.var)}
        body2 = [_subst_stmt_affines(s, env) for s in body2]
    body1 = [b.stmt for b in u1.body]
    if not dependence.fusion_legal(body1, body2, [d1.var]):
        stats.rejected += 1
        return None
    return SeqLoopUnit(d1, [RaisedUnit(s) for s in body1 + body2])


def _loop_fuse_pass(units: List[Unit], stats: FusionStats) -> bool:
    for i in range(len(units) - 1):
        u1, u2 = units[i], units[i + 1]
        if isinstance(u1, SeqLoopUnit) and isinstance(u2, SeqLoopUnit):
            fused = _try_loop_fuse(u1, u2, stats)
            if fused is not None:
                units[i] = fused
                del units[i + 1]
                stats.loops_fused += 1
                stats.log.append(f"loop-fuse {u1.dim.var}")
                return True
    return False


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def _fuse_level(units: List[Unit], root: List[Unit], params: frozenset,
                stats: FusionStats, profile: str) -> None:
    for u in units:
        if isinstance(u, (SeqLoopUnit, PforUnit)):
            _fuse_level(u.body, root, params, stats, profile)
    changed = True
    while changed:
        changed = (_loop_fuse_pass(units, stats)
                   or _flow_fuse_pass(units, stats, profile)
                   or _try_contract(units, root, params, stats,
                                    profile))
        if changed:
            # merged loop bodies expose new intra-body opportunities
            for u in units:
                if isinstance(u, (SeqLoopUnit, PforUnit)):
                    _fuse_level(u.body, root, params, stats, profile)


def fuse(sched, profile: str = "functional") -> FusionStats:
    """Run the fusion pass in place on a Schedule.

    ``profile`` names the backend's memory behaviour for the cost gate:
    ``"functional"`` (jnp — every statement materializes its full output,
    all legal fusions save traffic) or ``"inplace"`` (np — aug statements
    already run in place, so only contraction, pure forward substitution,
    and constant-fill folding pay). Returns the stats that are also
    recorded on ``sched.fusion``."""
    assert profile in ("functional", "inplace")
    params = frozenset(n for n, _ in sched.program.fn.params)
    stats = FusionStats()
    _fuse_level(sched.units, sched.units, params, stats, profile)
    sched.fusion = stats
    return stats
