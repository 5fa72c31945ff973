"""Dependence analysis over canonical SCoP statements.

Client queries (all conservative — "maybe" means "assume dependence"):

  * ``accumulation_legal``  — can an explicit `w[f] += e` loop be converted
    to a reduction (the unification step that makes PolyBench List versions
    canonicalize identically to NumPy versions)?
  * ``loop_parallel``       — is an explicit loop dependence-free across
    iterations (candidate for the paper's inter-node `pfor`)?
  * ``access_chunk_sliceable`` / ``sliceable_partition`` — inside a pfor
    body over `v`, is an array provably indexed *only* by `v` on its
    leading axis (so a distributed chunk `[lo, hi)` needs just rows
    `[lo, hi)` shipped, instead of the whole array)?
  * ``distribution_legal``  — may statements that share a loop nest be
    split into separate full-domain operations (paper §4.2: "applies loop
    distribution to split different library calls while maximizing the
    iteration domain … mapped to a single library function call")?
  * ``absorption_write_legal`` — may a loop over `v` whose statement writes
    `W[f(v,…)]` be vectorized into a full-domain op (requires that no rhs
    read of W observes an element written by an *earlier* v-iteration)?
  * ``fusion_legal``        — may two adjacent loops with identical domains
    be merged into one (the fusion pass in core/fusion.py), i.e. no
    dependence between the bodies at *different* iterations?

Tests are GCD + Banerjee over the affine access functions extracted by
core/scop.py, using iteration-domain bounds where they are constant.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .isl_lite import Affine, Domain, LoopDim, affine_eq_may_hold
from .scop import (CanonStmt, FFTStmt, Item, LoopItem, OpaqueItem, VAccess,
                   vexpr_accesses)


def _const_bounds(dim: LoopDim) -> Tuple[Optional[int], Optional[int]]:
    lo = dim.lower.const if dim.lower.is_constant() else None
    hi = dim.upper.const - 1 if dim.upper.is_constant() else None
    return (lo, hi)


def _stmt_accesses(s: CanonStmt) -> Tuple[List[VAccess], List[VAccess]]:
    """(reads, writes) of a canonical statement."""
    reads = vexpr_accesses(s.rhs)
    writes = [VAccess(s.write_array, s.write_idx, s.dtype)]
    if s.aug is not None:
        reads = reads + writes  # w op= e reads w too
    return reads, writes


def _bounds_env(*stmts: CanonStmt) -> Dict[str, Tuple[Optional[int],
                                                      Optional[int]]]:
    env: Dict[str, Tuple[Optional[int], Optional[int]]] = {}
    for s in stmts:
        for d in list(s.domain.dims) + list(s.reduce_dims()):
            env[d.var] = _const_bounds(d)
    return env


def accesses_may_conflict(
    a: VAccess,
    b: VAccess,
    bounds: Dict[str, Tuple[Optional[int], Optional[int]]],
    rename: Dict[str, str],
) -> bool:
    """May a and b (same array) touch the same element, with b's iterators
    renamed per ``rename`` (to model a distinct iteration)?"""
    if a.array != b.array:
        return False
    if len(a.idx) != len(b.idx):
        return True  # rank confusion: be conservative
    env = {k: Affine.var(v) for k, v in rename.items()}
    for ia, ib in zip(a.idx, b.idx):
        ib2 = ib.substitute(env)
        bb = dict(bounds)
        for k, v in rename.items():
            if k in bounds:
                bb[v] = bounds[k]
        if not affine_eq_may_hold(ia, ib2, bb):
            return False  # this dimension can never match
    return True


# ---------------------------------------------------------------------------
# Query 1: accumulation → reduction conversion
# ---------------------------------------------------------------------------

def accumulation_legal(stmt: CanonStmt,
                       reduce_dims: List[LoopDim]) -> bool:
    """`w[f(outs)] += e(reads)` over the reduce iterators is a sum
    reduction iff the write index does not involve them and the rhs never
    reads the written array at a *different* element (reads provably
    disjoint from the write — e.g. ``B[k,j]`` with ``k >= i+1`` vs write
    ``B[i,j]`` — are fine)."""
    reduce_vars = [d.var for d in reduce_dims]
    dim_of = {d.var: d for d in reduce_dims}
    for idx in stmt.write_idx:
        if any(v in reduce_vars for v in idx.vars()):
            return False
    for acc in vexpr_accesses(stmt.rhs):
        if acc.array != stmt.write_array:
            continue
        if len(acc.idx) != len(stmt.write_idx):
            return False
        # safe iff every dim matches exactly OR some dim provably differs
        some_dim_disjoint = False
        all_dims_equal = True
        for ia, iw in zip(acc.idx, stmt.write_idx):
            diff = ia - iw
            if diff.is_zero():
                continue
            all_dims_equal = False
            if _provably_nonzero(diff, dim_of):
                some_dim_disjoint = True
        if not (all_dims_equal or some_dim_disjoint):
            return False
    return True


def _provably_nonzero(diff: Affine, dim_of: Dict[str, LoopDim]) -> bool:
    """Is diff ≠ 0 throughout the iteration space? Handles the pattern
    diff = k - i + c where k is a reduce var with lower bound i + d (so
    diff >= d + c) or upper bound i + d (so diff <= d - 1 + c)."""
    vars_ = list(diff.vars())
    red = [v for v in vars_ if v in dim_of]
    if len(red) != 1:
        return False
    k = red[0]
    ck = diff.coeff(k)
    if abs(ck) != 1:
        return False
    dim = dim_of[k]
    # rest = diff - ck*k must be exactly -ck * (bound-var part)
    rest = diff.drop([k])
    # lower bound: k >= lower ⇒ ck*k + rest >= ck*lower + rest (ck=1)
    if ck == 1:
        low = dim.lower * 1 + rest  # diff >= lower + rest
        if low.is_constant() and low.const > 0:
            return True
        # symbolic: lower + rest reduces to positive const after cancel
        if not low.is_constant():
            return False
        return False
    else:
        # ck == -1: diff = -k + rest <= -(lower) + rest
        hi = rest - dim.lower
        if hi.is_constant() and hi.const < 0:
            return True
        return False


def _provably_nonneg(diff: Affine, dim_of: Dict[str, LoopDim]) -> bool:
    """Is diff >= 0 throughout the iteration space? Handles diff = u - i + c
    where u is an iterator with lower bound i + d (so diff >= d + c)."""
    if diff.is_constant():
        return diff.const >= 0
    vars_ = [v for v in diff.vars() if v in dim_of]
    if len(vars_) != 1:
        return False
    u = vars_[0]
    if diff.coeff(u) != 1:
        return False
    # diff >= lower(u) + (diff - u)
    low = dim_of[u].lower + diff.drop([u])
    return low.is_constant() and low.const >= 0


def absorption_write_legal(stmt: CanonStmt, dim: LoopDim) -> bool:
    """May the explicit loop over ``dim`` be folded into the statement's
    domain when the write index uses the loop iterator?

    Vectorizing evaluates the whole rhs before any element is stored, so
    every rhs read of the written array must observe only elements written
    by the *same or a later* iteration of ``dim`` (forward reads see the
    original values either way; backward reads are a recurrence, e.g.
    ``a[i] = a[i-1] * 2`` — the loop must stay explicit)."""
    v = dim.var
    dim_of = {d.var: d
              for d in list(stmt.domain.dims) + list(stmt.reduce_dims())}
    dim_of[v] = dim
    for acc in vexpr_accesses(stmt.rhs):
        if acc.array != stmt.write_array:
            continue
        if len(acc.idx) != len(stmt.write_idx):
            return False
        for ia, iw in zip(acc.idx, stmt.write_idx):
            if iw.coeff(v) == 0 and ia.coeff(v) == 0:
                # dimension independent of v: atomic within one iteration
                continue
            if iw.coeff(v) != 1:
                return False
            if not _provably_nonneg(ia - iw, dim_of):
                return False
    return True


# ---------------------------------------------------------------------------
# Query 2: chunk sliceability (distributed data movement)
# ---------------------------------------------------------------------------

def access_chunk_sliceable(acc: VAccess, v: str) -> bool:
    """May this access be satisfied by shipping only rows ``[lo, hi)`` of
    the array's leading axis to the worker executing pfor chunk
    ``v in [lo, hi)``?

    True iff the leading index is *exactly* the pfor iterator (coefficient
    1, no other terms — an offset like ``A[v+1]`` would step outside the
    shipped rows) and ``v`` appears in no other index dimension (``W[v,v]``
    touches a column the chunk's rows don't bound). Whole-array accesses
    (empty index) read rows outside the chunk and are never sliceable."""
    if not acc.idx:
        return False
    if not (acc.idx[0] - Affine.var(v)).is_zero():
        return False
    return all(v not in idx.vars() for idx in acc.idx[1:])


def sliceable_partition(accesses_by_array: Dict[str, List[VAccess]],
                        v: str,
                        disqualified: frozenset = frozenset()) -> List[str]:
    """Arrays every one of whose accesses in a pfor body over ``v`` is
    chunk-sliceable (see :func:`access_chunk_sliceable`); ``disqualified``
    names arrays with non-affine/unknown accesses (opaque items, FFT
    whole-array reads, privatized locals) that must ship whole."""
    out: List[str] = []
    for array, accs in accesses_by_array.items():
        if array in disqualified or not accs:
            continue
        if all(access_chunk_sliceable(a, v) for a in accs):
            out.append(array)
    return out


# ---------------------------------------------------------------------------
# Query 3: explicit-loop parallelism (pfor detection)
# ---------------------------------------------------------------------------

def _collect_canon(items: List[Item]) -> Tuple[List[CanonStmt], bool]:
    """All CanonStmts under items; bool=True if an opaque/fft blocks
    analysis."""
    out: List[CanonStmt] = []
    blocked = False
    for it in items:
        if isinstance(it, CanonStmt):
            out.append(it)
        elif isinstance(it, LoopItem):
            sub, b = _collect_canon(it.body)
            out.extend(sub)
            blocked = blocked or b
        elif isinstance(it, FFTStmt):
            # fft reads src fully / writes out fully; treat as canon-like
            out.append(CanonStmt(
                write_array=it.out, write_idx=(), domain=Domain(()),
                rhs=VAccess(it.src, ()), write_full=True,
                label="fft-shim"))
        else:
            blocked = True
    return out, blocked


def _private_arrays(stmts: List[CanonStmt], params: frozenset) -> set:
    """Arrays whose first access within one iteration is a full overwrite:
    privatizable (one fresh copy per iteration), so they carry no
    loop-carried dependence. Kernel parameters escape and never qualify."""
    first: Dict[str, str] = {}
    for s in stmts:
        for acc in vexpr_accesses(s.rhs):
            first.setdefault(acc.array, "read")
        kind = "w_full" if (s.write_full or s.write_is_temp) else "other"
        if s.aug is not None:
            kind = "other"
        first.setdefault(s.write_array, kind)
    return {a for a, k in first.items()
            if k == "w_full" and a not in params}


def loop_parallel(loop: LoopItem, params=()) -> bool:
    """True iff no loop-carried dependence on loop.dim.var.

    For every (write W of S1, access A of S2) pair on the same array, ask
    whether W at iteration v can equal A at iteration v' ≠ v. We encode
    v' as a renamed variable and use the affine may-equal test; if all
    dimensions can simultaneously match AND the index functions do not pin
    v = v', the loop is not provably parallel."""
    stmts, blocked = _collect_canon(loop.body)
    if blocked:
        return False
    private = _private_arrays(stmts, frozenset(params))
    v = loop.dim.var
    vp = v + "__p"
    bounds = _bounds_env(*[s for s in stmts if isinstance(s, CanonStmt)])
    bounds[vp] = bounds.get(v, _const_bounds(loop.dim))
    for s1 in stmts:
        _, writes1 = _stmt_accesses(s1)
        for s2 in stmts:
            reads2, writes2 = _stmt_accesses(s2)
            for w in writes1:
                for a in reads2 + writes2:
                    if w.array != a.array:
                        continue
                    if w.array in private:
                        continue
                    if w is a and s1 is s2:
                        continue
                    if not accesses_may_conflict(w, a, bounds, {v: vp}):
                        continue
                    # Conflict possible under renaming. It is still fine if
                    # equality *forces* v == v' (same-iteration dep): check
                    # whether for every dim pair the difference depends on v
                    # in a way that pins v == v'.
                    if _pins_same_iteration(w, a, v, vp):
                        continue
                    return False
    return True


def _pins_same_iteration(w: VAccess, a: VAccess, v: str, vp: str) -> bool:
    """True if w.idx == a.idx[v→vp] implies v == vp (some dimension is
    c*v + f(params) on both sides with equal nonzero c)."""
    env = {v: Affine.var(vp)}
    for ia, ib in zip(w.idx, a.idx):
        ib2 = ib.substitute(env)
        diff = ia - ib2
        cv, cvp = diff.coeff(v), diff.coeff(vp)
        if cv != 0 and cv == -cvp:
            rest = diff.drop([v, vp])
            if rest.is_zero():
                return True
    return False


# ---------------------------------------------------------------------------
# Query 4: loop distribution legality
# ---------------------------------------------------------------------------

def distribution_legal(stmts: List[CanonStmt],
                       shared_vars: List[str]) -> bool:
    """May S1;S2;… inside a common nest over shared_vars be executed as
    'all iterations of S1, then all of S2, …'?

    Illegal iff some later statement S_b writes data that an earlier S_a
    accesses at a *later* iteration (a backward dependence S_b@(i) →
    S_a@(i') with i' > i). We conservatively reject whenever a later
    statement's write may conflict with an earlier statement's access at
    any *different* iteration of the shared vars."""
    bounds = _bounds_env(*stmts)
    rename = {vv: vv + "__p" for vv in shared_vars}
    for vv, vr in rename.items():
        bounds[vr] = bounds.get(vv, (None, None))
    for ib_ in range(len(stmts)):
        for ia_ in range(ib_):
            s_a, s_b = stmts[ia_], stmts[ib_]
            reads_a, writes_a = _stmt_accesses(s_a)
            _, writes_b = _stmt_accesses(s_b)
            for w in writes_b:
                for acc in reads_a + writes_a:
                    if w.array != acc.array:
                        continue
                    if not accesses_may_conflict(w, acc, bounds, rename):
                        continue
                    pinned = all(
                        _pins_same_iteration(w, acc, vv, vr)
                        for vv, vr in rename.items())
                    if pinned and rename:
                        continue  # only same-iteration conflicts: forward
                    return False
    return True


# ---------------------------------------------------------------------------
# Query 5: loop fusion legality (core/fusion.py)
# ---------------------------------------------------------------------------

def fusion_legal(before: List[CanonStmt], after: List[CanonStmt],
                 shared_vars: List[str]) -> bool:
    """May 'for v: before' followed by 'for v: after' (identical domains,
    iterators already renamed to the shared names) be merged into a single
    loop 'for v: before; after'?

    Fusing makes iteration i of ``after`` run before iteration i' > i of
    ``before``, and iteration i of ``before`` run before iteration i of
    ``after`` (instead of after all of them). Banerjee gives no dependence
    direction, so we conservatively require every cross-loop conflict on a
    shared array to pin the *same* iteration of every shared var — those
    dependences are preserved verbatim by fusion."""
    bounds = _bounds_env(*(list(before) + list(after)))
    rename = {vv: vv + "__p" for vv in shared_vars}
    for vv, vr in rename.items():
        bounds[vr] = bounds.get(vv, (None, None))
    for s1 in before:
        for s2 in after:
            reads1, writes1 = _stmt_accesses(s1)
            reads2, writes2 = _stmt_accesses(s2)
            pairs = [(w, a) for w in writes1 for a in reads2 + writes2]
            pairs += [(w, a) for w in writes2 for a in reads1 + writes1]
            for w, a in pairs:
                if w.array != a.array:
                    continue
                if not accesses_may_conflict(w, a, bounds, rename):
                    continue
                pinned = rename and all(
                    _pins_same_iteration(w, a, vv, vr)
                    for vv, vr in rename.items())
                if not pinned:
                    return False
    return True
