"""Kernel-shape pattern matching over scheduled pfor units.

The cuda backend (``core/backends.py``) does not lower arbitrary unit
bodies: it recognizes fixed shapes and rewrites each onto a hand-written
CUDA kernel behind :mod:`repro_torch.kernels.api` (bound as ``__cuk`` in
the twin's namespace). It recognizes three shapes: matmul-,
attention- and scan-shaped pfor bodies. Matching is deliberately
conservative: any structure outside the template (extra statements,
augmented writes, non-unit strides, affine indices that are not plain
loop variables, bounds that depend on the pfor variable or on
codegen-internal shape symbols) means *no match* and the unit simply
keeps its np body.

A match produces the twin's body lines in chunk form: the pfor variable
``g`` becomes the block slice ``__lo:__hi`` and every reduction /
free dimension becomes its hull-bound slice, so one ``__cuk`` call
covers the whole chunk. Writes go through the captured numpy arrays
(:class:`repro_torch.distrib.serial.ChunkSlice` re-bases slice keys on
the leading axis, so global ``[__lo:__hi]`` coordinates stay correct on
workers that only hold their chunk's rows).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from .isl_lite import Affine, LoopDim
from .schedule import PforUnit, RaisedUnit, SeqLoopUnit
from .scop import VAccess, VBin, VConst, VParam, VReduce, VUnary


class _NoMatch(Exception):
    pass


@dataclass
class KernelMatch:
    """One recognized unit body, ready to emit as a cuda twin."""

    kind: str                 # 'matmul' | 'attention' | 'scan'
    body_lines: List[str]     # twin body, chunk form (uses __lo/__hi)
    arrays: Tuple[str, ...] = ()


# ---------------------------------------------------------------------------
# small affine predicates
# ---------------------------------------------------------------------------

def _is_var(a, var: str) -> bool:
    return (isinstance(a, Affine) and a.const == 0
            and a.coeffs == ((var, 1),))


def _pure_var(a) -> Optional[str]:
    if isinstance(a, Affine) and a.const == 0 and len(a.coeffs) == 1 \
            and a.coeffs[0][1] == 1:
        return a.coeffs[0][0]
    return None


def _bound_ok(a: Affine, g: str) -> bool:
    """A bound we may re-emit inside the twin: free of the pfor var and
    of compiler-internal symbols (deferred shape syms like ``p__d0`` are
    only defined inside the np body's scope)."""
    for v, _c in a.coeffs:
        if v == g or v.startswith("_") or "__" in v:
            return False
    return True


def _sl(d: LoopDim, g: str) -> str:
    """Render a loop dim as a python slice, or refuse."""
    if d.step != 1 or not _bound_ok(d.lower, g) or not _bound_ok(d.upper, g):
        raise _NoMatch
    from .codegen import affine_py
    return f"{affine_py(d.lower)}:{affine_py(d.upper)}"


def _dims_eq(a: LoopDim, b: LoopDim) -> bool:
    return a.lower == b.lower and a.upper == b.upper and a.step == b.step


# ---------------------------------------------------------------------------
# elementwise expression rendering
# ---------------------------------------------------------------------------

_EW_BIN = ("+", "-", "*", "/", "**")
_EW_UNARY = ("np.exp", "np.sqrt", "np.abs", "np.tanh", "np.log",
             "np.log1p", "np.sin", "np.cos", "-")


def _render(e, acc: Callable[[VAccess], str]) -> str:
    """Render an elementwise VExpr with ``acc`` deciding how each array
    access becomes a block slice. Anything outside the elementwise
    grammar (nested reductions, exotic ops) refuses the match."""
    if isinstance(e, VConst):
        return repr(e.value)
    if isinstance(e, VParam):
        return e.name
    if isinstance(e, VAccess):
        return acc(e)
    if isinstance(e, VBin) and e.op in _EW_BIN:
        return f"({_render(e.left, acc)} {e.op} {_render(e.right, acc)})"
    if isinstance(e, VUnary) and e.fn in _EW_UNARY:
        if e.fn == "-":
            return f"(-{_render(e.operand, acc)})"
        return f"xp.{e.fn[3:]}({_render(e.operand, acc)})"
    raise _NoMatch


def _accesses(e) -> List[VAccess]:
    """All VAccess leaves of an elementwise expr (VReduce refuses)."""
    if isinstance(e, VAccess):
        return [e]
    if isinstance(e, (VConst, VParam)):
        return []
    if isinstance(e, VBin):
        return _accesses(e.left) + _accesses(e.right)
    if isinstance(e, VUnary):
        return _accesses(e.operand)
    raise _NoMatch


def _idx_vars(e) -> set:
    out = set()
    for a in _accesses(e):
        for aff in a.idx:
            for v, _c in aff.coeffs:
                out.add(v)
    return out


def _mul_factors(e) -> List:
    """Flatten a multiplication tree into its factors."""
    if isinstance(e, VBin) and e.op == "*":
        return _mul_factors(e.left) + _mul_factors(e.right)
    return [e]


# ---------------------------------------------------------------------------
# matmul:   C[g, j] = sum_k  row(g, k) * mat(k, j)
# ---------------------------------------------------------------------------

def _match_matmul(u: PforUnit) -> Optional[KernelMatch]:
    if len(u.body) != 1 or not isinstance(u.body[0], RaisedUnit):
        return None
    s = u.body[0].stmt
    g = u.dim.var
    if s.aug is not None or s.write_full or len(s.write_idx) != 2:
        return None
    if not _is_var(s.write_idx[0], g):
        return None
    j = _pure_var(s.write_idx[1])
    if j is None or j == g:
        return None
    if len(s.domain.dims) != 1 or s.domain.dims[0].var != j:
        return None
    jdim = s.domain.dims[0]
    rhs = s.rhs
    if not (isinstance(rhs, VReduce) and rhs.op == "sum"
            and len(rhs.dims) == 1):
        return None
    kdim = rhs.dims[0]
    k = kdim.var
    if k in (g, j):
        return None
    try:
        js = _sl(jdim, g)
        ks = _sl(kdim, g)

        row_factors, mat_factors = [], []
        for f in _mul_factors(rhs.child):
            vs = _idx_vars(f)
            if not vs <= {g, j, k}:
                raise _NoMatch
            if j in vs:
                if g in vs:
                    raise _NoMatch       # mixed factor: not a matmul
                mat_factors.append(f)
            else:
                row_factors.append(f)
        if not mat_factors or not row_factors:
            raise _NoMatch

        def row_acc(a: VAccess) -> str:
            if a.array == s.write_array:
                raise _NoMatch
            pat = tuple(_pure_var(x) for x in a.idx)
            if pat == (g, k):
                return f"{a.array}[__lo:__hi, {ks}]"
            if pat == (k,):
                return f"{a.array}[{ks}]"
            if pat == (g,):
                return f"{a.array}[__lo:__hi, None]"
            raise _NoMatch

        def mat_acc(a: VAccess) -> str:
            if a.array == s.write_array:
                raise _NoMatch
            pat = tuple(_pure_var(x) for x in a.idx)
            if pat == (k, j):
                return f"{a.array}[{ks}, {js}]"
            if pat == (j,):
                return f"{a.array}[{js}]"
            if pat == (k,):
                return f"{a.array}[{ks}, None]"
            raise _NoMatch

        # the kernel needs genuinely 2-D operands: at least one (g, k)
        # access on the row side and one (k, j) access on the mat side
        if not any(tuple(_pure_var(x) for x in a.idx) == (g, k)
                   for f in row_factors for a in _accesses(f)):
            raise _NoMatch
        if not any(tuple(_pure_var(x) for x in a.idx) == (k, j)
                   for f in mat_factors for a in _accesses(f)):
            raise _NoMatch

        row = " * ".join(_render(f, row_acc) for f in row_factors)
        mat = " * ".join(_render(f, mat_acc) for f in mat_factors)
    except _NoMatch:
        return None
    arrays = tuple(sorted({a.array for a in _accesses(rhs.child)}))
    line = (f"{s.write_array}[__lo:__hi, {js}] = "
            f"__cuk.matmul({row}, {mat})")
    return KernelMatch("matmul", [line], arrays)


# ---------------------------------------------------------------------------
# attention:  p[t] = exp(sum_d K[t,d]*Q[g,d])
#             O[g,j] = (sum_t p[t]*V[t,j]) / sum_t p[t]
# ---------------------------------------------------------------------------

def _match_attention(u: PforUnit) -> Optional[KernelMatch]:
    if len(u.body) != 2:
        return None
    if not all(isinstance(b, RaisedUnit) for b in u.body):
        return None
    ps, os_ = u.body[0].stmt, u.body[1].stmt
    g = u.dim.var

    # -- scores statement: p[t] = exp(sum_d K[t,d] * Q[g,d]) ---------------
    if ps.aug is not None or len(ps.write_idx) != 1:
        return None
    if len(ps.domain.dims) != 1:
        return None
    tdim = ps.domain.dims[0]
    t = tdim.var
    if not _is_var(ps.write_idx[0], t):
        return None
    p_name = ps.write_array
    rhs = ps.rhs
    if not (isinstance(rhs, VUnary) and rhs.fn == "np.exp"):
        return None
    red = rhs.operand
    if not (isinstance(red, VReduce) and red.op == "sum"
            and len(red.dims) == 1):
        return None
    ddim = red.dims[0]
    d = ddim.var
    prod = red.child
    if not (isinstance(prod, VBin) and prod.op == "*"
            and isinstance(prod.left, VAccess)
            and isinstance(prod.right, VAccess)):
        return None
    k_acc = q_acc = None
    for a in (prod.left, prod.right):
        pat = tuple(_pure_var(x) for x in a.idx)
        if pat == (t, d):
            k_acc = a
        elif pat == (g, d):
            q_acc = a
    if k_acc is None or q_acc is None:
        return None

    # -- combine statement: O[g,j] = sum_t p[t]*V[t,j] / sum_x p[x] --------
    if os_.aug is not None or os_.write_full or len(os_.write_idx) != 2:
        return None
    if not _is_var(os_.write_idx[0], g):
        return None
    j = _pure_var(os_.write_idx[1])
    if j is None or len(os_.domain.dims) != 1 or os_.domain.dims[0].var != j:
        return None
    jdim = os_.domain.dims[0]
    div = os_.rhs
    if not (isinstance(div, VBin) and div.op == "/"):
        return None
    num, den = div.left, div.right
    if not (isinstance(num, VReduce) and num.op == "sum"
            and len(num.dims) == 1 and _dims_eq(num.dims[0], tdim)):
        return None
    t2 = num.dims[0].var
    np_ = num.child
    if not (isinstance(np_, VBin) and np_.op == "*"
            and isinstance(np_.left, VAccess)
            and isinstance(np_.right, VAccess)):
        return None
    v_acc = None
    p_ok = False
    for a in (np_.left, np_.right):
        pat = tuple(_pure_var(x) for x in a.idx)
        if a.array == p_name and pat == (t2,):
            p_ok = True
        elif pat == (t2, j):
            v_acc = a
    if not p_ok or v_acc is None:
        return None
    if not (isinstance(den, VReduce) and den.op == "sum"
            and len(den.dims) == 1 and isinstance(den.child, VAccess)
            and den.child.array == p_name
            and _is_var(den.child.idx[0], den.dims[0].var)
            and len(den.child.idx) == 1):
        return None
    xdim = den.dims[0]
    # the denominator may be bounded by t's extent or by p's recorded
    # shape symbol (``p__d0``) — both mean "all of p"
    if not (xdim.lower == tdim.lower
            and (xdim.upper == tdim.upper
                 or xdim.upper == Affine(((f"{p_name}__d0", 1),), 0))):
        return None

    # no aliasing: p is a local temp, and the output must not be one of
    # the inputs; flash needs q/k/v to share the head dimension
    if p_name in (q_acc.array, k_acc.array, v_acc.array, os_.write_array):
        return None
    if os_.write_array in (q_acc.array, k_acc.array, v_acc.array):
        return None
    if not (_dims_eq(ddim, jdim)):
        return None
    try:
        ts = _sl(tdim, g)
        ds = _sl(ddim, g)
        js = _sl(jdim, g)
    except _NoMatch:
        return None
    line = (f"{os_.write_array}[__lo:__hi, {js}] = __cuk.attention_rows("
            f"{q_acc.array}[__lo:__hi, {ds}], "
            f"{k_acc.array}[{ts}, {ds}], "
            f"{v_acc.array}[{ts}, {js}])")
    return KernelMatch("attention", [line],
                       (q_acc.array, k_acc.array, v_acc.array))


# ---------------------------------------------------------------------------
# scan:  h = 0.0; for t: h = c*h + X[g,t]; Y[g,t] = h
# ---------------------------------------------------------------------------

def _scan_coeff(e, h: str):
    """``c*h`` (either order) → render c, else None."""
    if not (isinstance(e, VBin) and e.op == "*"):
        return None
    for c, other in ((e.left, e.right), (e.right, e.left)):
        if isinstance(other, VParam) and other.name == h:
            if isinstance(c, VConst):
                # statically out of the stable range: never match, the
                # lowering (log of the decay) would be infeasible anyway
                try:
                    if not (0.0 < float(c.value) < 1.0):
                        return None
                except (TypeError, ValueError):
                    return None
                return repr(c.value)
            if isinstance(c, VParam) and c.name != h:
                return c.name
    return None


def _match_scan(u: PforUnit) -> Optional[KernelMatch]:
    if len(u.body) != 2:
        return None
    init_u, loop_u = u.body
    if not (isinstance(init_u, RaisedUnit) and isinstance(loop_u,
                                                          SeqLoopUnit)):
        return None
    g = u.dim.var
    init = init_u.stmt
    if not (init.write_full and init.aug is None and not init.write_idx
            and not init.domain.dims and isinstance(init.rhs, VConst)):
        return None
    try:
        if float(init.rhs.value) != 0.0:
            return None
    except (TypeError, ValueError):
        return None
    h = init.write_array
    tdim = loop_u.dim
    t = tdim.var
    if len(loop_u.body) != 2:
        return None
    if not all(isinstance(b, RaisedUnit) for b in loop_u.body):
        return None
    rec, out = loop_u.body[0].stmt, loop_u.body[1].stmt

    # h = c*h + X[g,t]   (either order of the sum)
    if not (rec.write_array == h and rec.write_full and rec.aug is None
            and not rec.domain.dims):
        return None
    if not (isinstance(rec.rhs, VBin) and rec.rhs.op == "+"):
        return None
    coeff = x_acc = None
    for a, b in ((rec.rhs.left, rec.rhs.right),
                 (rec.rhs.right, rec.rhs.left)):
        c = _scan_coeff(a, h)
        if (c is not None and isinstance(b, VAccess)
                and tuple(_pure_var(x) for x in b.idx) == (g, t)):
            coeff, x_acc = c, b
            break
    if coeff is None:
        return None

    # Y[g,t] = h
    if not (out.aug is None and not out.write_full
            and len(out.write_idx) == 2 and not out.domain.dims
            and _is_var(out.write_idx[0], g)
            and _is_var(out.write_idx[1], t)
            and isinstance(out.rhs, VParam) and out.rhs.name == h):
        return None
    if out.write_array in (x_acc.array, h):
        return None
    try:
        ts = _sl(tdim, g)
    except _NoMatch:
        return None
    line = (f"{out.write_array}[__lo:__hi, {ts}] = __cuk.scan_rows("
            f"{x_acc.array}[__lo:__hi, {ts}], {coeff})")
    return KernelMatch("scan", [line], (x_acc.array,))


# ---------------------------------------------------------------------------

_MATCHERS = (_match_matmul, _match_attention, _match_scan)


def match_pfor_unit(u: PforUnit) -> Optional[KernelMatch]:
    """Recognize a pfor unit body as one of the cuda-lowerable kernel
    shapes, or None. Only exact template structure matches; every check
    is conservative (a false negative costs performance, a false
    positive would be a miscompile)."""
    if not isinstance(u, PforUnit) or u.dim.step != 1:
        return None
    for m in _MATCHERS:
        try:
            km = m(u)
        except _NoMatch:      # defensive: matchers normally catch this
            km = None
        if km is not None:
            return km
    return None
