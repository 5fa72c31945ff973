"""Kernel-shape pattern matching over scheduled pfor units.

The cuda backend (``core/backends.py``) does not lower arbitrary unit
bodies: it recognizes fixed shapes and rewrites each onto a hand-written
CUDA kernel behind :mod:`repro_torch.kernels.api` (bound as ``__cuk`` in
the twin's namespace). This slice recognizes one shape, the
matmul-shaped pfor body. Matching is deliberately conservative: any
structure outside the template (extra statements, augmented writes,
non-unit strides, affine indices that are not plain loop variables,
bounds that depend on the pfor variable or on codegen-internal shape
symbols) means *no match* and the unit simply keeps its np body.

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
from .schedule import PforUnit, RaisedUnit
from .scop import VAccess, VBin, VConst, VParam, VReduce, VUnary


class _NoMatch(Exception):
    pass


@dataclass
class KernelMatch:
    """One recognized unit body, ready to emit as a cuda twin."""

    kind: str                 # 'matmul'
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

# the attention and scan matchers return with the kernels they lower
# onto; until then those units keep their np body
_MATCHERS = (_match_matmul,)


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
