"""SCoP extraction: unify explicit Python loops and implicit NumPy loops.

This is the paper's central §4.2 mechanism. Every analyzable statement is
canonicalized to

    W[f(outs)]  (op)=  Σ_{reduce dims}  e( A_m[g_m(outs, reds)] )

where ``outs`` are the *output* iterators (explicit loop variables plus one
fresh iterator per slice dimension of the write target) and ``reds`` are
reduction iterators (from explicit accumulation loops *or* implicit
contractions like ``np.dot``/``.sum``). Explicit-loop kernels (PolyBench
"List" versions) and NumPy-operator kernels canonicalize to the *same*
form — which is exactly how AutoMPHC optimizes both styles identically.

Ops the knowledge base cannot express element-wise (``np.fft.fft``) are
*materialization points*: their operand is flushed to a temporary statement
and the op becomes a standalone statement (paper Fig 7: statement T).
Anything else unanalyzable becomes an Opaque region (black-box statement
with approximated read/write sets).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from . import knowledge, tir
from .isl_lite import Affine, AffineError, Domain, LoopDim
from .types import TypeInfo


class NonAffine(Exception):
    pass


_fresh_counter = itertools.count()


def fresh(prefix: str) -> str:
    return f"_{prefix}{next(_fresh_counter)}"


# ---------------------------------------------------------------------------
# Scalar-expression trees over array accesses
# ---------------------------------------------------------------------------

@dataclass
class VExpr:
    pass


@dataclass
class VAccess(VExpr):
    array: str
    idx: Tuple[Affine, ...]
    dtype: Optional[str] = None


@dataclass
class VConst(VExpr):
    value: object


@dataclass
class VParam(VExpr):
    """A scalar variable (kernel parameter or loop-invariant local)."""

    name: str


@dataclass
class VBin(VExpr):
    op: str
    left: VExpr
    right: VExpr


@dataclass
class VUnary(VExpr):
    fn: str  # 'np.sqrt', '-', …
    operand: VExpr


@dataclass
class VReduce(VExpr):
    op: str  # 'sum' (mean is rewritten to sum/extent)
    dims: Tuple[LoopDim, ...]
    child: VExpr


def vexpr_arrays(e: VExpr) -> List[str]:
    if isinstance(e, VAccess):
        return [e.array]
    if isinstance(e, VBin):
        return vexpr_arrays(e.left) + vexpr_arrays(e.right)
    if isinstance(e, VUnary):
        return vexpr_arrays(e.operand)
    if isinstance(e, VReduce):
        return vexpr_arrays(e.child)
    return []


def vexpr_accesses(e: VExpr) -> List[VAccess]:
    if isinstance(e, VAccess):
        return [e]
    if isinstance(e, VBin):
        return vexpr_accesses(e.left) + vexpr_accesses(e.right)
    if isinstance(e, VUnary):
        return vexpr_accesses(e.operand)
    if isinstance(e, VReduce):
        return vexpr_accesses(e.child)
    return []


def substitute_array_reads(e: VExpr, array: str, builder) -> VExpr:
    """Replace every read of ``array`` with ``builder(access)`` (shared by
    the fusion pass and the loop-fallback emitter)."""
    if isinstance(e, VAccess):
        return builder(e) if e.array == array else e
    if isinstance(e, VBin):
        return VBin(e.op, substitute_array_reads(e.left, array, builder),
                    substitute_array_reads(e.right, array, builder))
    if isinstance(e, VUnary):
        return VUnary(e.fn, substitute_array_reads(e.operand, array,
                                                   builder))
    if isinstance(e, VReduce):
        return VReduce(e.op, e.dims,
                       substitute_array_reads(e.child, array, builder))
    return e


def substitute_vexpr(e: VExpr, env: Dict[str, Affine]) -> VExpr:
    if isinstance(e, VAccess):
        return VAccess(e.array, tuple(a.substitute(env) for a in e.idx),
                       e.dtype)
    if isinstance(e, VBin):
        return VBin(e.op, substitute_vexpr(e.left, env),
                    substitute_vexpr(e.right, env))
    if isinstance(e, VUnary):
        return VUnary(e.fn, substitute_vexpr(e.operand, env))
    if isinstance(e, VReduce):
        dims = tuple(LoopDim(d.var, d.lower.substitute(env),
                             d.upper.substitute(env), d.step)
                     for d in e.dims)
        return VReduce(e.op, dims, substitute_vexpr(e.child, env))
    return e


# ---------------------------------------------------------------------------
# Views: tensor-valued expressions with named axes
# ---------------------------------------------------------------------------

@dataclass
class View:
    """expr: scalar VExpr in terms of ``axes`` iterators (plus any reduce
    iterators bound inside VReduce nodes). ``dims[v]`` gives each axis
    iterator's LoopDim."""

    expr: VExpr
    axes: Tuple[str, ...]
    dims: Dict[str, LoopDim]
    dtype: Optional[str] = None

    @property
    def rank(self) -> int:
        return len(self.axes)


# ---------------------------------------------------------------------------
# Canonical statements / program structure
# ---------------------------------------------------------------------------

@dataclass
class CanonStmt:
    """W[f(outs)] (op)= rhs.  ``domain`` holds only the out iterators."""

    write_array: str
    write_idx: Tuple[Affine, ...]
    domain: Domain
    rhs: VExpr
    aug: Optional[str] = None  # '+' / '*' / None
    write_is_temp: bool = False     # target is a compiler temp (fresh array)
    write_full: bool = False        # target is a whole variable (x = expr)
    label: str = ""
    dtype: Optional[str] = None

    def reduce_dims(self) -> Tuple[LoopDim, ...]:
        out: List[LoopDim] = []

        def rec(e: VExpr):
            if isinstance(e, VReduce):
                out.extend(e.dims)
                rec(e.child)
            elif isinstance(e, VBin):
                rec(e.left)
                rec(e.right)
            elif isinstance(e, VUnary):
                rec(e.operand)

        rec(self.rhs)
        return tuple(out)


@dataclass
class OpaqueItem:
    stmts: List[tir.Stmt]
    reads: Tuple[str, ...] = ()
    writes: Tuple[str, ...] = ()


@dataclass
class LoopItem:
    dim: LoopDim
    body: List["Item"]
    parallel: Optional[bool] = None  # filled by dependence analysis


Item = Union[CanonStmt, OpaqueItem, LoopItem]


@dataclass
class ScopProgram:
    fn: tir.Function
    items: List[Item]
    params: List[str]
    # arrays allocated by the kernel itself (np.zeros/np.empty temps)
    temps: List[str] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Extraction
# ---------------------------------------------------------------------------

class Extractor:
    def __init__(self, fn: tir.Function):
        self.fn = fn
        self.types: Dict[str, TypeInfo] = {n: t for n, t in fn.params}
        self.scalars: set = {
            n for n, t in fn.params if t.is_numeric_scalar or t.kind == "unknown"
        }
        self.arrays: set = {n for n, t in fn.params if t.is_array_like}
        self.temps: List[str] = []
        self.pre: List[Item] = []  # materialized statements pending emit

    # ---- affine conversion -------------------------------------------
    def affine(self, e: tir.Expr, iters: Dict[str, LoopDim]) -> Affine:
        if isinstance(e, tir.Const):
            if isinstance(e.value, int) and not isinstance(e.value, bool):
                return Affine.constant(e.value)
            raise NonAffine(f"non-int const {e.value!r}")
        if isinstance(e, tir.Name):
            return Affine.var(e.id)
        if isinstance(e, tir.UnaryOp) and e.op == "-":
            return -self.affine(e.operand, iters)
        if isinstance(e, tir.BinOp):
            l = self.affine(e.left, iters)
            r = self.affine(e.right, iters)
            if e.op == "+":
                return l + r
            if e.op == "-":
                return l - r
            if e.op == "*":
                return l * r
            raise NonAffine(f"op {e.op}")
        if isinstance(e, tir.Call) and e.fn == "len" and len(e.args) == 1 \
                and isinstance(e.args[0], tir.Name):
            return Affine.var(f"{e.args[0].id}__d0")
        if isinstance(e, tir.Subscript) and isinstance(e.base, tir.Call) \
                and e.base.fn == "method.shape" \
                and isinstance(e.base.args[0], tir.Name) \
                and len(e.indices) == 1 \
                and isinstance(e.indices[0], tir.IndexExpr) \
                and isinstance(e.indices[0].value, tir.Const):
            return Affine.var(
                f"{e.base.args[0].id}__d{e.indices[0].value.value}")
        raise NonAffine(type(e).__name__)

    # ---- views ----------------------------------------------------------
    def view(self, e: tir.Expr, iters: Dict[str, LoopDim]) -> View:
        if isinstance(e, tir.Const):
            return View(VConst(e.value), (), {})
        if isinstance(e, tir.Name):
            t = self.types.get(e.id, e.ty)
            if e.id in iters:
                raise NonAffine("loop var used as value")  # e.g. x = i*2
            if t.is_array_like and (t.rank or 0) > 0:
                # whole-array reference: one fresh iterator per dim
                axes, dims, idx = [], {}, []
                for d in range(t.rank):
                    v = fresh("x")
                    dim = LoopDim(v, Affine.constant(0),
                                  Affine.var(f"{e.id}__d{d}"))
                    axes.append(v)
                    dims[v] = dim
                    idx.append(Affine.var(v))
                return View(VAccess(e.id, tuple(idx), t.dtype),
                            tuple(axes), dims, t.dtype)
            return View(VParam(e.id), (), {}, t.dtype)
        if isinstance(e, tir.UnaryOp) and e.op == "-":
            v = self.view(e.operand, iters)
            return View(VUnary("-", v.expr), v.axes, v.dims, v.dtype)
        if isinstance(e, tir.Subscript):
            return self.subscript_view(e, iters)
        if isinstance(e, tir.BinOp):
            return self.binop_view(e, iters)
        if isinstance(e, tir.Call):
            return self.call_view(e, iters)
        raise NonAffine(type(e).__name__)

    def subscript_view(self, e: tir.Subscript,
                       iters: Dict[str, LoopDim]) -> View:
        if not isinstance(e.base, tir.Name):
            # subscript of a computed view: materialize then index
            base_view = self.view(e.base, iters)
            tmp = self.materialize(base_view)
            return self.subscript_view(
                tir.Subscript(base=tir.Name(id=tmp, ty=e.base.ty),
                              indices=e.indices, ty=e.ty), iters)
        name = e.base.id
        t = self.types.get(name, e.base.ty).as_array()
        rank = t.rank or len(e.indices)
        axes: List[str] = []
        dims: Dict[str, LoopDim] = {}
        idx: List[Affine] = []
        for d in range(rank):
            if d < len(e.indices):
                comp = e.indices[d]
            else:
                comp = tir.SliceExpr()  # trailing dims fully sliced
            if isinstance(comp, tir.IndexExpr):
                idx.append(self.affine(comp.value, iters))
            elif isinstance(comp, tir.SliceExpr):
                if comp.step is not None and not (
                        isinstance(comp.step, tir.Const)
                        and comp.step.value in (1, None)):
                    raise NonAffine("strided slice")
                lo = (self.affine(comp.lo, iters) if comp.lo is not None
                      else Affine.constant(0))
                hi = (self.affine(comp.hi, iters) if comp.hi is not None
                      else Affine.var(f"{name}__d{d}"))
                v = fresh("s")
                dim = LoopDim(v, lo, hi)
                axes.append(v)
                dims[v] = dim
                idx.append(Affine.var(v))
            else:
                raise NonAffine("bad subscript component")
        return View(VAccess(name, tuple(idx), t.dtype), tuple(axes), dims,
                    t.dtype)

    # ---- broadcasting unification --------------------------------------
    def unify(self, a: View, b: View) -> Tuple[View, View, Tuple[str, ...],
                                               Dict[str, LoopDim]]:
        """Align axes of two views by numpy trailing-dim broadcasting and
        substitute b's iterators with a's. Returns adjusted (a, b, axes,
        dims) for the result."""
        if a.rank < b.rank:
            b2, a2, axes, dims = self.unify(b, a)
            return a2, b2, axes, dims
        # a.rank >= b.rank: align b's axes to the trailing axes of a
        env: Dict[str, Affine] = {}
        for ai, bi in zip(a.axes[a.rank - b.rank:], b.axes):
            env[bi] = Affine.var(ai)
        b_expr = substitute_vexpr(b.expr, env)
        axes = a.axes
        dims = dict(a.dims)
        return a, View(b_expr, axes[a.rank - b.rank:],
                       {ax: dims[ax] for ax in axes[a.rank - b.rank:]},
                       b.dtype), axes, dims

    def binop_view(self, e: tir.BinOp, iters: Dict[str, LoopDim]) -> View:
        if e.op == "@":
            return self.dot_view(self.view(e.left, iters),
                                 self.view(e.right, iters))
        l = self.view(e.left, iters)
        r = self.view(e.right, iters)
        l2, r2, axes, dims = self.unify(l, r)
        return View(VBin(e.op, l2.expr, r2.expr), axes, dims,
                    l.dtype or r.dtype)

    def dot_view(self, a: View, b: View) -> View:
        """np.dot / @ semantics from the knowledge base (Table 2)."""
        if a.rank == 0 or b.rank == 0:
            raise NonAffine("dot with scalar")
        if a.rank == 1 and b.rank == 1:
            k_a, k_b = a.axes[0], b.axes[0]
            env = {k_b: Affine.var(k_a)}
            child = VBin("*", a.expr, substitute_vexpr(b.expr, env))
            red = a.dims[k_a]
            return View(VReduce("sum", (red,), child), (), {},
                        a.dtype or b.dtype)
        if a.rank == 2 and b.rank == 1:
            k_a, k_b = a.axes[1], b.axes[0]
            env = {k_b: Affine.var(k_a)}
            child = VBin("*", a.expr, substitute_vexpr(b.expr, env))
            red = a.dims[k_a]
            ax0 = a.axes[0]
            return View(VReduce("sum", (red,), child), (ax0,),
                        {ax0: a.dims[ax0]}, a.dtype or b.dtype)
        if a.rank == 1 and b.rank == 2:
            k_a, k_b = a.axes[0], b.axes[0]
            env = {k_a: Affine.var(k_b)}
            child = VBin("*", substitute_vexpr(a.expr, env), b.expr)
            red = b.dims[k_b]
            ax1 = b.axes[1]
            return View(VReduce("sum", (red,), child), (ax1,),
                        {ax1: b.dims[ax1]}, a.dtype or b.dtype)
        if a.rank == 2 and b.rank == 2:
            k_a, k_b = a.axes[1], b.axes[0]
            env = {k_b: Affine.var(k_a)}
            child = VBin("*", a.expr, substitute_vexpr(b.expr, env))
            red = a.dims[k_a]
            ax0, ax1 = a.axes[0], b.axes[1]
            return View(VReduce("sum", (red,), child), (ax0, ax1),
                        {ax0: a.dims[ax0], ax1: b.dims[ax1]},
                        a.dtype or b.dtype)
        raise NonAffine(f"dot rank {a.rank}x{b.rank}")

    def call_view(self, e: tir.Call, iters: Dict[str, LoopDim]) -> View:
        entry = knowledge.lookup(e.fn)
        if entry is None:
            raise NonAffine(f"unknown call {e.fn}")
        sem = entry.semantic[0]
        if sem == "elementwise":
            args = [self.view(a, iters) for a in e.args]
            if len(args) == 1:
                v = args[0]
                return View(VUnary(e.fn, v.expr), v.axes, v.dims, v.dtype)
            a, b = args[0], args[1]
            a2, b2, axes, dims = self.unify(a, b)
            return View(VBin(e.fn, a2.expr, b2.expr), axes, dims, a.dtype)
        if sem == "transpose":
            v = self.view(e.args[0], iters)
            if v.rank != 2:
                if v.rank <= 1:
                    return v
                raise NonAffine("transpose rank>2")
            axes = (v.axes[1], v.axes[0])
            return View(v.expr, axes, v.dims, v.dtype)
        if sem == "squeeze":
            v = self.view(e.args[0], iters)
            keep, dims = [], {}
            for ax in v.axes:
                d = v.dims[ax]
                ext = d.upper - d.lower
                if ext.is_constant() and ext.const == 1:
                    # fix the axis at its lower bound
                    v = View(substitute_vexpr(v.expr, {ax: d.lower}),
                             v.axes, v.dims, v.dtype)
                    continue
                keep.append(ax)
                dims[ax] = d
            return View(v.expr, tuple(keep), dims, v.dtype)
        if sem == "reduce":
            v = self.view(e.args[0], iters)
            axis = None
            if "axis" in e.kwargs:
                if not isinstance(e.kwargs["axis"], tir.Const):
                    raise NonAffine("dynamic axis")
                axis = e.kwargs["axis"].value
            kind = entry.semantic[1]
            if kind not in ("sum", "mean"):
                raise NonAffine(f"reduce kind {kind}")
            if axis is None:
                red_axes = list(v.axes)
            else:
                if axis < 0:
                    axis += v.rank
                red_axes = [v.axes[axis]]
            keep = tuple(ax for ax in v.axes if ax not in red_axes)
            red_dims = tuple(v.dims[ax] for ax in red_axes)
            expr: VExpr = VReduce("sum", red_dims, v.expr)
            if kind == "mean":
                denom: VExpr = None
                for d in red_dims:
                    ext = d.upper - d.lower
                    term = affine_to_vexpr(ext)
                    denom = term if denom is None else VBin("*", denom, term)
                expr = VBin("/", expr, denom)
            return View(expr, keep, {ax: v.dims[ax] for ax in keep},
                        v.dtype)
        if sem == "contract":
            if entry.semantic[1] == "dot":
                return self.dot_view(self.view(e.args[0], iters),
                                     self.view(e.args[1], iters))
            if entry.semantic[1] == "outer":
                a = self.view(e.args[0], iters)
                b = self.view(e.args[1], iters)
                if a.rank != 1 or b.rank != 1:
                    raise NonAffine("outer rank")
                axes = (a.axes[0], b.axes[0])
                dims = {a.axes[0]: a.dims[a.axes[0]],
                        b.axes[0]: b.dims[b.axes[0]]}
                return View(VBin("*", a.expr, b.expr), axes, dims, a.dtype)
        if sem == "fft":
            # materialization point: flush operand, emit standalone fft stmt
            v = self.view(e.args[0], iters)
            src = self.materialize(v)
            out = fresh("fft")
            self.temps.append(out)
            n_expr = None
            if len(e.args) >= 2:
                n_expr = self.affine(e.args[1], iters)
            axis = v.rank - 1  # numpy default: last axis
            if "axis" in e.kwargs and isinstance(e.kwargs["axis"], tir.Const):
                axis = e.kwargs["axis"].value
            if "n" in e.kwargs:
                n_expr = self.affine(e.kwargs["n"], iters)
            self.pre.append(FFTStmt(out=out, src=src, fn=e.fn, axis=axis,
                                    n=n_expr, src_rank=v.rank))
            dt = "complex128"
            t = TypeInfo.array(dt, v.rank)
            self.types[out] = t
            # output dims: same as src except fft axis extent may change
            axes, dims, idx = [], {}, []
            for d in range(v.rank):
                nv = fresh("x")
                if d == (axis if axis >= 0 else v.rank + axis) and \
                        n_expr is not None:
                    dim = LoopDim(nv, Affine.constant(0), n_expr)
                else:
                    src_dim = v.dims[v.axes[d]]
                    dim = LoopDim(nv, Affine.constant(0),
                                  src_dim.upper - src_dim.lower)
                axes.append(nv)
                dims[nv] = dim
                idx.append(Affine.var(nv))
            return View(VAccess(out, tuple(idx), dt), tuple(axes), dims, dt)
        raise NonAffine(f"semantic {sem}")

    # ---- materialization -------------------------------------------------
    def materialize(self, v: View) -> str:
        """Flush a view into a fresh temp array; returns its name."""
        # Fast path: the view is a whole-array identity access — no copy.
        if isinstance(v.expr, VAccess) and len(v.expr.idx) == len(v.axes):
            ok = True
            for ax, idx in zip(v.axes, v.expr.idx):
                d = v.dims[ax]
                if not (idx.equals(Affine.var(ax))
                        and d.lower.is_zero()
                        and d.upper.equals(
                            Affine.var(f"{v.expr.array}__d"
                                       f"{list(v.axes).index(ax)}"))):
                    ok = False
                    break
            if ok:
                return v.expr.array
        tmp = fresh("t")
        self.temps.append(tmp)
        # rebase axes to zero-based fresh iterators for a clean rectangular
        # temp: temp[o0, o1, …] = expr with oX = axis - lower
        env: Dict[str, Affine] = {}
        out_dims: List[LoopDim] = []
        idx: List[Affine] = []
        for ax in v.axes:
            d = v.dims[ax]
            o = fresh("o")
            env[ax] = Affine.var(o) + d.lower
            out_dims.append(LoopDim(o, Affine.constant(0),
                                    d.upper - d.lower))
            idx.append(Affine.var(o))
        stmt = CanonStmt(
            write_array=tmp,
            write_idx=tuple(idx),
            domain=Domain(tuple(out_dims)),
            rhs=substitute_vexpr(v.expr, env),
            aug=None, write_is_temp=True, dtype=v.dtype,
            label=f"materialize:{tmp}")
        self.pre.append(stmt)
        self.types[tmp] = TypeInfo.array(v.dtype or "float64", v.rank)
        return tmp

    # ---- statements -------------------------------------------------------
    def canon_assign(self, s: tir.Assign,
                     iters: Dict[str, LoopDim]) -> List[Item]:
        self.pre = []
        try:
            if isinstance(s.target, tir.Name):
                rhs = self.view(s.value, iters)
                if s.aug is not None and rhs.rank > 0:
                    raise NonAffine("aug on array-valued name")
                if s.aug is not None:
                    # scalar accumulator (symm's temp2 pattern): rank-0
                    # write with aug; absorption may turn it into a
                    # reduction
                    stmt = CanonStmt(
                        write_array=s.target.id, write_idx=(),
                        domain=Domain(()), rhs=rhs.expr, aug=s.aug,
                        write_full=True, dtype=rhs.dtype,
                        label=f"accum:{s.target.id}")
                    return self.pre + [stmt]
                # whole-variable assignment: x = <view>
                env: Dict[str, Affine] = {}
                out_dims, idx = [], []
                for ax in rhs.axes:
                    d = rhs.dims[ax]
                    o = fresh("o")
                    env[ax] = Affine.var(o) + d.lower
                    out_dims.append(LoopDim(o, Affine.constant(0),
                                            d.upper - d.lower))
                    idx.append(Affine.var(o))
                stmt = CanonStmt(
                    write_array=s.target.id, write_idx=tuple(idx),
                    domain=Domain(tuple(out_dims)),
                    rhs=substitute_vexpr(rhs.expr, env),
                    aug=None, write_full=True, dtype=rhs.dtype,
                    label=f"assign:{s.target.id}")
                self.types[s.target.id] = TypeInfo.array(
                    rhs.dtype or "float64", rhs.rank) if rhs.rank else \
                    TypeInfo.scalar(rhs.dtype or "float64")
                if rhs.rank:
                    self.arrays.add(s.target.id)
                return self.pre + [stmt]
            if not isinstance(s.target, tir.Subscript):
                raise NonAffine("target kind")
            tgt = self.subscript_view(s.target, iters)
            if not isinstance(tgt.expr, VAccess):
                raise NonAffine("target not a plain access")
            rhs = self.view(s.value, iters)
            if rhs.rank > tgt.rank:
                raise NonAffine("rhs rank exceeds target")
            # unify rhs axes with trailing target axes
            env = {}
            for t_ax, r_ax in zip(tgt.axes[tgt.rank - rhs.rank:], rhs.axes):
                env[r_ax] = Affine.var(t_ax)
            rhs_expr = substitute_vexpr(rhs.expr, env)
            # out iterators: ONLY the target slice axes. Enclosing explicit
            # loop vars stay bound by their loops; absorption
            # (schedule._absorb_loop) prepends them to the domain when the
            # loop is folded into this statement.
            out_dims = [tgt.dims[ax] for ax in tgt.axes]
            aug = s.aug
            stmt = CanonStmt(
                write_array=tgt.expr.array, write_idx=tgt.expr.idx,
                domain=Domain(tuple(out_dims)), rhs=rhs_expr, aug=aug,
                dtype=tgt.dtype,
                label=f"update:{tgt.expr.array}")
            return self.pre + [stmt]
        finally:
            self.pre = []

    def extract(self) -> ScopProgram:
        items = self.block(self.fn.body, {})
        return ScopProgram(self.fn, items, list(self.fn.sym_params),
                           self.temps)

    def block(self, stmts: List[tir.Stmt],
              iters: Dict[str, LoopDim]) -> List[Item]:
        out: List[Item] = []
        for s in stmts:
            if isinstance(s, tir.Assign):
                try:
                    pre_backup = list(self.pre)
                    got = self.canon_assign(s, iters)
                    out.extend(got)
                except (NonAffine, AffineError, Exception) as exc:
                    if not isinstance(exc, (NonAffine, AffineError)):
                        # genuinely unexpected — still degrade gracefully
                        pass
                    out.append(self.opaque([s]))
            elif isinstance(s, tir.For):
                try:
                    lo = self.affine(s.lo, iters)
                    hi = self.affine(s.hi, iters)
                    step = 1
                    if s.step is not None:
                        if isinstance(s.step, tir.Const) and \
                                isinstance(s.step.value, int):
                            step = s.step.value
                        else:
                            raise NonAffine("dynamic step")
                    dim = LoopDim(s.var, lo, hi, step)
                    inner = dict(iters)
                    inner[s.var] = dim
                    body = self.block(s.body, inner)
                    out.append(LoopItem(dim, body))
                except (NonAffine, AffineError):
                    out.append(self.opaque([s]))
            elif isinstance(s, (tir.Return,)):
                out.append(self.opaque([s]))
            elif isinstance(s, tir.Opaque):
                out.append(OpaqueItem([s], s.reads, s.writes))
            else:
                out.append(self.opaque([s]))
        return out

    def opaque(self, stmts: List[tir.Stmt]) -> OpaqueItem:
        reads, writes = set(), set()
        for s in stmts:
            r, w = tir.stmt_reads_writes(s)
            reads |= r
            writes |= w
        return OpaqueItem(stmts, tuple(sorted(reads)), tuple(sorted(writes)))


@dataclass
class FFTStmt:
    """Standalone spectral op (materialization point)."""

    out: str
    src: str
    fn: str
    axis: int
    n: Optional[Affine]
    src_rank: int
    label: str = "fft"


def affine_to_vexpr(a: Affine) -> VExpr:
    e: VExpr = VConst(a.const) if a.const or not a.coeffs else None
    for k, c in a.coeffs:
        term: VExpr = VParam(k) if c == 1 else VBin("*", VConst(c), VParam(k))
        e = term if e is None else VBin("+", e, term)
    return e or VConst(0)


def extract(fn: tir.Function) -> ScopProgram:
    return Extractor(fn).extract()
