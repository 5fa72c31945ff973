"""Operator raising: map canonical statements onto library calls.

This is the SCoP-to-IR generation stage of the paper (§4.2): "the library
knowledge base [is used] to select the efficient combination of available
library functions for each statement whenever possible. The maximal
matching strategy is currently employed."

Given a CanonStmt, we produce:
  * a WritePlan — how to store into the (possibly triangular/diagonal)
    write region: plain slice, masked slice, diagonal scatter, or whole
    variable;
  * an expression plan — the RHS as a tree whose contraction subtrees are
    EinsumSpecs (with a np.dot peephole reproducing the paper's Fig. 6c
    output) and whose remaining nodes are elementwise ops over hull-aligned
    slices.

Raising never fails the kernel: statements it cannot plan fall back to the
loop emitter in core/codegen.py (correct, just slower) — mirroring the
paper's guarantee that optimization is best-effort and correctness comes
from multi-versioning.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .isl_lite import Affine, Domain, LoopDim
from .scop import (CanonStmt, VAccess, VBin, VConst, VExpr, VParam, VReduce,
                   VUnary)


class RaiseError(Exception):
    pass


# ---------------------------------------------------------------------------
# Hulls: rectangularize triangular iterator bounds
# ---------------------------------------------------------------------------

@dataclass
class Hull:
    """Rectangular over-approximation of every iterator's range, plus the
    mask conditions that recover the exact (triangular) domain."""

    lo: Dict[str, Affine]
    hi: Dict[str, Affine]
    # (dep_var, outer_var, op, offset): dep_var <op> outer_var + offset
    conds: List[Tuple[str, str, str, int]] = field(default_factory=list)


def compute_hull(dims: List[LoopDim]) -> Hull:
    lo: Dict[str, Affine] = {}
    hi: Dict[str, Affine] = {}
    conds: List[Tuple[str, str, str, int]] = []
    seen: Dict[str, LoopDim] = {}
    for d in dims:
        lo_b, hi_b = d.lower, d.upper
        for bound, is_lower in ((lo_b, True), (hi_b, False)):
            iter_vars = [v for v in bound.vars() if v in seen]
            if not iter_vars:
                continue
            if len(iter_vars) > 1:
                raise RaiseError("bound depends on multiple iterators")
            ov = iter_vars[0]
            c = bound.coeff(ov)
            if c != 1:
                raise RaiseError("non-unit iterator coefficient in bound")
            rest = bound.drop([ov])
            if not rest.is_constant():
                raise RaiseError("mixed symbolic+iterator bound")
            off = rest.const
            if is_lower:
                # v >= ov + off; min over ov ∈ [lo, hi) is lo + off
                conds.append((d.var, ov, ">=", off))
                lo_b = lo[ov] + off
            else:
                # v < ov + off; max v = (hi-1) + off - 1 → exclusive hull
                # bound hi + off - 1
                conds.append((d.var, ov, "<", off))
                hi_b = hi[ov] + off - 1
        # bounds may also reference *later* unseen iterators: reject
        for bound in (lo_b, hi_b):
            bad = [v for v in bound.vars() if v in {dd.var for dd in dims}]
            if bad:
                raise RaiseError("unresolved iterator in hull bound")
        lo[d.var] = lo_b
        hi[d.var] = hi_b
        seen[d.var] = d
    return Hull(lo, hi, conds)


# ---------------------------------------------------------------------------
# RHS normalization
# ---------------------------------------------------------------------------

def normalize(e: VExpr) -> VExpr:
    """Distribute reductions over '+'/'-' and hoist reduce-invariant scalar
    factors out of reductions (Σ_k c·x = c·Σ_k x)."""
    if isinstance(e, VBin):
        l, r = normalize(e.left), normalize(e.right)
        return VBin(e.op, l, r)
    if isinstance(e, VUnary):
        return VUnary(e.fn, normalize(e.operand))
    if isinstance(e, VReduce):
        child = normalize(e.child)
        if isinstance(child, VBin) and child.op in ("+", "-"):
            return VBin(child.op,
                        normalize(VReduce(e.op, e.dims, child.left)),
                        normalize(VReduce(e.op, e.dims, child.right)))
        if isinstance(child, VReduce):
            return normalize(VReduce(e.op, e.dims + child.dims, child.child))
        # hoist factors free of the reduce iterators
        red_vars = {d.var for d in e.dims}
        if isinstance(child, VBin) and child.op == "*":
            factors = _flatten_product(child)
            inside, outside = [], []
            for f in factors:
                if _uses_vars(f, red_vars):
                    inside.append(f)
                else:
                    outside.append(f)
            if outside and inside:
                body = _product(inside)
                out = VReduce(e.op, e.dims, body)
                return _product(outside + [out])
        if isinstance(child, VBin) and child.op == "/":
            if not _uses_vars(child.right, red_vars):
                return VBin("/", normalize(VReduce(e.op, e.dims,
                                                   child.left)),
                            child.right)
        return VReduce(e.op, e.dims, child)
    return e


def _flatten_product(e: VExpr) -> List[VExpr]:
    if isinstance(e, VBin) and e.op == "*":
        return _flatten_product(e.left) + _flatten_product(e.right)
    return [e]


def _product(fs: List[VExpr]) -> VExpr:
    out = fs[0]
    for f in fs[1:]:
        out = VBin("*", out, f)
    return out


def _uses_vars(e: VExpr, names: set) -> bool:
    if isinstance(e, VAccess):
        return any(v in names for idx in e.idx for v in idx.vars())
    if isinstance(e, VBin):
        return _uses_vars(e.left, names) or _uses_vars(e.right, names)
    if isinstance(e, VUnary):
        return _uses_vars(e.operand, names)
    if isinstance(e, VReduce):
        return _uses_vars(e.child, names)
    return False


# ---------------------------------------------------------------------------
# Einsum planning for contraction subtrees
# ---------------------------------------------------------------------------

_LETTERS = "abcdefghijklmnopqrstuvwxyz"


@dataclass
class EinsumOperand:
    access: VAccess
    letters: str


@dataclass
class MaskOperand:
    """np.tri-derived boolean factor recovering a triangular reduce bound."""

    row_var: str
    col_var: str
    op: str  # '>=' or '<'
    offset: int
    letters: str


@dataclass
class EinsumSpec:
    operands: List[EinsumOperand]
    masks: List[MaskOperand]
    out_letters: str
    out_vars: Tuple[str, ...]
    reduce_dims: Tuple[LoopDim, ...]
    spec: str  # full einsum subscripts string

    def is_dot2(self) -> bool:
        """Peephole: exactly two operands, one shared reduction letter,
        rank ≤ 2 each → can be emitted as np.dot (paper Fig. 6c)."""
        if self.masks or len(self.operands) != 2:
            return False
        if len(self.reduce_dims) != 1:
            return False
        return all(1 <= len(op.letters) <= 2 for op in self.operands)


def plan_einsum(red: VReduce, out_frame: Tuple[str, ...],
                hull: Hull) -> EinsumSpec:
    """Plan VReduce(product-of-accesses) as one einsum over hull slices."""
    factors = _flatten_product(red.child)
    accesses: List[VAccess] = []
    for f in factors:
        if isinstance(f, VAccess):
            accesses.append(f)
        else:
            raise RaiseError("non-access factor inside reduction")
    red_dims = list(red.dims)
    red_vars = [d.var for d in red_dims]

    # Reduce dims with out-iterator-dependent bounds → widen + mask
    masks: List[MaskOperand] = []
    widened: List[LoopDim] = []
    extended_hull_lo = dict(hull.lo)
    extended_hull_hi = dict(hull.hi)
    for d in red_dims:
        lo_b, hi_b = d.lower, d.upper
        for bound, is_lower in ((d.lower, True), (d.upper, False)):
            dep = [v for v in bound.vars() if v in out_frame]
            if not dep:
                continue
            if len(dep) > 1 or bound.coeff(dep[0]) != 1:
                raise RaiseError("complex triangular reduce bound")
            ov = dep[0]
            rest = bound.drop([ov])
            if not rest.is_constant():
                raise RaiseError("symbolic triangular reduce bound")
            off = rest.const
            if is_lower:
                masks.append(MaskOperand(d.var, ov, ">=", off, ""))
                lo_b = extended_hull_lo[ov] + off
            else:
                masks.append(MaskOperand(d.var, ov, "<", off, ""))
                hi_b = extended_hull_hi[ov] + off - 1
        bad = [v for v in list(lo_b.vars()) + list(hi_b.vars())
               if v in out_frame or v in red_vars]
        if bad:
            raise RaiseError("unresolvable reduce bound")
        widened.append(LoopDim(d.var, lo_b, hi_b, d.step))
        extended_hull_lo[d.var] = lo_b
        extended_hull_hi[d.var] = hi_b

    # Letter assignment
    letter_of: Dict[str, str] = {}

    def letter(v: str) -> str:
        if v not in letter_of:
            if len(letter_of) >= len(_LETTERS):
                raise RaiseError("too many einsum dims")
            letter_of[v] = _LETTERS[len(letter_of)]
        return letter_of[v]

    operands: List[EinsumOperand] = []
    used_out: List[str] = []
    for acc in accesses:
        letters = ""
        for idx in acc.idx:
            ivars = [v for v in idx.vars()
                     if v in out_frame or v in red_vars]
            if len(ivars) == 0:
                letters += "."  # fixed index — sliced away, no letter
            elif len(ivars) == 1 and idx.coeff(ivars[0]) == 1:
                letters += letter(ivars[0])
                if ivars[0] in out_frame and ivars[0] not in used_out:
                    used_out.append(ivars[0])
            else:
                raise RaiseError("non-sliceable access index")
        letters = letters.replace(".", "")
        operands.append(EinsumOperand(acc, letters))

    for m in masks:
        m.letters = letter(m.row_var) + letter(m.col_var)
        for v in (m.row_var, m.col_var):
            if v in out_frame and v not in used_out:
                used_out.append(v)

    out_vars = tuple(v for v in out_frame if v in used_out)
    out_letters = "".join(letter(v) for v in out_vars)
    in_specs = [op.letters for op in operands] + [m.letters for m in masks]
    spec = ",".join(in_specs) + "->" + out_letters
    return EinsumSpec(operands, masks, out_letters, out_vars,
                      tuple(widened), spec)


# ---------------------------------------------------------------------------
# Write plans
# ---------------------------------------------------------------------------

@dataclass
class WritePlan:
    kind: str  # 'full' | 'slice' | 'masked' | 'diag' | 'scalar'
    # masked: conds from the hull (triangular out dims)
    conds: List[Tuple[str, str, str, int]] = field(default_factory=list)


def plan_write(stmt: CanonStmt, hull: Hull) -> WritePlan:
    if stmt.write_full or stmt.write_is_temp:
        return WritePlan("full")
    if not stmt.write_idx:
        return WritePlan("scalar")
    # diagonal pattern: several idx dims driven by the same iterator
    seen_iters: List[str] = []
    for idx in stmt.write_idx:
        ivs = [v for v in idx.vars()
               if v in {d.var for d in stmt.domain.dims}]
        if len(ivs) > 1:
            raise RaiseError("multi-iterator write index")
        if ivs:
            seen_iters.append(ivs[0])
    if len(set(seen_iters)) < len(seen_iters):
        if len(set(seen_iters)) == 1:
            return WritePlan("diag")
        raise RaiseError("repeated iterators across write dims")
    if hull.conds:
        return WritePlan("masked", list(hull.conds))
    return WritePlan("slice")
