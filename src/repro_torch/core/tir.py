"""Typed IR (TIR) — the compiler's AST.

Mirrors the paper's use of the Python Typed AST package as baseline IR
(§4.4): a small expression/statement language covering the affine+NumPy
subset that AutoMPHC optimizes, with a TypeInfo slot on every expression
filled in by inference (core/parser.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .types import TypeInfo


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

@dataclass
class Expr:
    ty: TypeInfo = field(default_factory=TypeInfo.unknown, kw_only=True)


@dataclass
class Const(Expr):
    value: Any = None


@dataclass
class Name(Expr):
    id: str = ""


@dataclass
class BinOp(Expr):
    op: str = ""  # '+', '-', '*', '/', '//', '%', '**', '@'
    left: Expr = None
    right: Expr = None


@dataclass
class UnaryOp(Expr):
    op: str = ""  # '-', 'not'
    operand: Expr = None


@dataclass
class Compare(Expr):
    op: str = ""  # '<', '<=', '>', '>=', '==', '!='
    left: Expr = None
    right: Expr = None


@dataclass
class IndexExpr(Expr):
    """A single subscript component: point index."""

    value: Expr = None


@dataclass
class SliceExpr(Expr):
    """lo:hi:step — any may be None."""

    lo: Optional[Expr] = None
    hi: Optional[Expr] = None
    step: Optional[Expr] = None


@dataclass
class Subscript(Expr):
    base: Expr = None
    # mixed tuple of IndexExpr / SliceExpr, one per subscripted dim
    indices: Tuple[Expr, ...] = ()


@dataclass
class Call(Expr):
    """Library or method call, canonicalized to a flat name.

    ``fn`` examples: 'np.dot', 'np.sqrt', 'method.sum', 'method.T',
    'np.fft.fft', 'range', 'len', 'np.zeros'.  For method calls the
    receiver is args[0].
    """

    fn: str = ""
    args: Tuple[Expr, ...] = ()
    kwargs: Dict[str, Expr] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------

@dataclass
class Stmt:
    pass


@dataclass
class Assign(Stmt):
    target: Expr = None  # Name or Subscript
    value: Expr = None
    aug: Optional[str] = None  # '+' for +=, etc.; None for plain =


@dataclass
class For(Stmt):
    var: str = ""
    lo: Expr = None
    hi: Expr = None
    step: Expr = None  # Const(1) default
    body: List[Stmt] = field(default_factory=list)
    # annotations added by the scheduler:
    parallel: bool = False        # provably dependence-free across iterations
    distributed: bool = False     # chosen for inter-node pfor distribution
    tile: Optional[int] = None


@dataclass
class If(Stmt):
    cond: Expr = None
    body: List[Stmt] = field(default_factory=list)
    orelse: List[Stmt] = field(default_factory=list)


@dataclass
class Return(Stmt):
    value: Optional[Expr] = None


@dataclass
class ExprStmt(Stmt):
    value: Expr = None


@dataclass
class Opaque(Stmt):
    """Black-box statement (paper §4.2): unanalyzable code carried through
    with conservative read/write sets so the rest of the kernel still
    optimizes. ``src`` is the original source text re-emitted verbatim."""

    src: str = ""
    reads: Tuple[str, ...] = ()
    writes: Tuple[str, ...] = ()


@dataclass
class Function:
    name: str = ""
    params: List[Tuple[str, TypeInfo]] = field(default_factory=list)
    body: List[Stmt] = field(default_factory=list)
    ret: TypeInfo = field(default_factory=TypeInfo.unknown)
    # free symbols treated as structure parameters (sizes like M, N)
    sym_params: List[str] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Walkers
# ---------------------------------------------------------------------------

def walk_exprs(e: Expr):
    """Yield e and all sub-expressions."""
    if e is None:
        return
    yield e
    if isinstance(e, BinOp):
        yield from walk_exprs(e.left)
        yield from walk_exprs(e.right)
    elif isinstance(e, UnaryOp):
        yield from walk_exprs(e.operand)
    elif isinstance(e, Compare):
        yield from walk_exprs(e.left)
        yield from walk_exprs(e.right)
    elif isinstance(e, Subscript):
        yield from walk_exprs(e.base)
        for i in e.indices:
            yield from walk_exprs(i)
    elif isinstance(e, IndexExpr):
        yield from walk_exprs(e.value)
    elif isinstance(e, SliceExpr):
        for s in (e.lo, e.hi, e.step):
            if s is not None:
                yield from walk_exprs(s)
    elif isinstance(e, Call):
        for a in e.args:
            yield from walk_exprs(a)
        for a in e.kwargs.values():
            yield from walk_exprs(a)


def walk_stmts(stmts: List[Stmt]):
    for s in stmts:
        yield s
        if isinstance(s, For):
            yield from walk_stmts(s.body)
        elif isinstance(s, If):
            yield from walk_stmts(s.body)
            yield from walk_stmts(s.orelse)


def expr_names(e: Expr) -> List[str]:
    return [x.id for x in walk_exprs(e) if isinstance(x, Name)]


def stmt_reads_writes(s: Stmt) -> Tuple[set, set]:
    """Conservative variable-level read/write sets for one statement."""
    reads, writes = set(), set()
    if isinstance(s, Assign):
        if isinstance(s.target, Name):
            writes.add(s.target.id)
        elif isinstance(s.target, Subscript):
            base = s.target.base
            while isinstance(base, Subscript):
                base = base.base
            if isinstance(base, Name):
                writes.add(base.id)
            for i in s.target.indices:
                reads.update(expr_names(i))
        reads.update(expr_names(s.value))
        if s.aug is not None and isinstance(s.target, Subscript):
            base = s.target.base
            while isinstance(base, Subscript):
                base = base.base
            if isinstance(base, Name):
                reads.add(base.id)
    elif isinstance(s, For):
        reads.update(expr_names(s.lo))
        reads.update(expr_names(s.hi))
        if s.step is not None:
            reads.update(expr_names(s.step))
        for b in s.body:
            r, w = stmt_reads_writes(b)
            reads |= r
            writes |= w
        reads.discard(s.var)
    elif isinstance(s, If):
        reads.update(expr_names(s.cond))
        for b in list(s.body) + list(s.orelse):
            r, w = stmt_reads_writes(b)
            reads |= r
            writes |= w
    elif isinstance(s, Return):
        if s.value is not None:
            reads.update(expr_names(s.value))
    elif isinstance(s, ExprStmt):
        reads.update(expr_names(s.value))
    elif isinstance(s, Opaque):
        reads.update(s.reads)
        writes.update(s.writes)
    return reads, writes
