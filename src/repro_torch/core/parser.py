"""Front-end: Python source → Typed IR.

Parses type-hinted kernel functions (paper §3: "kernel functions with type
annotations are first translated by the Front-end to an AST representation")
and runs type inference over the TIR using knowledge-base type rules.

Anything outside the analyzable subset degrades to a tir.Opaque black-box
statement with conservative read/write sets (paper §4.2) — the kernel still
compiles; only that statement is excluded from polyhedral optimization.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Callable, Dict, List, Optional, Tuple

from . import knowledge
from . import tir
from .types import TypeInfo, broadcast, parse_annotation, promote_dtype

_BINOPS = {
    ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/",
    ast.FloorDiv: "//", ast.Mod: "%", ast.Pow: "**", ast.MatMult: "@",
}
_CMPOPS = {
    ast.Lt: "<", ast.LtE: "<=", ast.Gt: ">", ast.GtE: ">=",
    ast.Eq: "==", ast.NotEq: "!=",
}


class ParseError(Exception):
    pass


def _call_name(node: ast.Call) -> Optional[Tuple[str, Optional[ast.expr]]]:
    """Flatten a call target into (registry name, receiver-or-None):
    ('np.fft.fft', None), ('method.sum', <receiver expr>), ('range', None)…
    """
    f = node.func
    parts: List[str] = []
    probe = f
    while isinstance(probe, ast.Attribute):
        parts.append(probe.attr)
        probe = probe.value
    if isinstance(probe, ast.Name):
        dotted = ".".join(reversed(parts + [probe.id]))
        if dotted.startswith("numpy."):
            dotted = "np." + dotted[len("numpy."):]
        if dotted.startswith("np.") or dotted in ("range", "len", "min",
                                                  "max", "abs", "float",
                                                  "int"):
            return dotted, None
    # receiver.method(...) — receiver may be any expression
    if isinstance(f, ast.Attribute):
        return "method." + f.attr, f.value
    if isinstance(f, ast.Name):
        return f.id, None
    return None


class _FnParser(ast.NodeVisitor):
    def __init__(self, src: str, global_syms: Dict[str, object]):
        self.src_lines = src.splitlines()
        self.globals = global_syms
        self.sym_params: List[str] = []

    # -- expressions ---------------------------------------------------
    def expr(self, node: ast.expr) -> tir.Expr:
        if isinstance(node, ast.Constant):
            return tir.Const(value=node.value)
        if isinstance(node, ast.Name):
            return tir.Name(id=node.id)
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.USub):
                return tir.UnaryOp(op="-", operand=self.expr(node.operand))
            raise ParseError("unsupported unary op")
        if isinstance(node, ast.BinOp):
            op = _BINOPS.get(type(node.op))
            if op is None:
                raise ParseError("unsupported binop")
            return tir.BinOp(op=op, left=self.expr(node.left),
                             right=self.expr(node.right))
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1:
                raise ParseError("chained compare")
            return tir.Compare(op=_CMPOPS[type(node.ops[0])],
                               left=self.expr(node.left),
                               right=self.expr(node.comparators[0]))
        if isinstance(node, ast.Subscript):
            return self._subscript(node)
        if isinstance(node, ast.Attribute):
            # arr.T / arr.shape handled as pseudo-calls
            if node.attr == "T":
                return tir.Call(fn="method.T", args=(self.expr(node.value),))
            if node.attr == "shape":
                return tir.Call(fn="method.shape",
                                args=(self.expr(node.value),))
            raise ParseError(f"unsupported attribute .{node.attr}")
        if isinstance(node, ast.Call):
            got = _call_name(node)
            if got is None:
                raise ParseError("unanalyzable call")
            name, recv = got
            args: List[tir.Expr] = []
            if recv is not None:
                args.append(self.expr(recv))
            args.extend(self.expr(a) for a in node.args)
            kwargs = {}
            for kw in node.keywords:
                if kw.arg is None:
                    raise ParseError("**kwargs unsupported")
                kwargs[kw.arg] = self.expr(kw.value)
            return tir.Call(fn=name, args=tuple(args), kwargs=kwargs)
        if isinstance(node, ast.Tuple):
            raise ParseError("tuple expression")
        raise ParseError(f"unsupported expr {ast.dump(node)[:60]}")

    def _subscript(self, node: ast.Subscript) -> tir.Subscript:
        base = self.expr(node.value)
        sl = node.slice
        elems = list(sl.elts) if isinstance(sl, ast.Tuple) else [sl]
        indices: List[tir.Expr] = []
        for e in elems:
            if isinstance(e, ast.Slice):
                indices.append(tir.SliceExpr(
                    lo=self.expr(e.lower) if e.lower else None,
                    hi=self.expr(e.upper) if e.upper else None,
                    step=self.expr(e.step) if e.step else None))
            else:
                indices.append(tir.IndexExpr(value=self.expr(e)))
        # a[i][j] → flatten into one Subscript with two indices
        if isinstance(base, tir.Subscript):
            return tir.Subscript(base=base.base,
                                 indices=base.indices + tuple(indices))
        return tir.Subscript(base=base, indices=tuple(indices))

    # -- statements -----------------------------------------------------
    def stmts(self, body: List[ast.stmt]) -> List[tir.Stmt]:
        out: List[tir.Stmt] = []
        for node in body:
            out.extend(self.stmt(node))
        return out

    def _opaque(self, node: ast.stmt) -> tir.Opaque:
        seg = ast.get_source_segment("\n".join(self.src_lines), node)
        reads, writes = set(), set()
        for n in ast.walk(node):
            if isinstance(n, ast.Name):
                if isinstance(n.ctx, ast.Store):
                    writes.add(n.id)
                else:
                    reads.add(n.id)
        return tir.Opaque(src=seg or "", reads=tuple(sorted(reads)),
                          writes=tuple(sorted(writes)))

    def stmt(self, node: ast.stmt) -> List[tir.Stmt]:
        try:
            return self._stmt(node)
        except ParseError:
            return [self._opaque(node)]

    def _stmt(self, node: ast.stmt) -> List[tir.Stmt]:
        if isinstance(node, ast.Expr):
            if isinstance(node.value, ast.Constant):
                return []  # docstring
            return [tir.ExprStmt(value=self.expr(node.value))]
        if isinstance(node, ast.Assign):
            if len(node.targets) != 1:
                raise ParseError("multi-target assign")
            tgt = node.targets[0]
            if isinstance(tgt, ast.Tuple):
                raise ParseError("tuple unpack")
            return [tir.Assign(target=self.expr(tgt),
                               value=self.expr(node.value))]
        if isinstance(node, ast.AugAssign):
            op = _BINOPS.get(type(node.op))
            if op is None:
                raise ParseError("unsupported augop")
            return [tir.Assign(target=self.expr(node.target),
                               value=self.expr(node.value), aug=op)]
        if isinstance(node, ast.AnnAssign) and node.value is not None:
            return [tir.Assign(target=self.expr(node.target),
                               value=self.expr(node.value))]
        if isinstance(node, ast.For):
            if not isinstance(node.target, ast.Name) or node.orelse:
                raise ParseError("non-name loop var")
            it = node.iter
            if not (isinstance(it, ast.Call)
                    and _call_name(it) == ("range", None)):
                raise ParseError("non-range for")
            rargs = [self.expr(a) for a in it.args]
            if len(rargs) == 1:
                lo, hi, step = tir.Const(value=0), rargs[0], tir.Const(value=1)
            elif len(rargs) == 2:
                lo, hi, step = rargs[0], rargs[1], tir.Const(value=1)
            else:
                lo, hi, step = rargs
            return [tir.For(var=node.target.id, lo=lo, hi=hi, step=step,
                            body=self.stmts(node.body))]
        if isinstance(node, ast.If):
            return [tir.If(cond=self.expr(node.test),
                           body=self.stmts(node.body),
                           orelse=self.stmts(node.orelse))]
        if isinstance(node, ast.Return):
            return [tir.Return(value=self.expr(node.value)
                               if node.value else None)]
        if isinstance(node, (ast.Pass,)):
            return []
        raise ParseError(f"unsupported stmt {type(node).__name__}")


# ---------------------------------------------------------------------------
# Type inference
# ---------------------------------------------------------------------------

class TypeInference:
    """Forward dataflow over the TIR, knowledge-base type rules for calls."""

    def __init__(self, fn: tir.Function):
        self.fn = fn
        self.env: Dict[str, TypeInfo] = {n: t for n, t in fn.params}

    def run(self) -> None:
        self._block(self.fn.body)

    def _block(self, body: List[tir.Stmt]) -> None:
        for s in body:
            if isinstance(s, tir.Assign):
                self._expr(s.value)
                if isinstance(s.target, tir.Name):
                    prev = self.env.get(s.target.id)
                    new = s.value.ty
                    if prev is not None and prev.kind == "array" and \
                            new.kind == "array":
                        new = TypeInfo.array(
                            promote_dtype(prev.dtype, new.dtype) or "float64",
                            prev.rank or new.rank)
                    self.env[s.target.id] = new
                    s.target.ty = new
                elif isinstance(s.target, tir.Subscript):
                    self._expr(s.target)
            elif isinstance(s, tir.For):
                self.env[s.var] = TypeInfo.scalar("int64")
                for e in (s.lo, s.hi, s.step):
                    if e is not None:
                        self._expr(e)
                self._block(s.body)
            elif isinstance(s, tir.If):
                self._expr(s.cond)
                self._block(s.body)
                self._block(s.orelse)
            elif isinstance(s, tir.Return) and s.value is not None:
                self._expr(s.value)
                self.fn.ret = s.value.ty
            elif isinstance(s, tir.ExprStmt):
                self._expr(s.value)
            elif isinstance(s, tir.Opaque):
                for w in s.writes:  # black-box poisons its writes
                    self.env[w] = TypeInfo.unknown()

    def _expr(self, e: tir.Expr) -> TypeInfo:
        t = self._expr_inner(e)
        e.ty = t
        return t

    def _expr_inner(self, e: tir.Expr) -> TypeInfo:
        if isinstance(e, tir.Const):
            if isinstance(e.value, bool):
                return TypeInfo.scalar("bool")
            if isinstance(e.value, int):
                return TypeInfo.scalar("int64")
            if isinstance(e.value, float):
                return TypeInfo.scalar("float64")
            if isinstance(e.value, complex):
                return TypeInfo.scalar("complex128")
            return TypeInfo.unknown()
        if isinstance(e, tir.Name):
            return self.env.get(e.id, TypeInfo.unknown())
        if isinstance(e, tir.UnaryOp):
            return self._expr(e.operand)
        if isinstance(e, tir.BinOp):
            lt, rt = self._expr(e.left), self._expr(e.right)
            if e.op == "@":
                entry = knowledge.lookup("np.matmul")
                return entry.type_rule(lt, rt)
            if e.op == "/":
                out = broadcast(lt, rt)
                dt = out.dtype
                if dt in ("int64", "int32", "bool", None):
                    dt = "float64"
                return (TypeInfo.scalar(dt) if out.rank == 0
                        else TypeInfo.array(dt, out.rank))
            return broadcast(lt, rt)
        if isinstance(e, tir.Compare):
            self._expr(e.left)
            self._expr(e.right)
            return TypeInfo.scalar("bool")
        if isinstance(e, tir.Subscript):
            bt = self._expr(e.base).as_array()
            for i in e.indices:
                self._expr(i)
            if bt.kind != "array":
                return TypeInfo.unknown()
            dropped = sum(1 for i in e.indices
                          if isinstance(i, tir.IndexExpr))
            rank = max(0, (bt.rank or len(e.indices)) - dropped)
            return (TypeInfo.scalar(bt.dtype or "float64") if rank == 0
                    else TypeInfo.array(bt.dtype or "float64", rank))
        if isinstance(e, (tir.IndexExpr,)):
            return self._expr(e.value)
        if isinstance(e, tir.SliceExpr):
            for s in (e.lo, e.hi, e.step):
                if s is not None:
                    self._expr(s)
            return TypeInfo.unknown()
        if isinstance(e, tir.Call):
            arg_ts = [self._expr(a) for a in e.args]
            kw_ts = {k: self._expr(v) for k, v in e.kwargs.items()}
            if e.fn == "method.shape":
                return TypeInfo.unknown()
            entry = knowledge.lookup(e.fn)
            if entry is None:
                return TypeInfo.unknown()
            kw: Dict[str, object] = {}
            if "axis" in e.kwargs and isinstance(e.kwargs["axis"], tir.Const):
                kw["axis"] = e.kwargs["axis"].value
            if entry.semantic[0] == "alloc":
                rank = 1
                if e.args and isinstance(e.args[0], tir.Call):
                    pass
                if e.args:
                    a0 = e.args[0]
                    if isinstance(a0, tir.Const):
                        rank = 1
                # np.zeros((m, n)) parsed as Call with Tuple → Opaque; our
                # corpus uses np.zeros_like-free explicit shapes via helper
                shape_arg = e.kwargs.get("shape")
                return entry.type_rule(dtype="float64", rank=rank)
            try:
                return entry.type_rule(*arg_ts, **kw)
            except Exception:
                return TypeInfo.unknown()
        return TypeInfo.unknown()


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def parse_function(fn: Callable,
                   hint_overrides: Optional[Dict[str, str]] = None
                   ) -> tir.Function:
    """Parse a live Python function (with type hints) into typed TIR.

    ``hint_overrides`` maps parameter names to hint strings and takes
    precedence over source annotations — this is how profiler-synthesized
    hints (paper §1: hints "obtained by dynamic profiler tools") enter the
    same front-end as hand-written ones.
    """
    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    fdef = None
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            fdef = node
            break
    if fdef is None:
        raise ParseError("no function def found")
    try:
        hints = dict(getattr(fn, "__annotations__", {}) or {})
    except Exception:  # pragma: no cover
        hints = {}
    if hint_overrides:
        hints.update(hint_overrides)
    params: List[Tuple[str, TypeInfo]] = []
    for a in fdef.args.args:
        if a.arg == "self":
            continue
        ann = hints.get(a.arg)
        if ann is None and a.annotation is not None:
            if isinstance(a.annotation, ast.Constant):
                ann = a.annotation.value
            elif isinstance(a.annotation, ast.Name):
                ann = a.annotation.id
        params.append((a.arg, parse_annotation(ann)))
    p = _FnParser(src, getattr(fn, "__globals__", {}))
    body = p.stmts(fdef.body)
    out = tir.Function(name=fdef.name, params=params, body=body,
                       ret=parse_annotation(hints.get("return")))
    # structure parameters: int-typed params + any free names
    bound = {n for n, _ in params}
    for s in tir.walk_stmts(out.body):
        if isinstance(s, tir.For):
            bound.add(s.var)
        if isinstance(s, tir.Assign) and isinstance(s.target, tir.Name):
            bound.add(s.target.id)
    free: List[str] = []
    for s in tir.walk_stmts(out.body):
        r, _ = tir.stmt_reads_writes(s)
        for n in r:
            if n not in bound and n not in free and n not in ("np", "numpy"):
                free.append(n)
    out.sym_params = sorted(
        set(free) | {n for n, t in params if t.is_numeric_scalar
                     and t.dtype in ("int64", "int32")})
    TypeInference(out).run()
    return out
