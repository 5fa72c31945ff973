"""Code generation: scheduled SCoP → optimized Python source.

Two backends, mirroring the paper's §4.3 variants:
  * ``np``    — optimized CPU code (NumPy library mapping);
  * ``torch`` — accelerator code through the numpy-compatible torch
    namespace :mod:`repro_torch.core.txp` (the port's counterpart of the
    reference's jnp variant; the paper's NumPy→CuPy conversion). The
    whole-kernel torch variant copies its array parameters to the device
    in its preamble, writes those device tensors *in place* (no
    functional ``.at[]`` rebuilds) and returns the written ones; the
    dispatcher copies them home into the caller's buffers.

The *whole-kernel* torch variant is all-or-nothing, like the paper's CuPy
conversion: any black-box statement, loop fallback, or pfor makes it
infeasible (EmitError) and the decision tree keeps the optimized-NumPy
and original variants.

Backend selection is additionally **per unit** (the heterogeneous-fleet
refactor): when a kernel contains pfor units, the np variant emits, next
to the in-place NumPy chunk body, one twin per registered accelerator
backend that takes the unit (:mod:`repro_torch.core.backends`):

  * the ``torch`` twin (``__pfor_body_N__torch``) of every
    accelerator-feasible body computes through ``__txp`` on the worker's
    device and stores its writes into the captured NumPy arrays with an
    explicit device→host copy (``__txp.host``), so the cluster runtime's
    sparse-diff gather works unchanged. A row-parallel body also leads
    with a batched fast path: its per-iteration function goes to
    ``__pfor_batch`` (:func:`repro_torch.distrib.accel.pfor_batch`,
    ``torch.func.vmap`` over the chunk), and the eager per-iteration loop
    stays behind it on the same device;
  * the ``cuda`` twin of a matmul-, attention- or scan-shaped body calls
    a hand-written kernel behind ``__cuk``.

Every body is stamped ``__backend__`` and ``__sliceable__``, and the np
body carries each twin under its backend's attribute (``__torch__``,
``__cuda__``) — the cluster runtime routes each worker's chunks to
whichever body its device profile prices cheapest.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import backends as backends_mod
from . import tir
from .isl_lite import Affine, LoopDim
from .raising import (EinsumSpec, Hull, MaskOperand, RaiseError, WritePlan,
                      compute_hull, normalize, plan_einsum, plan_write)
from .schedule import (FFTUnit, OpaqueUnit, PforUnit, RaisedUnit, Schedule,
                       SeqLoopUnit, Unit)
from .scop import (CanonStmt, VAccess, VBin, VConst, VExpr, VParam, VReduce,
                   VUnary, substitute_array_reads, vexpr_accesses)


class EmitError(Exception):
    pass


# python operator → its function in repro_torch.core.txp
_TXP_BINOPS = {"+": "add", "-": "subtract", "*": "multiply",
               "/": "true_divide", "//": "floor_divide", "%": "remainder",
               "**": "power"}


def _python_numbers(e: VExpr) -> bool:
    """True when ``e`` computes on constants and scalar parameters under
    python operators only, so no tensor enters it."""
    if isinstance(e, (VConst, VParam)):
        return True
    if isinstance(e, VUnary):
        return e.fn == "-" and _python_numbers(e.operand)
    if isinstance(e, VBin):
        return (not e.op.startswith("np.") and _python_numbers(e.left)
                and _python_numbers(e.right))
    return False


def _uses_red_var(e: VExpr, var: str) -> bool:
    if isinstance(e, VAccess):
        return any(var in idx.vars() for idx in e.idx)
    if isinstance(e, VBin):
        return _uses_red_var(e.left, var) or _uses_red_var(e.right, var)
    if isinstance(e, VUnary):
        return _uses_red_var(e.operand, var)
    if isinstance(e, VReduce):
        return _uses_red_var(e.child, var)
    return False


# ---------------------------------------------------------------------------
# Affine → Python
# ---------------------------------------------------------------------------

def affine_py(a: Affine) -> str:
    parts: List[str] = []
    for k, c in a.coeffs:
        if c == 1:
            parts.append(k)
        elif c == -1:
            parts.append(f"-{k}")
        else:
            parts.append(f"{c}*{k}")
    if a.const or not parts:
        parts.append(str(a.const))
    out = " + ".join(parts).replace("+ -", "- ")
    return out if len(parts) == 1 else f"({out})"


# ---------------------------------------------------------------------------
# Emitter
# ---------------------------------------------------------------------------

@dataclass
class EmitMeta:
    accel_ok: bool = True
    uses_pfor: bool = False
    pfor_count: int = 0
    raised_ops: List[str] = field(default_factory=list)
    # copied from the schedule's fusion pass so cached variants carry
    # their own telemetry (fused statements / contracted intermediates)
    fused_units: int = 0
    contracted_arrays: List[str] = field(default_factory=list)
    # torch-twin units whose twin also carries a per-iteration function
    # for the batched path; the exec namespace must bind __pfor_batch
    pfor_batch_units: List[int] = field(default_factory=list)
    # backend name → pfor unit indices that got that backend's twin
    # (registry-driven). The exec namespace must merge each listed
    # backend's namespace() bindings.
    pfor_twin_units: Dict[str, List[int]] = field(default_factory=dict)


class Emitter:
    def __init__(self, sched: Schedule, backend: str):
        assert backend in ("np", "torch")
        self.s = sched
        self.backend = backend
        self.lines: List[str] = []
        self.depth = 1
        self.bound: Set[str] = set()  # loop vars live as python scalars
        self.meta = EmitMeta()
        self.tmp_counter = itertools.count()
        # shape symbols for locally-defined arrays, emitted lazily right
        # after the defining statement: {array: [sym, …]}
        self.pending_syms: Dict[str, List[str]] = {}
        # name the backend module is bound to in the generated namespace
        # ("xp" normally; "__txp" for the torch twin of a pfor body, which
        # lives inside an np-variant whose "xp" is numpy)
        self.xp = "xp"
        # also emit each registered backend's twin for every pfor unit
        # (np variant only)
        self.pfor_twins = False
        # eager twin mode: compute with torch on the device, read
        # *captured* numpy arrays through a device copy of the slice
        # read, and store into them with a device→host copy so the
        # worker's sparse-diff gather sees the writes; arrays fully
        # assigned inside the body are locals (device tensors) written
        # in place
        self.store_np_captured = False
        self.body_locals: Set[str] = set()
        # batch-iteration mode: emit ONE pfor iteration as a function of
        # (g, __offs, *arrays) for torch.func.vmap via __pfor_batch.
        # Captured arrays indexed by the pfor var collapse to
        # per-iteration row variables; every other captured array
        # becomes an explicit (read-only) parameter; writes land in the
        # row variables and are returned for the caller to scatter.
        self.batch_iter = False
        self.batch_pfor_var: Optional[str] = None
        self.batch_params: Dict[str, int] = {}   # array name → arg position
        self.batch_rows: Dict[str, str] = {}     # array name → row variable
        self.batch_write_arrays: List[str] = []  # row arrays written (order)
        self._assign_log: List[str] = []       # assignment events, in order
        self._batch_future: List[Unit] = []      # units after current one
        self._batch_loop_depth = 0
        # row captures first touched inside a sequential loop: their
        # prelude depends only on (g, __offs, params), so it hoists
        # above the outermost loop instead of bailing the batched path
        self._batch_hoist: List[str] = []

    def define_syms_for(self, arr: str) -> None:
        for sym in self.pending_syms.pop(arr, []):
            d = sym.rsplit("__d", 1)[1]
            self.w(f"{sym} = {arr}.shape[{d}]")
            self._note_assign(sym)

    # -- low-level -------------------------------------------------------
    def w(self, line: str) -> None:
        self.lines.append("    " * self.depth + line)

    def fresh(self, p: str = "v") -> str:
        return f"__{p}{next(self.tmp_counter)}"

    # -- frames ------------------------------------------------------------
    def free_dims(self, stmt: CanonStmt) -> List[LoopDim]:
        return [d for d in stmt.domain.dims if d.var not in self.bound]

    # -- expression emission -------------------------------------------
    def emit_expr(self, e: VExpr, frame: Tuple[str, ...],
                  hull: Hull) -> str:
        if isinstance(e, VConst):
            return repr(e.value)
        if isinstance(e, VParam):
            return e.name
        if isinstance(e, VUnary):
            inner = self.emit_expr(e.operand, frame, hull)
            if e.fn == "-":
                return f"(-{inner})"
            if e.fn.startswith("np."):
                return f"{self.xp}.{e.fn[3:]}({inner})"
            return f"{e.fn}({inner})"
        if isinstance(e, VBin):
            l = self.emit_expr(e.left, frame, hull)
            r = self.emit_expr(e.right, frame, hull)
            return self._binop(e, l, r)
        if isinstance(e, VAccess):
            return self.emit_access_aligned(e, frame, hull)
        if isinstance(e, VReduce):
            try:
                spec = plan_einsum(e, frame, hull)
                return self.emit_einsum(spec, frame, hull)
            except RaiseError:
                return self.emit_elementwise_sum(e, frame, hull)
        raise EmitError(f"cannot emit {type(e).__name__}")

    def _binop(self, e: VBin, l: str, r: str) -> str:
        """A binary operation as emitted. torch code writes an arithmetic
        operator over a tensor as its numpy name in the torch namespace,
        which computes at numpy's result dtype (an integer divided by 3
        is float64, a float32 tensor times a python float stays float32);
        torch's own operators would give its default float32 for integer
        operands. Arithmetic on constants and scalar parameters alone
        touches no tensor and keeps python's operator."""
        op = e.op
        if op.startswith("np."):
            return f"{self.xp}.{op[3:]}({l}, {r})"
        if self.backend == "torch" and op in _TXP_BINOPS \
                and not _python_numbers(e):
            return f"{self.xp}.{_TXP_BINOPS[op]}({l}, {r})"
        return f"({l} {op} {r})"

    def emit_elementwise_sum(self, e: VReduce, frame: Tuple[str, ...],
                             hull: Hull) -> str:
        """Σ over rectangular reduce dims of an arbitrary elementwise
        expression: emit the expression over frame+reduce dims, then
        ``.sum(axis=…)`` (Table 2's sum_2D,axis=k raising)."""
        # reduce bounds must not depend on out iterators (else einsum+mask
        # was the only vectorized option and we fall back to loops)
        for d in e.dims:
            for b in (d.lower, d.upper):
                if any(v in frame for v in b.vars()):
                    raise RaiseError("triangular bound in elementwise sum")
            if not _uses_red_var(e.child, d.var):
                raise RaiseError("reduce var unused in child")
        frame2 = tuple(frame) + tuple(d.var for d in e.dims)
        hull2 = Hull(dict(hull.lo), dict(hull.hi), list(hull.conds))
        for d in e.dims:
            hull2.lo[d.var] = d.lower
            hull2.hi[d.var] = d.upper
        inner = self.emit_expr(e.child, frame2, hull2)
        axes = tuple(range(len(frame), len(frame2)))
        ax = axes[0] if len(axes) == 1 else axes
        self.meta.raised_ops.append("sum")
        return f"({inner}).sum(axis={ax})"

    def access_slices_and_dims(
        self, acc: VAccess, frame: Tuple[str, ...], hull: Hull,
        extra_lo: Dict[str, Affine] = None, extra_hi: Dict[str, Affine] = None,
    ) -> Tuple[str, List[str]]:
        """Slice string for an access + ordered iterator vars of its dims."""
        extra_lo = extra_lo or {}
        extra_hi = extra_hi or {}
        base, idx_list = acc.array, list(acc.idx)
        if self.batch_iter:
            base, idx_list = self._batch_rebase(acc.array, idx_list,
                                                is_write=False)
        comps: List[str] = []
        order: List[str] = []
        for idx in idx_list:
            ivars = [v for v in idx.vars()
                     if v in frame or v in extra_lo]
            if not ivars:
                comps.append(affine_py(idx))
                continue
            if len(ivars) > 1:
                raise RaiseError("multi-iterator access index")
            v = ivars[0]
            if idx.coeff(v) != 1:
                raise RaiseError("non-unit access stride")
            rest = idx.drop([v])
            lo = (extra_lo.get(v) or hull.lo[v]) + rest
            hi = (extra_hi.get(v) or hull.hi[v]) + rest
            comps.append(f"{affine_py(lo)}:{affine_py(hi)}")
            order.append(v)
        sl = f"{base}[{', '.join(comps)}]" if comps else base
        return self._read(acc.array, sl), order

    def _read(self, array: str, src: str) -> str:
        """A read of ``array`` as emitted: in an eager torch twin a
        captured numpy array is read through a device copy of the slice
        (numpy and torch operands do not mix in one expression)."""
        if self.store_np_captured and array not in self.body_locals:
            return f"{self.xp}.asarray({src})"
        return src

    # -- batch-iteration helpers -------------------------------------------
    def _batch_rebase(self, array: str, idx: List[Affine],
                      is_write: bool) -> Tuple[str, List[Affine]]:
        """Route one array access for the batch-iteration function: body
        locals pass through; g-free captured arrays become parameters;
        ``A[g, …]`` accesses collapse onto A's row variable. Anything
        else (g in a later dim, non-identity g index) bails the batched
        path."""
        g = self.batch_pfor_var
        if array in self.body_locals:
            return array, idx
        uses_g = [i for i, a in enumerate(idx) if g in a.vars()]
        if not uses_g:
            if array in self.batch_rows:
                raise EmitError("batch: whole-array access after row capture")
            if is_write:
                raise EmitError("batch: g-free write to captured array")
            self._batch_param(array)
            return array, idx
        if uses_g != [0] or affine_py(idx[0]) != g:
            raise EmitError("batch: non-row pfor indexing")
        return self._batch_row(array), list(idx[1:])

    def _note_assign(self, name: str) -> None:
        if self.batch_iter:
            self._assign_log.append(name)

    def _batch_param(self, array: str) -> int:
        if array not in self.batch_params:
            self.batch_params[array] = len(self.batch_params)
        return self.batch_params[array]

    def _batch_row(self, array: str) -> str:
        row = self.batch_rows.get(array)
        if row is not None:
            return row
        pos = self._batch_param(array)
        row = f"__row_{array}"
        line = f"{row} = {array}[{self.batch_pfor_var} - __offs[{pos}]]"
        if self._batch_loop_depth:
            # hoisted above the loop — not an in-loop assignment event
            self._batch_hoist.append(line)
        else:
            self.w(line)
            self._note_assign(row)
        self.batch_rows[array] = row
        self.body_locals.add(row)
        return row

    def align(self, expr: str, order: List[str],
              frame: Tuple[str, ...]) -> str:
        """Permute + None-expand an expression with dims `order` so it
        broadcasts in the frame."""
        if not order:
            return expr
        want = [v for v in frame if v in order]
        if want != order:
            perm = tuple(order.index(v) for v in want)
            if len(order) == 2 and perm == (1, 0):
                expr = f"{expr}.T"
            else:
                expr = f"{self.xp}.transpose({expr}, {perm})"
            order = want
        if list(frame) == order:
            return expr
        parts = []
        oi = 0
        for fv in frame:
            if oi < len(order) and order[oi] == fv:
                parts.append(":")
                oi += 1
            else:
                parts.append("None")
        # trailing-dim broadcasting handles leading missing dims already,
        # but explicit None keeps semantics obvious and general
        return f"{expr}[{', '.join(parts)}]"

    def emit_access_aligned(self, acc: VAccess, frame: Tuple[str, ...],
                            hull: Hull) -> str:
        sl, order = self.access_slices_and_dims(acc, frame, hull)
        return self.align(sl, order, frame)

    # -- einsum / dot ------------------------------------------------------
    def emit_einsum(self, spec: EinsumSpec, frame: Tuple[str, ...],
                    hull: Hull) -> str:
        red_lo = {d.var: d.lower for d in spec.reduce_dims}
        red_hi = {d.var: d.upper for d in spec.reduce_dims}
        op_strs: List[str] = []
        for op in spec.operands:
            sl, _ = self.access_slices_and_dims(op.access, frame, hull,
                                                red_lo, red_hi)
            op_strs.append(sl)
        for m in spec.masks:
            op_strs.append(self.mask_expr(m, frame, hull, red_lo, red_hi,
                                          for_einsum=True))
        result = self.dot_peephole(spec, op_strs)
        if result is None:
            opt = ", optimize=True" if self.backend == "np" else ""
            result = (f"{self.xp}.einsum('{spec.spec}', "
                      + ", ".join(op_strs) + opt + ")")
            self.meta.raised_ops.append(f"einsum:{spec.spec}")
        return self.align(result, list(spec.out_vars), frame)

    def dot_peephole(self, spec: EinsumSpec,
                     op_strs: List[str]) -> Optional[str]:
        """2-operand single-contraction einsum → np.dot (paper Fig. 6c)."""
        if not spec.is_dot2():
            return None
        (a, b), (sa, sb) = spec.operands, op_strs
        k = None
        shared = set(a.letters) & set(b.letters)
        if len(shared) != 1:
            return None
        k = shared.pop()
        if spec.out_letters and k in spec.out_letters:
            return None

        def arrange(letters: str, s: str, want_k_last: bool) -> Optional[str]:
            if len(letters) == 1:
                return s if letters == k else None
            if want_k_last:
                return s if letters[1] == k else f"{s}.T"
            return s if letters[0] == k else f"{s}.T"

        ea = arrange(a.letters, sa, want_k_last=True)
        eb = arrange(b.letters, sb, want_k_last=False)
        if ea is None or eb is None:
            return None
        # validate output letter order (i from A, j from B)
        a_out = a.letters.replace(k, "")
        b_out = b.letters.replace(k, "")
        if spec.out_letters != a_out + b_out:
            if spec.out_letters == b_out + a_out:
                ea, eb = (eb if len(b.letters) > 1 else eb,
                          ea)
                ea, eb = arrange(b.letters, sb, True), arrange(
                    a.letters, sa, False)
                if ea is None or eb is None:
                    return None
            else:
                return None
        self.meta.raised_ops.append("dot")
        return f"{self.xp}.dot({ea}, {eb})"

    # -- masks --------------------------------------------------------------
    def mask_expr(self, m: MaskOperand, frame, hull: Hull,
                  red_lo: Dict[str, Affine], red_hi: Dict[str, Affine],
                  for_einsum: bool) -> str:
        dlo = red_lo.get(m.row_var) or hull.lo[m.row_var]
        dhi = red_hi.get(m.row_var) or hull.hi[m.row_var]
        olo = red_lo.get(m.col_var) or hull.lo[m.col_var]
        ohi = red_hi.get(m.col_var) or hull.hi[m.col_var]
        n = affine_py(dhi - dlo)
        mm = affine_py(ohi - olo)
        big_k = (olo + m.offset) - dlo  # d >= o + K  (K affine)
        k = affine_py(big_k * -1)  # tri offset = -K
        dt = "" if for_einsum else ", dtype=bool"
        # tri(D, O, -K)[d, o] = (o <= d - K) = (d >= o + K)
        tri = f"{self.xp}.tri({n}, {mm}, {k}{dt})"
        if m.op == ">=":
            return tri
        return f"(1 - {tri})" if for_einsum else f"(~{tri})"

    def write_mask_expr(self, conds, frame: Tuple[str, ...],
                        hull: Hull) -> str:
        if len(frame) != 2:
            raise RaiseError("masked write needs 2-D frame")
        r, c = frame
        rlo, rhi = hull.lo[r], hull.hi[r]
        clo, chi = hull.lo[c], hull.hi[c]
        rn, cn = affine_py(rhi - rlo), affine_py(chi - clo)
        terms = []
        for dep, outer, op, off in conds:
            if dep == c and outer == r:
                big_k = (rlo + off) - clo
                k = affine_py(big_k - 1)
                tri = f"{self.xp}.tri({rn}, {cn}, {k}, dtype=bool)"
                terms.append(f"(~{tri})" if op == ">=" else tri)
            elif dep == r and outer == c:
                big_k = (clo + off) - rlo
                k = affine_py(big_k * -1)
                tri = f"{self.xp}.tri({rn}, {cn}, {k}, dtype=bool)"
                terms.append(tri if op == ">=" else f"(~{tri})")
            else:
                raise RaiseError("mask vars outside frame")
        return " & ".join(terms)

    # -- statement emission ---------------------------------------------
    def emit_raised(self, u: RaisedUnit) -> None:
        stmt = u.stmt
        try:
            self._emit_raised_fast(stmt)
        except (RaiseError, EmitError):
            if self.backend == "torch":
                raise EmitError("loop fallback infeasible on accelerator")
            self._emit_loops(stmt)
        if stmt.write_full or stmt.write_is_temp:
            self.define_syms_for(stmt.write_array)

    def _emit_raised_fast(self, stmt: CanonStmt) -> None:
        dims = self.free_dims(stmt)
        hull = compute_hull(dims)
        if self.batch_iter:
            # a bound depending on the pfor var would make the slice
            # extent differ between the lanes of one vmap
            gv = self.batch_pfor_var
            for d in dims:
                if gv in d.lower.vars() or gv in d.upper.vars():
                    raise EmitError("batch: pfor-var-dependent bound")
        # frame follows the WRITE's dim order (cov[j][i] = f(i,j) must
        # emit the rhs transposed), then any remaining domain iterators
        domain_order = [d.var for d in dims]
        write_order: List[str] = []
        for idx in stmt.write_idx:
            for v in idx.vars():
                if v in domain_order and v not in write_order:
                    write_order.append(v)
        frame = tuple(write_order +
                      [v for v in domain_order if v not in write_order])
        rhs = normalize(stmt.rhs)
        plan = plan_write(stmt, hull)
        expr = self.emit_expr(rhs, frame, hull)

        arr = stmt.write_array
        if plan.kind in ("full", "scalar"):
            # whole-name assignment inside a chunk body binds a body
            # local (privatization). torch code writes its locals in
            # place, so a local defined as a bare slice is a copy, never
            # a view of what it was sliced from (a captured array, a
            # resident device operand); and in an eager twin every local
            # is a device tensor, even one defined by a python scalar
            if stmt.aug is None:
                rhs_src = expr
                if self.backend == "torch" and isinstance(rhs, VAccess):
                    rhs_src = f"{self.xp}.array({rhs_src})"
                elif self.store_np_captured:
                    rhs_src = f"{self.xp}.asarray({rhs_src})"
            else:
                rhs_src = f"{self._read(arr, arr)} {stmt.aug} ({expr})"
                if self.store_np_captured:
                    rhs_src = f"{self.xp}.asarray({rhs_src})"
            self.body_locals.add(arr)
            self._note_assign(arr)
            self.w(f"{arr} = {rhs_src}")
            return

        if self.backend == "torch" and isinstance(rhs, VAccess) \
                and rhs.array == arr:
            # a view of the array it is stored into (cov[i:M, i] =
            # cov[i, i:M]): numpy copies an overlapping store through a
            # buffer, torch refuses it
            expr = f"{self.xp}.array({expr})"

        if plan.kind == "diag":
            if self.batch_iter:
                raise EmitError("batch: diagonal write")
            v = frame[0]
            iv = self.fresh("ix")
            # an eager twin may index a captured numpy array with it:
            # a host index (numpy's arange) serves both that and a
            # device tensor
            ar = "xp" if self.store_np_captured else self.xp
            self.w(f"{iv} = {ar}.arange({affine_py(hull.lo[v])}, "
                   f"{affine_py(hull.hi[v])})")
            comps = []
            for idx in stmt.write_idx:
                ivars = [x for x in idx.vars() if x in frame]
                if ivars:
                    rest = idx.drop(ivars)
                    off = f" + {affine_py(rest)}" if not rest.is_zero() \
                        else ""
                    comps.append(f"{iv}{off}")
                else:
                    comps.append(affine_py(idx))
            tgt = f"{arr}[{', '.join(comps)}]"
            self._store(arr, ", ".join(comps), tgt, expr, stmt.aug)
            return

        # slice / masked
        warr, widx = arr, list(stmt.write_idx)
        if self.batch_iter:
            warr, widx = self._batch_rebase(arr, widx, is_write=True)
            if arr not in self.body_locals and arr not in \
                    self.batch_write_arrays:
                self.batch_write_arrays.append(arr)
        comps = []
        for idx in widx:
            ivars = [x for x in idx.vars() if x in frame]
            if not ivars:
                comps.append(affine_py(idx))
                continue
            v = ivars[0]
            rest = idx.drop([v])
            comps.append(f"{affine_py(hull.lo[v] + rest)}:"
                         f"{affine_py(hull.hi[v] + rest)}")
        sl = ", ".join(comps)
        tgt = f"{warr}[{sl}]" if sl else warr
        if plan.kind == "slice":
            self._store(warr, sl, tgt, expr, stmt.aug)
        else:  # masked
            mask = self.write_mask_expr(plan.conds, frame, hull)
            mv = self.fresh("m")
            self.w(f"{mv} = {mask}")
            cur = self._read(arr, tgt)
            if stmt.aug is None:
                combined = expr
            else:
                combined = f"{cur} {stmt.aug} ({expr})"
            where = f"{self.xp}.where({mv}, {combined}, {cur})"
            self._store(warr, sl, tgt, where, None)

    def _store(self, arr: str, sl: str, tgt: str, expr: str,
               aug: Optional[str]) -> None:
        self._note_assign(arr)
        if self.backend == "np" or (self.store_np_captured
                                    and arr not in self.body_locals):
            # eager torch twin: partial writes to *captured* arrays stay
            # in-place numpy stores (an explicit device→host copy at the
            # boundary) so the worker's sparse-diff gather sees them
            if self.backend != "np":
                expr = f"{self.xp}.host({expr})"
            if aug is None:
                self.w(f"{tgt} = {expr}")
            else:
                self.w(f"{tgt} {aug}= {expr}")
        elif aug not in (None, "+", "*"):
            raise EmitError(f"aug {aug} on accelerator")
        elif not sl:
            # whole-value store on a row variable (batch-iteration
            # mode): a plain rebind
            if aug is None:
                self.w(f"{arr} = {expr}")
            else:
                self.w(f"{arr} = {arr} {aug} ({expr})")
        elif aug is None:
            # torch writes device tensors (locals, rows, the whole-kernel
            # variant's parameter copies) in place
            self.w(f"{tgt} = {expr}")
        else:
            self.w(f"{tgt} {aug}= {expr}")

    # -- loop fallback (np backend only) -----------------------------------
    def _emit_loops(self, stmt: CanonStmt) -> None:
        self.meta.accel_ok = False
        self.meta.raised_ops.append("loop-fallback")
        rhs = normalize(stmt.rhs)
        # A raised statement is atomic: the rhs is fully evaluated before
        # the store. A scalar loop nest loses that when the rhs reads the
        # written array at *other* elements (fusion builds such
        # statements, e.g. A[...] = dot(A[...], C)), so snapshot the
        # array and read the copy instead.
        self_reads = [
            acc for acc in vexpr_accesses(rhs)
            if acc.array == stmt.write_array
            and (len(acc.idx) != len(stmt.write_idx)
                 or any(not ia.equals(iw)
                        for ia, iw in zip(acc.idx, stmt.write_idx)))]
        if self_reads:
            snap = self.fresh("snap")
            self.w(f"{snap} = {self.xp}.array({stmt.write_array})")
            rhs = substitute_array_reads(
                rhs, stmt.write_array,
                lambda acc: VAccess(snap, acc.idx, acc.dtype))
        dims = self.free_dims(stmt)
        for d in dims:
            self.w(f"for {d.var} in range({affine_py(d.lower)}, "
                   f"{affine_py(d.upper)}, {d.step}):")
            self.depth += 1
        expr = self._scalar_expr(rhs)
        comps = [affine_py(i) for i in stmt.write_idx]
        if stmt.write_full or stmt.write_is_temp or not comps:
            tgt = stmt.write_array
        else:
            tgt = f"{stmt.write_array}[{', '.join(comps)}]"
        if stmt.aug is None:
            self.w(f"{tgt} = {expr}")
        else:
            self.w(f"{tgt} {stmt.aug}= {expr}")
        self.depth -= len(dims)

    def _scalar_expr(self, e: VExpr) -> str:
        if isinstance(e, VConst):
            return repr(e.value)
        if isinstance(e, VParam):
            return e.name
        if isinstance(e, VUnary):
            inner = self._scalar_expr(e.operand)
            if e.fn == "-":
                return f"(-{inner})"
            return f"{self.xp}.{e.fn[3:]}({inner})" if e.fn.startswith("np.") \
                else f"{e.fn}({inner})"
        if isinstance(e, VBin):
            l, r = self._scalar_expr(e.left), self._scalar_expr(e.right)
            return self._binop(e, l, r)
        if isinstance(e, VAccess):
            comps = [affine_py(i) for i in e.idx]
            return f"{e.array}[{', '.join(comps)}]" if comps else e.array
        if isinstance(e, VReduce):
            # emit an inline generator-sum (slow but correct)
            gens = "".join(
                f" for {d.var} in range({affine_py(d.lower)}, "
                f"{affine_py(d.upper)}, {d.step})" for d in e.dims)
            return f"sum({self._scalar_expr(e.child)}{gens})"
        raise EmitError(type(e).__name__)

    # -- other units ------------------------------------------------------
    def emit_fft(self, u: FFTUnit) -> None:
        st = u.stmt
        if self.batch_iter and st.src not in self.body_locals:
            if st.src in self.batch_rows:
                raise EmitError("batch: whole-array access after row capture")
            self._batch_param(st.src)
        axis = st.axis if st.axis is not None else -1
        n = f", n={affine_py(st.n)}" if st.n is not None else ""
        fn = f"{self.xp}.fft." + st.fn.split(".")[-1]
        self.body_locals.add(st.out)   # whole-name rebind (privatized)
        self._note_assign(st.out)
        self.w(f"{st.out} = {fn}({st.src}{n}, axis={axis})")
        self.meta.raised_ops.append("fft")
        self.define_syms_for(st.out)

    def emit_opaque(self, u: OpaqueUnit) -> None:
        if self.backend == "torch":
            raise EmitError("black-box statement: accelerator infeasible")
        self.meta.accel_ok = False
        for s in u.item.stmts:
            for line in unparse_tir(s):
                self.w(line)

    def emit_seq_loop(self, u: SeqLoopUnit) -> None:
        if self.batch_iter:
            self._emit_batch_seq_loop(u)
            return
        d = u.dim
        self.w(f"for {d.var} in range({affine_py(d.lower)}, "
               f"{affine_py(d.upper)}, {d.step}):")
        self.depth += 1
        self.bound.add(d.var)
        if not u.body:
            self.w("pass")
        for b in u.body:
            self.emit_unit(b)
        self.bound.discard(d.var)
        self.depth -= 1

    def _emit_batch_seq_loop(self, u: SeqLoopUnit) -> None:
        """Sequential loop inside the batch-iteration function → a plain
        ``for`` over its static range (vmap runs each step's ops on the
        whole batch; STAP runs 800 Richardson steps this way).

        Two passes: probe-emit the body as straight-line code to learn
        which names it assigns, then emit those lines under the loop.
        The loop must carry state (a name defined before it and assigned
        in it), and names first defined inside the loop must not escape
        it — if a later unit reads one, the batched path is not emitted
        (eager twin only). These are the conditions under which the
        reference emits its ``fori_loop``, so both packages batch the
        same units."""
        d = u.dim
        if d.step != 1:
            raise EmitError("batch: non-unit sequential loop step")
        if not u.body:
            return
        defined_before = (set(self.body_locals)
                          | set(self.batch_rows.values())
                          | set(self._assign_log))
        log_at = len(self._assign_log)
        save_lines = list(self.lines)
        save_depth = self.depth
        save_bound = set(self.bound)
        pre_rows = len(self.batch_rows)
        body_at = len(self.lines)
        self._batch_loop_depth += 1
        self.bound.add(d.var)
        try:
            self._emit_batch_units(u.body)
        finally:
            self._batch_loop_depth -= 1
        body_lines = self.lines[body_at:]
        self.lines = save_lines
        self.depth = save_depth
        self.bound = save_bound

        # rows first captured during this loop hoist above it (their
        # preludes are in _batch_hoist), so they count as defined-before
        defined_before.update(list(self.batch_rows.values())[pre_rows:])
        if self._batch_loop_depth == 0 and self._batch_hoist:
            for ln in self._batch_hoist:
                self.w(ln)
            self._batch_hoist = []

        assigned_in = list(dict.fromkeys(self._assign_log[log_at:]))
        carry = [n for n in assigned_in if n in defined_before]
        fresh = [n for n in assigned_in
                 if n not in defined_before and not n.startswith("__")]
        if not carry:
            raise EmitError("batch: sequential loop carries no state")
        if fresh:
            escapes = set(fresh) & self._unit_reads(self._batch_future)
            if escapes:
                raise EmitError(
                    f"batch: loop-local names escape: {sorted(escapes)}")

        self.w(f"for {d.var} in range({affine_py(d.lower)}, "
               f"{affine_py(d.upper)}):")
        self.lines.extend("    " + ln for ln in body_lines)

    def _emit_batch_units(self, units: Sequence[Unit]) -> None:
        """Emit a unit list keeping ``_batch_future`` pointed at every
        unit that still runs after the current one (loop escape
        analysis needs the full continuation, not just siblings)."""
        outer = self._batch_future
        for i, b in enumerate(units):
            self._batch_future = list(units[i + 1:]) + outer
            self.emit_unit(b)
        self._batch_future = outer

    def _unit_reads(self, units: Sequence[Unit]) -> Set[str]:
        """Every name (array, scalar, iterator bound) a unit list might
        read — conservative, for loop-local escape analysis."""
        names: Set[str] = set()

        def expr(e: VExpr) -> None:
            if isinstance(e, VAccess):
                names.add(e.array)
                for idx in e.idx:
                    names.update(idx.vars())
            elif isinstance(e, VBin):
                expr(e.left)
                expr(e.right)
            elif isinstance(e, VUnary):
                expr(e.operand)
            elif isinstance(e, VReduce):
                for d in e.dims:
                    names.update(d.lower.vars())
                    names.update(d.upper.vars())
                expr(e.child)
            elif isinstance(e, VParam):
                names.add(e.name)

        def unit(u: Unit) -> None:
            if isinstance(u, RaisedUnit):
                st = u.stmt
                expr(st.rhs)
                names.add(st.write_array)  # read-modify on partial writes
                for idx in st.write_idx:
                    names.update(idx.vars())
                for d in st.domain.dims:
                    names.update(d.lower.vars())
                    names.update(d.upper.vars())
            elif isinstance(u, FFTUnit):
                names.add(u.stmt.src)
                names.add(u.stmt.out)
                if u.stmt.n is not None:
                    names.update(u.stmt.n.vars())
            elif isinstance(u, SeqLoopUnit):
                names.update(u.dim.lower.vars())
                names.update(u.dim.upper.vars())
                for b in u.body:
                    unit(b)
            else:
                raise EmitError("batch: opaque unit in continuation")

        for u in units:
            unit(u)
        return names

    def _emit_pfor_body(self, u: PforUnit, body_name: str) -> None:
        """One chunk-body function executing iterations [lo, hi)."""
        self.w(f"def {body_name}(__lo, __hi):")
        self.depth += 1
        self._emit_pfor_loop(u)
        self.depth -= 1

    def _emit_pfor_loop(self, u: PforUnit) -> None:
        d = u.dim
        self.w(f"for {d.var} in range(__lo, __hi, {d.step}):")
        self.depth += 1
        self.bound.add(d.var)
        if not u.body:
            self.w("pass")
        for b in u.body:
            self.emit_unit(b)
        self.bound.discard(d.var)
        self.depth -= 1

    def _emit_batch_iter(self, u: PforUnit, iter_name: str) -> None:
        """The per-iteration function for __pfor_batch: computes one pfor
        iteration g and returns the written rows."""
        d = u.dim
        if d.step != 1:
            raise EmitError("batch: non-unit pfor step")
        if not u.body:
            raise EmitError("batch: empty pfor body")
        g = d.var
        entry_depth = self.depth
        self.depth += 1
        self.bound.add(g)
        self._batch_future = []
        self._emit_batch_units(u.body)
        if not self.batch_write_arrays:
            raise EmitError("batch: body writes no pfor rows")
        rows = ", ".join(self.batch_rows[a]
                         for a in self.batch_write_arrays)
        self.w(f"return ({rows},)")
        self.bound.discard(g)
        self.depth = entry_depth
        params = ", ".join(self.batch_params)
        self.lines.insert(0, "    " * entry_depth
                          + f"def {iter_name}({g}, __offs, {params}):")

    def emit_pfor(self, u: PforUnit) -> None:
        if self.backend == "torch":
            raise EmitError("pfor: accelerator variant not generated")
        self.meta.uses_pfor = True
        idx = self.meta.pfor_count
        self.meta.pfor_count += 1
        d = u.dim
        body_name = f"__pfor_body_{idx}"
        # the twins re-emit the same units, so they need the same
        # deferred shape symbols the np body is about to consume
        pending_before = {k: list(v) for k, v in self.pending_syms.items()}
        self._emit_pfor_body(u, body_name)
        # always emitted (even when empty) so the cluster runtime trusts
        # the body itself over any stale per-kernel fallback: these are
        # the arrays whose chunk rows alone satisfy every body access
        sliceable = tuple(getattr(u, "sliceable", ()) or ())
        self.w(f"{body_name}.__sliceable__ = {sliceable!r}")
        self.w(f"{body_name}.__backend__ = 'np'")
        # unit label: lets obs spans / trace rows name which pfor unit
        # of the kernel a chunk belongs to
        self.w(f"{body_name}.__unit__ = {idx}")
        if self.pfor_twins and getattr(u, "accel_feasible", True):
            # one twin per registered accelerator-feasible backend of
            # the port's own registry, in registration order
            for bk in backends_mod.twin_backends():
                twin_name = bk.emit_twin(self, u, body_name, idx,
                                         pending_before)
                if twin_name is None:
                    continue
                self.w(f"{twin_name}.__sliceable__ = {sliceable!r}")
                self.w(f"{twin_name}.__backend__ = '{bk.name}'")
                self.w(f"{twin_name}.__unit__ = {idx}")
                self.w(f"{body_name}.{bk.attr} = {twin_name}")
                self.meta.pfor_twin_units.setdefault(
                    bk.name, []).append(idx)
        tile = u.tile if u.tile is not None else "None"
        self.w(f"__pfor_run({body_name}, {affine_py(d.lower)}, "
               f"{affine_py(d.upper)}, {tile})")
        self.meta.raised_ops.append("pfor")

    def _try_emit_torch_twin(self, u: PforUnit, body_name: str, idx: int,
                             pending_syms: Dict[str, List[str]]
                             ) -> Optional[str]:
        """Emit the torch twin of one pfor body, or None when the unit's
        body is accelerator-infeasible (loop fallback / black box). The
        twin is a separate function scope, so its temp names and body
        locals are independent of the np body's.

        When the body additionally fits the stricter batch-iteration
        shape (pure row-parallel over the pfor var), the twin leads with
        a batched fast path: a nested per-iteration function handed to
        __pfor_batch, which runs it under ``torch.func.vmap`` over the
        chunk's (pow2-bucketed) iterations and scatters the returned
        rows in place. The eager per-iteration loop stays behind it, on
        the same device, for a chunk the batched path cannot run."""
        name = f"{body_name}__torch"
        sub = Emitter(self.s, "torch")
        sub.xp = "__txp"
        sub.store_np_captured = True
        sub.depth = self.depth + 1
        sub.bound = set(self.bound)
        sub.pending_syms = {k: list(v) for k, v in pending_syms.items()}
        try:
            sub._emit_pfor_loop(u)
        except (EmitError, RaiseError):
            return None

        bat = Emitter(self.s, "torch")
        bat.xp = "__txp"
        bat.batch_iter = True
        bat.batch_pfor_var = u.dim.var
        bat.depth = self.depth + 1
        bat.bound = set(self.bound)
        bat.pending_syms = {k: list(v) for k, v in pending_syms.items()}
        iter_name = f"__pfor_iter_{idx}"
        try:
            bat._emit_batch_iter(u, iter_name)
            batch_lines: Optional[List[str]] = bat.lines
        except (EmitError, RaiseError):
            batch_lines = None

        self.w(f"def {name}(__lo, __hi):")
        self.depth += 1
        if batch_lines:
            self.lines.extend(batch_lines)
            params = ", ".join(bat.batch_params)
            trail = "," if len(bat.batch_params) == 1 else ""
            wpos = tuple(bat.batch_params[a]
                         for a in bat.batch_write_arrays)
            self.w(f"if __pfor_batch({iter_name}, __lo, __hi, "
                   f"({params}{trail}), {wpos!r}):")
            self.w("    return")
            self.meta.pfor_batch_units.append(idx)
        self.lines.extend(sub.lines)
        self.depth -= 1
        return name

    def emit_unit(self, u: Unit) -> None:
        if isinstance(u, RaisedUnit):
            self.emit_raised(u)
        elif isinstance(u, FFTUnit):
            self.emit_fft(u)
        elif isinstance(u, OpaqueUnit):
            self.emit_opaque(u)
        elif isinstance(u, SeqLoopUnit):
            self.emit_seq_loop(u)
        elif isinstance(u, PforUnit):
            self.emit_pfor(u)
        else:  # pragma: no cover
            raise TypeError(type(u))


# ---------------------------------------------------------------------------
# TIR unparse (black-box re-emission)
# ---------------------------------------------------------------------------

def unparse_expr(e: tir.Expr) -> str:
    if isinstance(e, tir.Const):
        return repr(e.value)
    if isinstance(e, tir.Name):
        return e.id
    if isinstance(e, tir.BinOp):
        return f"({unparse_expr(e.left)} {e.op} {unparse_expr(e.right)})"
    if isinstance(e, tir.UnaryOp):
        return f"(-{unparse_expr(e.operand)})"
    if isinstance(e, tir.Compare):
        return f"({unparse_expr(e.left)} {e.op} {unparse_expr(e.right)})"
    if isinstance(e, tir.Subscript):
        comps = []
        for i in e.indices:
            if isinstance(i, tir.IndexExpr):
                comps.append(unparse_expr(i.value))
            else:
                lo = unparse_expr(i.lo) if i.lo else ""
                hi = unparse_expr(i.hi) if i.hi else ""
                comps.append(f"{lo}:{hi}")
        return f"{unparse_expr(e.base)}[{', '.join(comps)}]"
    if isinstance(e, tir.Call):
        if e.fn == "method.T":
            return f"{unparse_expr(e.args[0])}.T"
        if e.fn == "method.shape":
            return f"{unparse_expr(e.args[0])}.shape"
        args = [unparse_expr(a) for a in e.args]
        if e.fn.startswith("method."):
            recv = args[0]
            rest = args[1:]
            call = f"{recv}.{e.fn[7:]}"
            args = rest
        elif e.fn.startswith("np."):
            call = "xp." + e.fn[3:]
        else:
            call = e.fn
        kw = [f"{k}={unparse_expr(v)}" for k, v in e.kwargs.items()]
        return f"{call}({', '.join(args + kw)})"
    raise EmitError(f"unparse {type(e).__name__}")


def unparse_tir(s: tir.Stmt, depth: int = 0) -> List[str]:
    pad = "    " * depth
    if isinstance(s, tir.Opaque):
        return [pad + ln for ln in s.src.splitlines()]
    if isinstance(s, tir.Assign):
        op = f"{s.aug}=" if s.aug else "="
        return [pad + f"{unparse_expr(s.target)} {op} "
                      f"{unparse_expr(s.value)}"]
    if isinstance(s, tir.For):
        step = unparse_expr(s.step) if s.step is not None else "1"
        out = [pad + f"for {s.var} in range({unparse_expr(s.lo)}, "
                     f"{unparse_expr(s.hi)}, {step}):"]
        for b in s.body:
            out.extend(unparse_tir(b, depth + 1))
        return out
    if isinstance(s, tir.If):
        out = [pad + f"if {unparse_expr(s.cond)}:"]
        for b in s.body:
            out.extend(unparse_tir(b, depth + 1))
        if s.orelse:
            out.append(pad + "else:")
            for b in s.orelse:
                out.extend(unparse_tir(b, depth + 1))
        return out
    if isinstance(s, tir.Return):
        return [pad + ("return" if s.value is None
                       else f"return {unparse_expr(s.value)}")]
    if isinstance(s, tir.ExprStmt):
        return [pad + unparse_expr(s.value)]
    raise EmitError(f"unparse stmt {type(s).__name__}")


# ---------------------------------------------------------------------------
# Whole-function assembly
# ---------------------------------------------------------------------------

@dataclass
class GeneratedVariant:
    source: str
    fn_name: str
    backend: str
    meta: EmitMeta
    returns_written: bool  # torch variant returns its written arrays
    written: List[str]


def generate(sched: Schedule, backend: str,
             pfor_twins: bool = False) -> GeneratedVariant:
    """``pfor_twins=True`` (np backend only) additionally emits, for
    every accelerator-feasible pfor body, the twin of each registered
    backend that takes it — the per-unit backend variants the
    heterogeneous cluster routes between.

    ``backend="torch"`` generates the whole-kernel torch variant (run
    with ``xp`` bound to :mod:`repro_torch.core.txp`). Its preamble
    copies every array parameter to the device; it then writes those
    device tensors in place rather than returning rebuilt arrays, and
    returns the written parameters for the dispatcher to copy home."""
    fn = sched.program.fn
    param_names = [n for n, _ in fn.params]
    em = Emitter(sched, backend)
    em.pfor_twins = bool(pfor_twins) and backend == "np"
    if sched.fusion is not None:
        em.meta.fused_units = sched.fusion.fused_units
        em.meta.contracted_arrays = list(sched.fusion.contracted_arrays)

    # Preamble: list→array conversion and shape symbols. Symbols for
    # arrays defined in the body are deferred until their definition.
    list_params = [n for n, t in fn.params if t.kind == "list"]
    array_params = [n for n, t in fn.params if t.is_array_like]
    for n in (array_params if backend == "torch" else list_params):
        em.w(f"{n} = xp.asarray({n})")
    shape_syms = sorted({
        v
        for v in _all_affine_vars(sched)
        if "__d" in v
    })
    param_set = set(param_names)
    for sym in shape_syms:
        arr, d = sym.rsplit("__d", 1)
        if arr in param_set:
            em.w(f"{sym} = {arr}.shape[{d}]")
        else:
            em.pending_syms.setdefault(arr, []).append(sym)

    for u in sched.units:
        em.emit_unit(u)

    written_params = [wn for wn in sched.written if wn in param_names]
    if backend == "torch":
        returned = written_params
    else:
        # np backend mutates ndarrays in place, but list-typed params were
        # converted to local arrays — return those for dispatcher copy-back
        returned = [wn for wn in written_params if wn in list_params]
    if returned:
        em.w("return (" + ", ".join(returned)
             + ("," if len(returned) == 1 else "") + ")")
    else:
        em.w("return None")

    name = f"{fn.name}__{backend}_opt"
    head = f"def {name}({', '.join(param_names)}):"
    src = head + "\n" + "\n".join(em.lines) + "\n"
    return GeneratedVariant(src, name, backend, em.meta,
                            bool(returned), returned)


def _all_affine_vars(sched: Schedule):
    out: Set[str] = set()

    def from_stmt(s: CanonStmt):
        for d in list(s.domain.dims) + list(s.reduce_dims()):
            out.update(d.lower.vars())
            out.update(d.upper.vars())
        for idx in s.write_idx:
            out.update(idx.vars())
        for acc_idx in _stmt_access_vars(s.rhs):
            out.update(acc_idx)

    def rec(units):
        for u in units:
            if isinstance(u, RaisedUnit):
                from_stmt(u.stmt)
            elif isinstance(u, FFTUnit):
                if u.stmt.n is not None:
                    out.update(u.stmt.n.vars())
            elif isinstance(u, (SeqLoopUnit, PforUnit)):
                out.update(u.dim.lower.vars())
                out.update(u.dim.upper.vars())
                rec(u.body)

    rec(sched.units)
    return out


def _stmt_access_vars(e: VExpr):
    if isinstance(e, VAccess):
        yield [v for idx in e.idx for v in idx.vars()]
    elif isinstance(e, VBin):
        yield from _stmt_access_vars(e.left)
        yield from _stmt_access_vars(e.right)
    elif isinstance(e, VUnary):
        yield from _stmt_access_vars(e.operand)
    elif isinstance(e, VReduce):
        for d in e.dims:
            yield list(d.lower.vars()) + list(d.upper.vars())
        yield from _stmt_access_vars(e.child)
