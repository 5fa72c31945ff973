"""Library knowledge base (paper §4.2, Table 2).

Each entry describes one library function the compiler understands:
  * a TYPE RULE  — result dtype/rank from argument types (used by inference,
    §2.1: "library knowledge base, which specifies type rules");
  * a DATAFLOW SEMANTIC — how the op maps output index space to input index
    space, expressed as a small tag language interpreted by core/scop.py
    when expanding implicit loops into the SCoP;
  * a COST RULE — FLOPs and bytes touched as a function of shapes (drives
    the profitability decision trees and the LM planner's roofline terms).

The same registry carries the large-model ops (dot_general, attention, MoE
dispatch, scans) so the sharding planner shares one source of truth with the
kernel compiler — Table 2 scaled up.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .types import TypeInfo, broadcast, promote_dtype


@dataclass
class OpEntry:
    name: str
    # ('elementwise',) / ('transpose',) / ('reduce', 'sum') /
    # ('contract', 'dot') / ('fft',) / ('alloc',) / ('opaque',) ...
    semantic: Tuple[str, ...]
    type_rule: Callable[..., TypeInfo]
    # flops per output element (given contraction length k where relevant)
    flops: Callable[..., float] = lambda **kw: 0.0
    notes: str = ""


REGISTRY: Dict[str, OpEntry] = {}


def register(entry: OpEntry) -> None:
    REGISTRY[entry.name] = entry


def lookup(name: str) -> Optional[OpEntry]:
    return REGISTRY.get(name)


# ---------------------------------------------------------------------------
# Type-rule helpers
# ---------------------------------------------------------------------------

def _arr(dtype, rank):
    if rank == 0:
        return TypeInfo.scalar(dtype or "float64")
    return TypeInfo.array(dtype or "float64", rank)


def _t_elementwise(*args: TypeInfo, **kw) -> TypeInfo:
    out = args[0].as_array()
    for a in args[1:]:
        out = broadcast(out, a)
    return out


def _t_same(*args: TypeInfo, **kw) -> TypeInfo:
    return args[0].as_array()


def _t_float_unary(*args: TypeInfo, **kw) -> TypeInfo:
    a = args[0].as_array()
    dt = a.dtype
    if dt in (None, "int64", "int32", "bool"):
        dt = "float64"
    return _arr(dt, a.rank)


def _t_transpose(*args: TypeInfo, **kw) -> TypeInfo:
    return args[0].as_array()


def _t_dot(a: TypeInfo, b: TypeInfo, **kw) -> TypeInfo:
    a, b = a.as_array(), b.as_array()
    dt = promote_dtype(a.dtype, b.dtype)
    if a.rank == 1 and b.rank == 1:
        return _arr(dt, 0)
    if a.rank == 2 and b.rank == 1:
        return _arr(dt, 1)
    if a.rank == 1 and b.rank == 2:
        return _arr(dt, 1)
    return _arr(dt, max(a.rank, b.rank))


def _t_reduce(a: TypeInfo, *rest, axis=None, **kw) -> TypeInfo:
    a = a.as_array()
    dt = a.dtype
    if a.rank == 0:
        return _arr(dt, 0)
    if axis is None:
        return _arr(dt, 0)
    return _arr(dt, max(0, a.rank - 1))


def _t_mean(a: TypeInfo, *rest, axis=None, **kw) -> TypeInfo:
    out = _t_reduce(a, axis=axis)
    dt = out.dtype
    if dt in (None, "int64", "int32", "bool"):
        dt = "float64"
    return _arr(dt, out.rank)


def _t_alloc(*args, dtype=None, rank=1, **kw) -> TypeInfo:
    return _arr(dtype or "float64", rank)


def _t_fft(a: TypeInfo, *rest, **kw) -> TypeInfo:
    a = a.as_array()
    dt = "complex128" if a.dtype in (None, "float64", "complex128") else "complex64"
    return _arr(dt, a.rank)


def _t_scalar_float(*args, **kw) -> TypeInfo:
    return TypeInfo.scalar("float64")


# ---------------------------------------------------------------------------
# Elementwise ops (implicit loops over the broadcast output domain)
# ---------------------------------------------------------------------------

for _name in [
    "np.sqrt", "np.abs", "np.exp", "np.log", "np.sin", "np.cos",
    "np.conj", "np.real", "np.imag", "np.square", "np.reciprocal",
]:
    register(OpEntry(_name, ("elementwise", "unary"), _t_float_unary,
                     flops=lambda **kw: 1.0))

register(OpEntry("np.maximum", ("elementwise",), _t_elementwise,
                 flops=lambda **kw: 1.0))
register(OpEntry("np.minimum", ("elementwise",), _t_elementwise,
                 flops=lambda **kw: 1.0))
register(OpEntry("np.power", ("elementwise",), _t_elementwise,
                 flops=lambda **kw: 10.0))

# ---------------------------------------------------------------------------
# Structural ops
# ---------------------------------------------------------------------------

register(OpEntry("method.T", ("transpose",), _t_transpose,
                 notes="R[i0,i1] := A[i1,i0]"))
register(OpEntry("np.transpose", ("transpose",), _t_transpose))
register(OpEntry("np.squeeze", ("squeeze",),
                 lambda a, **kw: _arr(a.as_array().dtype,
                                      max(0, a.as_array().rank - 1))))
register(OpEntry("np.reshape", ("opaque",), _t_same))
register(OpEntry("np.triu", ("mask", "triu"), _t_same))
register(OpEntry("np.tril", ("mask", "tril"), _t_same))

# ---------------------------------------------------------------------------
# Reductions (Table 2: sum_1D, sum_2D_axis1, mean, …)
# ---------------------------------------------------------------------------

register(OpEntry("method.sum", ("reduce", "sum"), _t_reduce,
                 flops=lambda k=1.0, **kw: float(k),
                 notes="R[i0] := sum_k A[i0,k]  (axis form per Table 2)"))
register(OpEntry("np.sum", ("reduce", "sum"), _t_reduce,
                 flops=lambda k=1.0, **kw: float(k)))
register(OpEntry("method.mean", ("reduce", "mean"), _t_mean,
                 flops=lambda k=1.0, **kw: float(k) + 1))
register(OpEntry("np.mean", ("reduce", "mean"), _t_mean,
                 flops=lambda k=1.0, **kw: float(k) + 1))
register(OpEntry("np.max", ("reduce", "max"), _t_reduce,
                 flops=lambda k=1.0, **kw: float(k)))
register(OpEntry("method.max", ("reduce", "max"), _t_reduce,
                 flops=lambda k=1.0, **kw: float(k)))

# ---------------------------------------------------------------------------
# Contractions (Table 2: dot_{2D,2D} := sum(mult(A1[i0,:], A2[:,i1])))
# ---------------------------------------------------------------------------

register(OpEntry("np.dot", ("contract", "dot"), _t_dot,
                 flops=lambda k=1.0, **kw: 2.0 * float(k),
                 notes="R[i0,i1] := sum_1D(mult_1D,1D(A1[i0,:], A2[:,i1]))"))
register(OpEntry("np.matmul", ("contract", "dot"), _t_dot,
                 flops=lambda k=1.0, **kw: 2.0 * float(k)))
register(OpEntry("np.outer", ("contract", "outer"),
                 lambda a, b, **kw: _arr(promote_dtype(a.as_array().dtype,
                                                       b.as_array().dtype), 2),
                 flops=lambda **kw: 1.0))
register(OpEntry("np.einsum", ("opaque",), lambda *a, **kw: TypeInfo.unknown()))

# ---------------------------------------------------------------------------
# Spectral (STAP): fft along an axis — 1-D domains per Table 2 last row
# ---------------------------------------------------------------------------

register(OpEntry("np.fft.fft", ("fft",), _t_fft,
                 flops=lambda k=1.0, **kw: 5.0 * float(k) * math.log2(max(2.0, float(k))),
                 notes="R[i0,:] := fft_1D(A1[i0,:]) for axis=1"))
register(OpEntry("np.fft.ifft", ("fft",), _t_fft,
                 flops=lambda k=1.0, **kw: 5.0 * float(k) * math.log2(max(2.0, float(k)))))

# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------

register(OpEntry("np.zeros", ("alloc", "zeros"), _t_alloc))
register(OpEntry("np.empty", ("alloc", "empty"), _t_alloc))
register(OpEntry("np.ones", ("alloc", "ones"), _t_alloc))
register(OpEntry("np.diag_indices", ("opaque",), lambda *a, **kw: TypeInfo.unknown()))
register(OpEntry("np.tril_indices", ("opaque",), lambda *a, **kw: TypeInfo.unknown()))
register(OpEntry("np.triu_indices", ("opaque",), lambda *a, **kw: TypeInfo.unknown()))

# ---------------------------------------------------------------------------
# Scalar / misc
# ---------------------------------------------------------------------------

register(OpEntry("len", ("meta",), lambda *a, **kw: TypeInfo.scalar("int64")))
register(OpEntry("range", ("meta",), lambda *a, **kw: TypeInfo.unknown()))
register(OpEntry("float", ("meta",), _t_scalar_float))
register(OpEntry("int", ("meta",), lambda *a, **kw: TypeInfo.scalar("int64")))
register(OpEntry("abs", ("elementwise", "unary"), _t_same,
                 flops=lambda **kw: 1.0))
register(OpEntry("min", ("meta",), lambda *a, **kw: a[0] if a else TypeInfo.unknown()))
register(OpEntry("max", ("meta",), lambda *a, **kw: a[0] if a else TypeInfo.unknown()))


# ===========================================================================
# Large-model op entries — Table 2 scaled to the LM pool. Used only by the
# planner/cost model (core/cost.py, core/planner.py); the kernel front-end
# never sees these names.
# ===========================================================================

@dataclass
class LMOp:
    name: str
    flops: Callable[..., float]
    bytes_: Callable[..., float]
    # which logical axes may be sharded without changing semantics
    shardable: Tuple[str, ...] = ()
    # collective implied when the named axis is sharded: axis -> kind
    collectives: Dict[str, str] = field(default_factory=dict)


LM_REGISTRY: Dict[str, LMOp] = {}


def register_lm(op: LMOp) -> None:
    LM_REGISTRY[op.name] = op


def _bytes_linear(m, k, n, dtype_bytes=2, **kw):
    return dtype_bytes * (m * k + k * n + m * n)


register_lm(LMOp(
    "matmul",
    flops=lambda m, k, n, **kw: 2.0 * m * k * n,
    bytes_=_bytes_linear,
    shardable=("m", "k", "n"),
    collectives={"k": "psum"},
))

register_lm(LMOp(
    "attention",
    # 2*b*h*s*s*d (QK^T) + 2*b*h*s*s*d (PV)
    flops=lambda b, h, s_q, s_kv, d, **kw: 4.0 * b * h * s_q * s_kv * d,
    bytes_=lambda b, h, s_q, s_kv, d, kv_h=None, dtype_bytes=2, **kw:
        dtype_bytes * (b * h * s_q * d + 2 * b * (kv_h or h) * s_kv * d
                       + b * h * s_q * d),
    shardable=("b", "h"),
    collectives={},
))

register_lm(LMOp(
    "moe_dispatch",
    # all-to-all of token activations to experts and back
    flops=lambda tokens, d, topk, **kw: 0.0,
    bytes_=lambda tokens, d, topk, dtype_bytes=2, **kw:
        2.0 * dtype_bytes * tokens * topk * d,
    shardable=("experts", "tokens"),
    collectives={"experts": "all_to_all"},
))

register_lm(LMOp(
    "ssm_scan",
    # Selective scan: ~9 flops per (b, s, heads*state) element
    flops=lambda b, s, dim, state, **kw: 9.0 * b * s * dim * state,
    bytes_=lambda b, s, dim, state, dtype_bytes=2, **kw:
        dtype_bytes * b * s * dim * (2 + state),
    shardable=("b", "dim"),
    collectives={},
))

register_lm(LMOp(
    "vocab_xent",
    flops=lambda tokens, d, vocab, **kw: 2.0 * tokens * d * vocab,
    bytes_=lambda tokens, d, vocab, dtype_bytes=2, **kw:
        dtype_bytes * (tokens * d + d * vocab + tokens * vocab),
    shardable=("vocab", "tokens"),
    collectives={"vocab": "psum"},
))
