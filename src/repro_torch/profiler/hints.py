"""Hint synthesis: observed runtime signatures → front-end hint strings.

Folds a :class:`~repro_torch.profiler.tracer.FunctionTrace` into the
``'ndarray[f64,2]'`` hint strings that ``core/parser.py`` +
``core/types.py`` already consume, widening observed shapes into guarded
buckets. One trace yields a *legality-ordered* hint set:

  tier 0 ``exact``   — dtype+rank hints, guarded on the exact shapes of
                       the dominant signature (tightest specialization);
  tier 1 ``bucket``  — same hints, shapes widened to enclosing
                       power-of-two buckets (stable under mild shape
                       drift, e.g. batch 60 ↔ 64);
  tier 2 ``rank``    — dtype+rank only, no shape guard (exactly what a
                       hand-written paper hint expresses).

All three tiers share the same hint strings — the paper's legality check
is dtype+rank — so a single compile serves every tier. The shape guards
are the tier-membership predicates exposed to tooling (``HintTier.admits``
answers "would the dominant-signature specialization still apply to this
shape?"); runtime pinning itself keys on exact dispatch signatures in
``core/multiversion.py``, and bucket-guard dispatch is a ROADMAP open
item.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# pow2_bucket is re-exported: callers grew up importing it from here, but
# the implementation lives in core (the dispatcher's bucket guards must
# not depend on the profiler package)
from repro_torch.core.cost import pow2_bucket  # noqa: F401  (re-export)
from repro_torch.core.types import promote_dtype

from .tracer import ArgObservation, FunctionTrace

# Reverse of core.types._DTYPE_ALIASES — emit paper-style short names.
_SHORT_DTYPE = {
    "float64": "f64",
    "float32": "f32",
    "bfloat16": "bf16",
    "int64": "i64",
    "int32": "i32",
    "bool": "bool",
    "complex64": "c64",
    "complex128": "c128",
}


def _short(dtype: Optional[str]) -> str:
    if dtype is None:
        return "f64"
    return _SHORT_DTYPE.get(dtype, dtype)




@dataclass(frozen=True)
class ShapeGuard:
    """Per-dimension admission ranges for one array parameter.

    ``dims[i] = (lo, hi)`` admits sizes with ``lo < s <= hi`` (the
    exact tier uses ``(s-1, s)``)."""

    dims: Tuple[Tuple[int, int], ...]

    def admits(self, shape: Sequence[int]) -> bool:
        if len(shape) != len(self.dims):
            return False
        return all(lo < s <= hi for s, (lo, hi) in zip(shape, self.dims))

    @staticmethod
    def exact(shape: Sequence[int]) -> "ShapeGuard":
        return ShapeGuard(tuple((s - 1, s) for s in shape))

    @staticmethod
    def bucketed(shape: Sequence[int]) -> "ShapeGuard":
        return ShapeGuard(tuple(pow2_bucket(s) for s in shape))


@dataclass
class HintTier:
    """One legality tier: hint strings plus optional shape guards."""

    name: str                           # 'exact' | 'bucket' | 'rank'
    hints: Dict[str, str]               # param name → hint string
    guards: Dict[str, ShapeGuard] = field(default_factory=dict)

    def admits(self, shapes: Dict[str, Sequence[int]]) -> bool:
        """Do the given runtime shapes fall inside this tier's guards?

        Params without a guard are unconstrained (legality still checks
        dtype/rank downstream)."""
        for name, guard in self.guards.items():
            if name not in shapes or not guard.admits(shapes[name]):
                return False
        return True


def _fold_param(obs: List[ArgObservation]) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """Fold all observations of one parameter into (hint, dominant shape).

    Mixed ranks widen to rank-less ``ndarray``; mixed dtypes promote."""
    if not obs:
        return "", None
    kinds = {o.kind for o in obs}
    if kinds == {"scalar"}:
        dtype = None
        for o in obs:
            dtype = promote_dtype(dtype, o.dtype)
        if dtype in ("int64", "int32"):
            return "int", None
        if dtype == "bool":
            return "bool", None
        if dtype in ("complex64", "complex128"):
            return "complex", None
        return "float", None
    if kinds <= {"array", "list"}:
        dtype = None
        for o in obs:
            dtype = promote_dtype(dtype, o.dtype)
        ranks = {o.rank for o in obs}
        base = "list" if kinds == {"list"} else "ndarray"
        if len(ranks) != 1:
            return ("ndarray", None)  # rank varies: legality guard decides
        rank = ranks.pop()
        shape = obs[0].shape if len({o.shape for o in obs}) == 1 else None
        return (f"{base}[{_short(dtype)},{rank}]", shape)
    return "", None  # unknown / mixed kind: leave unhinted


def synthesize_hints(trace: FunctionTrace) -> Dict[str, str]:
    """The widest-legal hints (tier ``rank``) — what a programmer would
    have written by hand after watching the same calls."""
    by_param = trace.observations_by_param()
    out: Dict[str, str] = {}
    for name in trace.param_names:
        hint, _ = _fold_param(by_param.get(name, []))
        if hint:
            out[name] = hint
    return out


def synthesize_hint_tiers(trace: FunctionTrace) -> List[HintTier]:
    """Legality-ordered tiers (most-specific first) from one trace."""
    hints = synthesize_hints(trace)
    dom = trace.dominant
    tiers: List[HintTier] = []
    if dom is not None:
        arr_shapes = {o.name: o.shape for o in dom.args
                      if o.kind in ("array", "list") and o.shape
                      and o.name in hints and "[" in hints[o.name]}
        if arr_shapes:
            tiers.append(HintTier(
                "exact", dict(hints),
                {n: ShapeGuard.exact(s) for n, s in arr_shapes.items()}))
            tiers.append(HintTier(
                "bucket", dict(hints),
                {n: ShapeGuard.bucketed(s) for n, s in arr_shapes.items()}))
    tiers.append(HintTier("rank", dict(hints)))
    return tiers


def type_signature(hints: Dict[str, object],
                   param_names: Sequence[str]) -> str:
    """Canonical signature string for cache keying.

    This is THE encoding the variant cache keys on (the compiler calls it
    too). Hints are canonicalized through the front-end's own annotation
    parser, so alias spellings (``'ndarray[f64,2]'`` vs
    ``'ndarray[float64,2]'``) produce identical keys. Order follows the
    function's own parameter order."""
    from repro_torch.core.types import parse_annotation

    parts = []
    for n in param_names:
        ti = parse_annotation(hints.get(n))
        parts.append(f"{n}:{ti.kind}[{ti.dtype},{ti.rank}]")
    return ";".join(parts)
