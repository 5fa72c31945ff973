"""Type system for the AutoMPHC front-end.

The paper's compiler is driven by type *hints* on kernel parameters; from
those it statically infers the types of locals and expressions using type
rules from the library knowledge base (§2.1). Hints are not trusted — the
multi-versioner (core/multiversion.py) guards specialized code with runtime
legality checks derived from these same TypeInfo objects.
"""

from __future__ import annotations

import re
import sys
from dataclasses import dataclass
from typing import Optional

import numpy as np


class TypeError_(Exception):
    """Type-inference failure (kernel leaves the supported subset)."""


_DTYPE_ALIASES = {
    "float": "float64",
    "f64": "float64",
    "double": "float64",
    "f32": "float32",
    "single": "float32",
    "bf16": "bfloat16",
    "int": "int64",
    "i64": "int64",
    "i32": "int32",
    "bool": "bool",
    "c64": "complex64",
    "c128": "complex128",
    "complex": "complex128",
}


def canon_dtype(name: str) -> str:
    name = _DTYPE_ALIASES.get(name, name)
    if name not in {
        "float64", "float32", "bfloat16", "float16",
        "int64", "int32", "int16", "int8", "uint8",
        "bool", "complex64", "complex128",
    }:
        raise TypeError_(f"unsupported dtype {name!r}")
    return name


@dataclass(frozen=True)
class TypeInfo:
    """kind: 'scalar' | 'array' | 'list' | 'none' | 'unknown'.

    ``rank`` is the array rank (0 for scalar). Lists-of-lists — the paper's
    PolyBench "List version" — carry the *element* dtype plus nesting depth
    so the compiler can treat them as arrays (with a list→ndarray conversion
    inserted at the kernel boundary, exactly as §4.2 describes).
    """

    kind: str
    dtype: Optional[str] = None
    rank: int = 0

    # -- constructors --------------------------------------------------
    @staticmethod
    def scalar(dtype: str) -> "TypeInfo":
        return TypeInfo("scalar", canon_dtype(dtype), 0)

    @staticmethod
    def array(dtype: str, rank: int) -> "TypeInfo":
        return TypeInfo("array", canon_dtype(dtype), rank)

    @staticmethod
    def list_of(dtype: str, depth: int) -> "TypeInfo":
        return TypeInfo("list", canon_dtype(dtype), depth)

    @staticmethod
    def none() -> "TypeInfo":
        return TypeInfo("none")

    @staticmethod
    def unknown() -> "TypeInfo":
        return TypeInfo("unknown")

    # -- queries --------------------------------------------------------
    @property
    def is_array_like(self) -> bool:
        return self.kind in ("array", "list")

    @property
    def is_numeric_scalar(self) -> bool:
        return self.kind == "scalar"

    def as_array(self) -> "TypeInfo":
        """List-of-list viewed as an array of the same rank."""
        if self.kind == "list":
            return TypeInfo("array", self.dtype, self.rank)
        return self

    def np_dtype(self):
        import numpy as _np
        if self.dtype == "bfloat16":  # numpy has no native bf16
            import ml_dtypes  # type: ignore

            return _np.dtype(ml_dtypes.bfloat16)
        return _np.dtype(self.dtype)


# ---------------------------------------------------------------------------
# Annotation parsing
# ---------------------------------------------------------------------------

_NDARRAY_RE = re.compile(r"ndarray\[\s*(\w+)\s*,\s*(\d+)\s*\]")
_LIST_RE = re.compile(r"list\[\s*(\w+)\s*,\s*(\d+)\s*\]")


def parse_annotation(ann) -> TypeInfo:
    """Parse a Python type hint into TypeInfo.

    Accepted forms (paper-style hints):
      float, int, bool, complex          → scalar
      'ndarray' / numpy.ndarray          → array of unknown dtype/rank
                                            (legality guard will check)
      'ndarray[f64,2]'                   → array float64 rank 2
      'list[f64,2]'                      → list-of-list, element float64
      list                               → list, unknown element
    """
    if ann is None:
        return TypeInfo.unknown()
    if ann in (float,):
        return TypeInfo.scalar("float64")
    if ann in (int,):
        return TypeInfo.scalar("int64")
    if ann in (bool,):
        return TypeInfo.scalar("bool")
    if ann in (complex,):
        return TypeInfo.scalar("complex128")
    if ann is list:
        return TypeInfo("list", None, 0)
    if isinstance(ann, str):
        s = ann.strip()
        # `from __future__ import annotations` stringifies the source
        # expression, wrapping already-quoted hints in a second layer
        if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
            s = s[1:-1].strip()
        m = _NDARRAY_RE.fullmatch(s)
        if m:
            return TypeInfo.array(m.group(1), int(m.group(2)))
        m = _LIST_RE.fullmatch(s)
        if m:
            return TypeInfo.list_of(m.group(1), int(m.group(2)))
        if s in ("ndarray", "np.ndarray", "numpy.ndarray"):
            return TypeInfo("array", None, 0)
        if s in ("float", "f64"):
            return TypeInfo.scalar("float64")
        if s in ("float32", "f32"):
            return TypeInfo.scalar("float32")
        if s in ("int", "i64"):
            return TypeInfo.scalar("int64")
        if s in ("int32", "i32"):
            return TypeInfo.scalar("int32")
        if s in ("complex", "c128"):
            return TypeInfo.scalar("complex128")
        if s in ("complex64", "c64"):
            return TypeInfo.scalar("complex64")
        if s == "bool":
            return TypeInfo.scalar("bool")
        if s == "None":
            return TypeInfo.none()
        return TypeInfo.unknown()
    try:  # numpy.ndarray class object
        if ann is np.ndarray:
            return TypeInfo("array", None, 0)
    except Exception:  # pragma: no cover
        pass
    return TypeInfo.unknown()


# ---------------------------------------------------------------------------
# Promotion / inference rules
# ---------------------------------------------------------------------------

_PROMOTE_ORDER = [
    "bool", "int8", "uint8", "int16", "int32", "int64",
    "bfloat16", "float16", "float32", "float64",
    "complex64", "complex128",
]


def promote_dtype(a: Optional[str], b: Optional[str]) -> Optional[str]:
    if a is None:
        return b
    if b is None:
        return a
    ia, ib = _PROMOTE_ORDER.index(a), _PROMOTE_ORDER.index(b)
    hi = _PROMOTE_ORDER[max(ia, ib)]
    # int ⊕ float → float64 like numpy default; complex absorbs.
    if {a, b} <= set(_PROMOTE_ORDER[:6]) or hi in _PROMOTE_ORDER[6:]:
        return hi
    return hi


def broadcast(a: TypeInfo, b: TypeInfo) -> TypeInfo:
    """Elementwise-op result type (numpy broadcasting on ranks)."""
    a, b = a.as_array(), b.as_array()
    dtype = promote_dtype(a.dtype, b.dtype)
    rank = max(a.rank, b.rank)
    if rank == 0:
        return TypeInfo.scalar(dtype or "float64")
    return TypeInfo.array(dtype or "float64", rank)


def nested_list_shape(value) -> "tuple":
    """Shape of a nested list-of-lists judged by its first elements:
    ``[[1,2],[3,4],[5,6]]`` → ``(3, 2)``. The single implementation used
    by runtime legality checks, dispatch signatures, and the tracer."""
    dims = []
    x = value
    while isinstance(x, list):
        dims.append(len(x))
        x = x[0] if x else None
    return tuple(dims)


def runtime_typeinfo(value) -> TypeInfo:
    """TypeInfo of an actual runtime value (used by legality checks)."""
    import numpy as _np

    if isinstance(value, (bool, _np.bool_)):
        return TypeInfo.scalar("bool")
    if isinstance(value, (int, _np.integer)):
        return TypeInfo.scalar("int64")
    if isinstance(value, (float, _np.floating)):
        return TypeInfo.scalar("float64")
    if isinstance(value, (complex, _np.complexfloating)):
        return TypeInfo.scalar("complex128")
    if isinstance(value, _np.ndarray):
        return TypeInfo.array(str(value.dtype), value.ndim)
    # a tensor can only exist once torch is imported: no import here
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        return TypeInfo.array(str(value.dtype).removeprefix("torch."),
                              value.ndim)
    if isinstance(value, list):
        # NB: depth counts non-empty levels only — an empty list stays
        # rank-0/unknown so legality falls back conservatively. This is
        # intentionally NOT nested_list_shape (which sizes every level).
        depth, elem = 0, value
        while isinstance(elem, list) and elem:
            depth += 1
            elem = elem[0]
        et = runtime_typeinfo(elem) if not isinstance(elem, list) else TypeInfo.unknown()
        return TypeInfo("list", et.dtype, depth)
    return TypeInfo.unknown()


def matches(hint: TypeInfo, actual: TypeInfo) -> bool:
    """Legality predicate: does a runtime value satisfy the hint?

    This is the check compiled into the multi-version dispatcher: the
    specialized variant runs only when annotated/inferred types AND ranks
    match reality (paper §4.1)."""
    if hint.kind == "unknown":
        return True
    if hint.kind != actual.kind and not (
        hint.kind == "array" and actual.kind == "array"
    ):
        if hint.kind == "list" and actual.kind == "list":
            pass
        else:
            return False
    if hint.dtype is not None and actual.dtype is not None:
        if hint.dtype != actual.dtype:
            return False
    if hint.kind in ("array", "list") and hint.rank and actual.rank:
        if hint.rank != actual.rank:
            return False
    return True
