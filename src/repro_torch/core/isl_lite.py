"""isl_lite: exact integer affine expressions and iteration domains.

The paper manipulates polyhedral sets via islpy/sympy; neither is available
offline, so this module implements the affine subset AutoMPHC's benchmarks
exercise: affine expressions over loop iterators and symbolic parameters,
rectangular/triangular iteration domains, and the set operations the
dependence tester and scheduler need. All arithmetic is exact (ints +
symbolic coefficients); nothing here touches floating point.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class AffineError(Exception):
    """Raised when an expression leaves the affine subset."""


@dataclass(frozen=True)
class Affine:
    """Affine expression sum_i coeff[v_i] * v_i + const.

    Variables are plain strings (loop iterators or structure parameters such
    as ``M``/``N``). Immutable and hashable so it can key dependence caches.
    """

    coeffs: Tuple[Tuple[str, int], ...] = ()
    const: int = 0

    # -- constructors -------------------------------------------------
    @staticmethod
    def constant(c: int) -> "Affine":
        return Affine((), int(c))

    @staticmethod
    def var(name: str, coeff: int = 1) -> "Affine":
        if coeff == 0:
            return Affine((), 0)
        return Affine(((name, int(coeff)),), 0)

    @staticmethod
    def of(x) -> "Affine":
        if isinstance(x, Affine):
            return x
        if isinstance(x, bool):
            raise AffineError("bool is not affine")
        if isinstance(x, int):
            return Affine.constant(x)
        if isinstance(x, str):
            return Affine.var(x)
        raise AffineError(f"cannot coerce {x!r} to Affine")

    # -- helpers ------------------------------------------------------
    def as_dict(self) -> Dict[str, int]:
        return dict(self.coeffs)

    @staticmethod
    def _from_dict(d: Dict[str, int], const: int) -> "Affine":
        items = tuple(sorted((k, v) for k, v in d.items() if v != 0))
        return Affine(items, int(const))

    # -- algebra ------------------------------------------------------
    def __add__(self, other) -> "Affine":
        other = Affine.of(other)
        d = self.as_dict()
        for k, v in other.coeffs:
            d[k] = d.get(k, 0) + v
        return Affine._from_dict(d, self.const + other.const)

    __radd__ = __add__

    def __neg__(self) -> "Affine":
        return Affine._from_dict({k: -v for k, v in self.coeffs}, -self.const)

    def __sub__(self, other) -> "Affine":
        return self + (-Affine.of(other))

    def __rsub__(self, other) -> "Affine":
        return Affine.of(other) + (-self)

    def __mul__(self, other) -> "Affine":
        if isinstance(other, Affine):
            if other.is_constant():
                other = other.const
            elif self.is_constant():
                self, other = other, self.const
            else:
                raise AffineError("product of two non-constant affines")
        if not isinstance(other, int):
            raise AffineError(f"cannot scale Affine by {other!r}")
        return Affine._from_dict(
            {k: v * other for k, v in self.coeffs}, self.const * other
        )

    __rmul__ = __mul__

    # -- queries ------------------------------------------------------
    def is_constant(self) -> bool:
        return not self.coeffs

    def coeff(self, name: str) -> int:
        for k, v in self.coeffs:
            if k == name:
                return v
        return 0

    def vars(self) -> Tuple[str, ...]:
        return tuple(k for k, _ in self.coeffs)

    def drop(self, names: Iterable[str]) -> "Affine":
        names = set(names)
        return Affine._from_dict(
            {k: v for k, v in self.coeffs if k not in names}, self.const
        )

    def substitute(self, env: Dict[str, "Affine"]) -> "Affine":
        out = Affine.constant(self.const)
        for k, v in self.coeffs:
            out = out + (env[k] * v if k in env else Affine.var(k, v))
        return out

    def evaluate(self, env: Dict[str, int]) -> int:
        total = self.const
        for k, v in self.coeffs:
            if k not in env:
                raise AffineError(f"unbound variable {k} in {self}")
            total += v * env[k]
        return total

    def equals(self, other: "Affine") -> bool:
        return (self - other).is_zero()

    def is_zero(self) -> bool:
        return self.is_constant() and self.const == 0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        parts = []
        for k, v in self.coeffs:
            if v == 1:
                parts.append(k)
            elif v == -1:
                parts.append(f"-{k}")
            else:
                parts.append(f"{v}*{k}")
        if self.const or not parts:
            parts.append(str(self.const))
        out = " + ".join(parts)
        return out.replace("+ -", "- ")


@dataclass(frozen=True)
class LoopDim:
    """One iteration dimension: var in [lower, upper) step `step`.

    Bounds are affine in parameters and *enclosing* iterators (triangular
    domains, e.g. j in [i+1, M), are first-class — the correlation kernel
    needs them).
    """

    var: str
    lower: Affine
    upper: Affine  # exclusive
    step: int = 1

    def extent(self) -> Affine:
        return self.upper - self.lower


@dataclass(frozen=True)
class Domain:
    """Iteration domain as an ordered list of LoopDims (lexicographic)."""

    dims: Tuple[LoopDim, ...] = ()

    def iter_vars(self) -> Tuple[str, ...]:
        return tuple(d.var for d in self.dims)

    def rank(self) -> int:
        return len(self.dims)

    def inner(self, var: str) -> "Domain":
        """Dims strictly inside `var`."""
        names = self.iter_vars()
        i = names.index(var)
        return Domain(self.dims[i + 1 :])

    def with_dim(self, dim: LoopDim) -> "Domain":
        return Domain(self.dims + (dim,))

    def is_rectangular(self) -> bool:
        seen: set = set()
        for d in self.dims:
            for b in (d.lower, d.upper):
                if any(v in seen for v in b.vars()):
                    return False
            seen.add(d.var)
        return True

    def triangular_pairs(self) -> List[Tuple[str, str, int]]:
        """Return (outer, inner, offset) for inner dims bounded below by an
        outer iterator (j >= i + offset). Used by raising to emit triu/tril."""
        out = []
        seen: Dict[str, int] = {}
        for idx, d in enumerate(self.dims):
            for v in d.lower.vars():
                if v in seen:
                    off = d.lower.const if d.lower.coeff(v) == 1 else None
                    if off is not None and len(d.lower.coeffs) == 1:
                        out.append((v, d.var, off))
            seen[d.var] = idx
        return out

    def cardinality(self, env: Dict[str, int]) -> int:
        """Number of points given concrete parameter values (exact for
        rectangular; triangular handled by summation)."""
        total = 0

        def rec(i: int, binding: Dict[str, int]) -> int:
            if i == len(self.dims):
                return 1
            d = self.dims[i]
            lo = d.lower.evaluate({**env, **binding})
            hi = d.upper.evaluate({**env, **binding})
            n = max(0, -(-(hi - lo) // d.step))
            # Fast path: remaining dims do not reference this var.
            refs = any(
                d.var in b.vars()
                for dd in self.dims[i + 1 :]
                for b in (dd.lower, dd.upper)
            )
            if not refs:
                sub = rec(i + 1, binding)
                return n * sub
            count = 0
            v = lo
            while v < hi:
                binding2 = dict(binding)
                binding2[d.var] = v
                count += rec(i + 1, binding2)
                v += d.step
            return count

        total = rec(0, {})
        return total


# ---------------------------------------------------------------------------
# Dependence-solving primitives
# ---------------------------------------------------------------------------

def gcd_test(coeffs: Sequence[int], const: int) -> bool:
    """Return True if sum coeffs[i]*x_i = const MAY have an integer solution
    (classic GCD test). False ⇒ definitely independent."""
    nz = [abs(c) for c in coeffs if c != 0]
    if not nz:
        return const == 0
    g = nz[0]
    for c in nz[1:]:
        g = math.gcd(g, c)
    return const % g == 0


def banerjee_test(
    coeffs: Sequence[int],
    const: int,
    bounds: Sequence[Tuple[Optional[int], Optional[int]]],
) -> bool:
    """Banerjee interval test for sum coeffs[i]*x_i + const = 0 with
    x_i in [lo_i, hi_i] (inclusive; None = unbounded). Returns True if a
    real solution may exist. False ⇒ definitely independent."""
    lo_total, hi_total = const, const
    for c, (lo, hi) in zip(coeffs, bounds):
        if c == 0:
            continue
        cand = []
        for b in (lo, hi):
            if b is None:
                cand.append(None)
            else:
                cand.append(c * b)
        vals = [v for v in cand if v is not None]
        if len(vals) < 2:
            return True  # unbounded direction: cannot disprove
        lo_total += min(vals)
        hi_total += max(vals)
    return lo_total <= 0 <= hi_total


def affine_eq_may_hold(
    lhs: Affine,
    rhs: Affine,
    var_bounds: Dict[str, Tuple[Optional[int], Optional[int]]],
) -> bool:
    """May lhs == rhs hold for integer assignments within var_bounds?
    Parameters absent from var_bounds are treated as unbounded symbols.
    Conservative: True when undecidable."""
    diff = lhs - rhs
    if diff.is_constant():
        return diff.const == 0
    names = list(diff.vars())
    coeffs = [diff.coeff(n) for n in names]
    if not gcd_test(coeffs, diff.const):
        return False
    bounds = [var_bounds.get(n, (None, None)) for n in names]
    return banerjee_test(coeffs, diff.const, bounds)
