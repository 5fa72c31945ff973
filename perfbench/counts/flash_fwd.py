"""Operations and bytes of one call of the flash-attention forward
(``kernels/flash_attention/csrc/flash_attention.cu``): QKᵀ and PV, 4 ·
head_dim operations a valid query-key pair and head; q and o once, and
the keys and values the queries reach once each (KV heads, bf16)."""

from __future__ import annotations

#: the forward's tensor-core kernel (prefill and training), by name in
#: the device trace
KERNELS = ("mma_fwd_kernel",)


def valid_pairs(sq: int, skv: int, offset: int = 0, causal=True) -> int:
    """Σ over query rows i of the keys row offset + i reaches."""
    if not causal:
        return sq * skv
    full = max(0, min(sq, skv - offset))      # rows whose keys all fit
    first, last = offset + 1, offset + full   # keys of those rows
    n = (first + last) * full // 2
    return n + (sq - full) * skv


def flops(b, sq, skv, h, d, offset=0, causal=True) -> float:
    return 4.0 * d * h * b * valid_pairs(sq, skv, offset, causal)


def nbytes(b, sq, skv, h, kvh, d, offset=0, causal=True,
           itemsize=2) -> float:
    keys = min(skv, offset + sq) if causal else skv
    return float(itemsize * b * d * (2 * sq * h + 2 * keys * kvh))
