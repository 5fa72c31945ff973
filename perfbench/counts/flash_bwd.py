"""Operations and bytes of one call of the flash-attention backward
(``kernels/flash_attention/csrc/flash_attention_bwd.cu``) on (BH, S, D):
five products of 2 · D a valid query-key pair (S, dP, dV, dQ, dK); q,
k, v, o and dO read once and dQ, dK, dV written once (bf16)."""

from __future__ import annotations

from pathlib import Path

from perfbench.harness.bench import load_file

fwd = load_file(Path(__file__).with_name("flash_fwd.py"),
                "perfbench_counts_flash_fwd")

#: the backward's kernels by name in the device trace (the Δ preamble,
#: dK/dV, dQ); one ``mma_dq_kernel`` a call
KERNELS = ("delta_kernel", "mma_dkdv_kernel", "mma_dq_kernel")
CALL_KERNEL = "mma_dq_kernel"


def flops(bh, s, d, causal=True) -> float:
    return 10.0 * d * bh * fwd.valid_pairs(s, s, 0, causal)


def nbytes(bh, s, d, itemsize=2) -> float:
    return float(itemsize * bh * s * d * 8)
