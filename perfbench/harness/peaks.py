"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float,
            peak_flops: float = BF16_FLOPS) -> float:
    """The least time a kernel could take: the larger of its operations
    at the peak rate and its bytes at the memory's."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_S)
