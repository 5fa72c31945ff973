"""Plain torch version of the matmul kernel (its oracle, and the path
CPU tensors take).

The torch counterpart of ``repro/kernels/matmul/ref.py``: accumulate in
``promote(dtype, float32)`` (so float64 stays float64) and cast to the
input's dtype.
"""

from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor,
               out_dtype: torch.dtype = None) -> torch.Tensor:
    out_dtype = out_dtype or x.dtype
    acc = torch.promote_types(x.dtype, torch.float32)
    return (x.to(acc) @ y.to(acc)).to(out_dtype)
