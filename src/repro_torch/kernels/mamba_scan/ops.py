"""Dispatch for the selective-scan kernel: CUDA tensors go to the
hand-written kernel (:mod:`.mamba_scan`, which takes any L, so nothing
is chunked here), CPU tensors to the kernel's plain version
(:func:`.ref.mamba_scan_promoted_ref`). The choice follows only where
the tensors lie."""

from __future__ import annotations

import torch

from . import mamba_scan as _kernel
from .ref import mamba_scan_promoted_ref


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, a: torch.Tensor,
               d_skip: torch.Tensor) -> torch.Tensor:
    if any(t.is_cuda for t in (x, dt, Bm, Cm, a, d_skip)):
        return _kernel.mamba_scan(x, dt, Bm, Cm, a, d_skip)
    return mamba_scan_promoted_ref(x, dt, Bm, Cm, a, d_skip)
