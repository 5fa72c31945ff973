"""Dispatch for the matmul kernel: CUDA tensors go to the hand-written
kernel (:mod:`.matmul`, which masks ragged edges itself, so nothing is
padded here), CPU tensors to the plain version (:mod:`.ref`). The choice
follows only where the tensors lie."""

from __future__ import annotations

import torch

from . import matmul as _kernel
from .ref import matmul_ref


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if x.is_cuda or y.is_cuda:
        return _kernel.matmul(x, y)
    return matmul_ref(x, y)
