"""Dispatch for the selective-scan kernel: CUDA tensors go to the
hand-written kernel (:mod:`.mamba_scan`, which takes any L, so nothing
is chunked here), CPU tensors to the kernel's plain version
(:func:`.ref.mamba_scan_promoted_ref`), counting those calls in
:data:`plain_calls`. The choice follows only where the tensors lie.
With ``return_state`` both return (y, h_L), the state after the last
step in ``promote(dtype, float32)``.

The kernel has no backward yet (ROADMAP Queue 1, "the scan's backward
kernel"): on the card, with grad mode on and an operand that requires
grad, the op raises ``NotImplementedError`` rather than return a ``y``
with no gradient. The plain version on the CPU is differentiable."""

from __future__ import annotations

import torch

from . import mamba_scan as _kernel
from .ref import mamba_scan_promoted_ref

# calls that took the plain version (CPU tensors) in this process
plain_calls = 0


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
               return_state: bool = False):
    global plain_calls
    ops = (x, dt, Bm, Cm, a, d_skip)
    if any(t.is_cuda for t in ops):
        if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
            raise NotImplementedError(
                "mamba scan: the CUDA kernel has no backward yet (ROADMAP "
                "Queue 1, the scan's backward kernel); a gradient through "
                "the scan runs on the CPU only")
        return _kernel.mamba_scan(x, dt, Bm, Cm, a, d_skip, return_state)
    plain_calls += 1
    return mamba_scan_promoted_ref(x, dt, Bm, Cm, a, d_skip, return_state)
