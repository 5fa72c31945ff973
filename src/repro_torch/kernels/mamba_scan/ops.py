"""Dispatch for the selective-scan kernel: CUDA tensors go to the
hand-written kernel (:mod:`.mamba_scan`, which takes any L, so nothing
is chunked here), CPU tensors to the kernel's plain version
(:func:`.ref.mamba_scan_promoted_ref`), counting those calls in
:data:`plain_calls`. The choice follows only where the tensors lie.
With ``return_state`` both return (y, h_L), the state after the last
step in ``promote(dtype, float32)``.

Gradients: where grad mode is on and an operand requires grad,
:func:`mamba_scan` runs through :class:`MambaScan`, a
``torch.autograd.Function`` on both devices. On the card its forward
kernel also keeps each segment's entry state, and its backward calls
:func:`mamba_scan_bwd`: the backward kernel for CUDA tensors,
:func:`.ref.mamba_scan_bwd_ref` for CPU tensors (counted in
:data:`bwd_plain_calls`). The final state's gradient, where h_L is used,
seeds the adjoint. Without grad the op is the forward alone, as served.
"""

from __future__ import annotations

import torch

from . import mamba_scan as _kernel
from .ref import mamba_scan_bwd_ref, mamba_scan_promoted_ref

# calls that took the plain version (CPU tensors) in this process
plain_calls = 0
# backward calls that took the plain backward (CPU tensors)
bwd_plain_calls = 0


def _forward(x, dt, Bm, Cm, a, d_skip, return_state=False,
             save_states=False):
    global plain_calls
    if any(t.is_cuda for t in (x, dt, Bm, Cm, a, d_skip)):
        return _kernel.mamba_scan(x, dt, Bm, Cm, a, d_skip, return_state,
                                  save_states)
    plain_calls += 1
    out = mamba_scan_promoted_ref(x, dt, Bm, Cm, a, d_skip, return_state)
    if save_states:
        return (*out, None) if return_state else (out, None, None)
    return out


def mamba_scan_bwd(x, dt, Bm, Cm, a, d_skip, dy, states=None,
                   dh_last=None):
    """(dx, ddt, dBm, dCm, da, dd_skip) of :func:`mamba_scan` from the
    output's gradient ``dy`` and, where given, the final state's
    ``dh_last``: the backward kernel for CUDA tensors (with the forward
    kernel's ``states``), the plain backward for CPU tensors."""
    global bwd_plain_calls
    if x.is_cuda:
        return _kernel.mamba_scan_bwd(x, dt, Bm, Cm, a, d_skip, dy, states,
                                      dh_last)
    bwd_plain_calls += 1
    return mamba_scan_bwd_ref(x, dt, Bm, Cm, a, d_skip, dy, dh_last)


class MambaScan(torch.autograd.Function):
    """The selective scan with its gradient; returns y, or (y, h_L)."""

    @staticmethod
    def forward(ctx, x, dt, Bm, Cm, a, d_skip, return_state):
        y, h_last, states = _forward(x, dt, Bm, Cm, a, d_skip, True,
                                     save_states=True)
        ctx.save_for_backward(x, dt, Bm, Cm, a, d_skip, states)
        ctx.set_materialize_grads(False)
        return (y, h_last) if return_state else y

    @staticmethod
    def backward(ctx, dy, dh_last=None):
        x, dt, Bm, Cm, a, d_skip, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dh_last is not None:
            dh_last = dh_last.contiguous()
        # looked up at call time, so a caller may swap the backward
        grads = mamba_scan_bwd(x, dt, Bm, Cm, a, d_skip, dy, states,
                               dh_last)
        return (*grads, None)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
               return_state: bool = False):
    ops = (x, dt, Bm, Cm, a, d_skip)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        return MambaScan.apply(*ops, bool(return_state))
    return _forward(*ops, return_state)
