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

The forward and the backward are the custom ops
``repro_torch::mamba_scan_fwd`` and ``..._bwd`` (their fake versions
give the shapes), seen by a dispatch mode as one op a call, whichever
runs it (``launch/op_analysis.py`` gives them FLOP formulas). DTensor
inputs go through ``local_map`` (:func:`_sharded`): each rank scans its
batch rows and channels; any other sharding (of L, of the states) is
gathered first. :data:`local_calls` counts the sharded calls.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import mamba_scan as _kernel
from .ref import mamba_scan_bwd_ref, mamba_scan_promoted_ref
from ..sharded import as_dtensor, is_dtensor, keep_shards, mesh_of, remap

# calls that took the plain version (CPU tensors) in this process
plain_calls = 0
# backward calls that took the plain backward (CPU tensors)
bwd_plain_calls = 0
# calls of mamba_scan on DTensors (one local_map each)
local_calls = 0
# the forward kernel's steps a chunk and segments a chunk
# (csrc/mamba_scan.cu: LC, WARPS; mamba_scan_segments)
_LC, _SEGS = 64, 4


@torch.library.custom_op("repro_torch::mamba_scan_fwd", mutates_args=())
def _forward_op(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                return_state: bool, save_states: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, h_L, states); h_L is empty unless ``return_state``, states
    unless ``save_states`` on the card."""
    global plain_calls
    states = h_last = None
    on_card = any(t.is_cuda for t in (x, dt, Bm, Cm, a, d_skip))
    if on_card:
        out = _kernel.mamba_scan(x, dt, Bm, Cm, a, d_skip, return_state,
                                 save_states)
    else:
        plain_calls += 1
        out = mamba_scan_promoted_ref(x, dt, Bm, Cm, a, d_skip,
                                      return_state)
    if save_states and on_card:
        y, h_last, states = out
    elif return_state:
        y, h_last = out
    else:
        y = out
    empty = x.new_empty(0)
    return (y, empty if h_last is None else h_last,
            empty.clone() if states is None else states)


@_forward_op.register_fake
def _(x, dt, Bm, Cm, a, d_skip, return_state, save_states):
    b, length, inner = x.shape
    n = Bm.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    h_last = x.new_empty((b, inner, n), dtype=acc) if return_state \
        else x.new_empty(0)
    kept = save_states and x.is_cuda and b and length and inner
    states = x.new_empty((b, -(-length // _LC) * _SEGS, n, inner),
                         dtype=acc) if kept else x.new_empty(0)
    return torch.empty_like(x), h_last, states


def _forward(x, dt, Bm, Cm, a, d_skip, return_state=False,
             save_states=False):
    y, h_last, states = _forward_op(x, dt, Bm, Cm, a, d_skip,
                                    bool(return_state), bool(save_states))
    h_last = h_last if return_state else None
    if save_states:
        # the kernel keeps no states of an empty scan
        return y, h_last, states if states.numel() else None
    return (y, h_last) if return_state else y


@torch.library.custom_op("repro_torch::mamba_scan_bwd", mutates_args=())
def _backward_op(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                 dy: torch.Tensor, states: Optional[torch.Tensor],
                 dh_last: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor, torch.Tensor]:
    global bwd_plain_calls
    if x.is_cuda:
        return _kernel.mamba_scan_bwd(x, dt, Bm, Cm, a, d_skip, dy, states,
                                      dh_last)
    bwd_plain_calls += 1
    return mamba_scan_bwd_ref(x, dt, Bm, Cm, a, d_skip, dy, dh_last)


@_backward_op.register_fake
def _(x, dt, Bm, Cm, a, d_skip, dy, states, dh_last):
    return tuple(torch.empty_like(t) for t in (x, dt, Bm, Cm, a, d_skip))


def mamba_scan_bwd(x, dt, Bm, Cm, a, d_skip, dy, states=None,
                   dh_last=None):
    """(dx, ddt, dBm, dCm, da, dd_skip) of :func:`mamba_scan` from the
    output's gradient ``dy`` and, where given, the final state's
    ``dh_last``: the backward kernel for CUDA tensors (with the forward
    kernel's ``states``), the plain backward for CPU tensors."""
    return _backward_op(x, dt, Bm, Cm, a, d_skip, dy, states, dh_last)


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
    if is_dtensor(*ops):
        return _sharded(*ops, return_state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        return MambaScan.apply(*ops, bool(return_state))
    return _forward(*ops, return_state)


def _sharded(x, dt, Bm, Cm, a, d_skip, return_state):
    """:func:`mamba_scan` on DTensors, one ``local_map``: each rank scans
    its batch rows and channels."""
    from torch.distributed.tensor.experimental import local_map

    mesh = mesh_of(x, dt, Bm, Cm, a, d_skip)
    x, dt, Bm, Cm, a, d_skip = (as_dtensor(t, mesh)
                                for t in (x, dt, Bm, Cm, a, d_skip))
    from torch.distributed.tensor import Partial, Shard

    xp = keep_shards(x.placements, (0, 2), x.shape, mesh)
    bcp = remap(xp, {0: 0})
    ap = remap(xp, {2: 0})
    out = (xp, remap(xp, {0: 0, 2: 1})) if return_state else xp
    # B/C's gradient sums over the channels' mesh dims, a's and d_skip's
    # over the batch's
    bc_grad = [Partial() if p == Shard(2) else bp for p, bp in zip(xp, bcp)]
    a_grad = [Partial() if p == Shard(0) else q for p, q in zip(xp, ap)]

    def local(*ts):
        global local_calls
        local_calls += 1
        return mamba_scan(*ts, return_state)

    return local_map(local, out_placements=out,
                     in_placements=(xp, xp, bcp, bcp, ap, ap),
                     in_grad_placements=(xp, xp, bc_grad, bc_grad, a_grad,
                                         a_grad),
                     device_mesh=mesh, redistribute_inputs=True)(
        x, dt, Bm, Cm, a, d_skip)
