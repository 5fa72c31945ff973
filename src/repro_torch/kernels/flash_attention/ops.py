"""Dispatch for the flash-attention kernel, and its GQA layout.

:func:`flash_attention_bhsd` sends CUDA tensors to the hand-written
kernel (:mod:`.flash_attention`, which masks ragged edges itself, so
nothing is padded here) and CPU tensors to the kernel's plain version
(:func:`.ref.flash_attention_bhsd_ref`), counting those calls in
:data:`plain_calls`; the choice follows only where the tensors lie.
:func:`flash_attention` takes ``(B, S, H, D)`` GQA tensors. bf16 CUDA
tensors with no gradient recorded (the served path, which runs under
``torch.inference_mode()``) go to the kernel's grouped-query entry
(:func:`.flash_attention.flash_attention_gqa`), which reads K/V in place
through their strides, query head ``h`` on KV head ``h // G``; every
other call regroups to ``(B·H, S, D)`` with K/V repeated over the
query-head groups (:func:`regroup`, the reference's ``ops.py``), runs
:func:`flash_attention_bhsd`, and regroups back. Its ``q_offset`` (the
reference's ``plain_attention(..., q_offset=...)``) is an int or one
position per batch row, ``(B,)``, repeated over the heads.

Gradients: where grad mode is on and an operand requires grad,
:func:`flash_attention_bhsd` runs through :class:`FlashAttention`, a
``torch.autograd.Function`` on both devices: its forward keeps the
logsumexp of each row, its backward calls
:func:`flash_attention_bhsd_bwd` (the backward kernels for CUDA tensors,
:func:`.ref.flash_attention_bhsd_bwd_ref` for CPU tensors, counted in
:data:`plain_calls` too). :func:`flash_attention`'s regroup is plain
autograd, so dK and dV are summed over the repeated groups. The
gradient takes the forward's query offset, and a row with no valid key
(its forward output the mean of V) gets dQ = 0 and adds dO / Skv to dV
of every key, as the reference's gradient does. Without grad the op is
the forward alone, as served.

The forward and the backward are the custom ops
``repro_torch::flash_attention_fwd`` and ``..._bwd`` (their fake
versions give the shapes, so fake tensors run no kernel and no plain
version): a dispatch mode sees each call as one op, whichever runs it,
and ``launch/op_analysis.py`` gives them FLOP formulas.

Sharded inputs: :func:`flash_attention` takes DTensors through
``local_map`` (:func:`_sharded`). Each rank runs the call above on its
slice of the batch and of the query heads; any other sharding (the
sequence, the head dim, a partial sum) is gathered first. K/V heads
shard with the query heads where their count splits as evenly; else
each rank takes K/V whole over those mesh dimensions and picks, for
each of its query heads, its KV head (``h // G``). :data:`local_calls`
counts the sharded calls.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from . import flash_attention as _kernel
from .ref import flash_attention_bhsd_bwd_ref, flash_attention_bhsd_ref
from ..sharded import (as_dtensor, is_dtensor, keep_shards, mesh_of, remap,
                       shard_index, shards)

# calls that took a plain version (CPU tensors: forward or backward) in
# this process
plain_calls = 0
# calls of flash_attention on DTensors (one local_map each)
local_calls = 0


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int, softcap: float,
                q_offset: Optional[torch.Tensor], return_lse: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse); lse is empty unless ``return_lse``."""
    global plain_calls
    if q.is_cuda or k.is_cuda or v.is_cuda:
        out = _kernel.flash_attention_bhsd(
            q, k, v, causal=causal, window=window, softcap=softcap,
            q_offset=q_offset, return_lse=return_lse)
    else:
        plain_calls += 1
        out = flash_attention_bhsd_ref(q, k, v, causal=causal,
                                       window=window, softcap=softcap,
                                       q_offset=q_offset,
                                       return_lse=return_lse)
    if return_lse:
        return out
    return out, q.new_empty(0, dtype=torch.promote_types(q.dtype,
                                                         torch.float32))


@_forward_op.register_fake
def _(q, k, v, causal, window, softcap, q_offset, return_lse):
    acc = torch.promote_types(q.dtype, torch.float32)
    lse = q.new_empty(q.shape[:2] if return_lse else (0,), dtype=acc)
    return q.new_empty(q.shape[:2] + v.shape[2:]), lse


def _forward(q, k, v, *, causal, window, softcap, q_offset=None,
             return_lse=False):
    out, lse = _forward_op(q, k, v, bool(causal), int(window or 0),
                           float(softcap or 0.0), q_offset,
                           bool(return_lse))
    return (out, lse) if return_lse else out


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                 causal: bool, window: int, softcap: float,
                 q_offset: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global plain_calls
    if q.is_cuda:
        return _kernel.flash_attention_bhsd_bwd(
            q, k, v, o, do, lse, causal=causal, window=window,
            softcap=softcap, q_offset=q_offset)
    plain_calls += 1
    return flash_attention_bhsd_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                        window=window, softcap=softcap,
                                        q_offset=q_offset)


@_backward_op.register_fake
def _(q, k, v, o, do, lse, causal, window, softcap, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def flash_attention_bhsd_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0,
                             q_offset: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of :func:`flash_attention_bhsd` from its output, its
    logsumexp and the output's gradient: the backward kernels for CUDA
    tensors, the plain backward for CPU tensors."""
    return _backward_op(q, k, v, o, do, lse, bool(causal), int(window or 0),
                        float(softcap or 0.0), q_offset)


class FlashAttention(torch.autograd.Function):
    """Flash attention on ``(BH, S, D)`` with its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        out, lse = _forward(q, k, v, causal=causal, window=window,
                            softcap=softcap, q_offset=q_offset,
                            return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, q_offset)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_offset = ctx.saved_tensors
        # looked up at call time, so a caller may swap the backward
        dq, dk, dv = flash_attention_bhsd_bwd(q, k, v, out, do.contiguous(),
                                              lse, q_offset=q_offset,
                                              **ctx.opts)
        return dq, dk, dv, None, None, None, None


def _records_grad(q, k, v) -> bool:
    return torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0,
                         q_offset: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """``q_offset``: None or int32 ``(BH,)``."""
    if not _records_grad(q, k, v):
        return _forward(q, k, v, causal=causal, window=window,
                        softcap=softcap, q_offset=q_offset)
    return FlashAttention.apply(q, k, v, bool(causal), int(window or 0),
                                float(softcap or 0.0), q_offset)


def batch_offset(q_offset: Union[int, torch.Tensor], b: int, device):
    """An int or a 0-d or (B,) tensor offset as None (no offset) or a
    contiguous int32 ``(B,)`` on ``device`` (no copy where it is one)."""
    if isinstance(q_offset, torch.Tensor):
        return q_offset.to(device, torch.int32).reshape(-1).expand(b) \
            .contiguous()
    if q_offset:
        return torch.full((b,), int(q_offset), dtype=torch.int32,
                          device=device)
    return None


def regroup(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            q_offset: Union[int, torch.Tensor] = 0):
    """(q, k, v, q_offset) of :func:`flash_attention` in the kernel's
    layout: contiguous ``(B·H, S, D)`` with K/V repeated over the
    query-head groups, and the offset as None or int32 ``(B·H,)``."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    # (B, S, H, D) → contiguous (B·H, S, D) with kv repeated across
    # groups (at B = 1 a reshape alone would return a strided view)
    qf = q.transpose(1, 2).reshape(b * h, sq, d).contiguous()
    kf = k.transpose(1, 2).repeat_interleave(g, dim=1) \
        .reshape(b * h, skv, d).contiguous()
    vf = v.transpose(1, 2).repeat_interleave(g, dim=1) \
        .reshape(b * h, skv, d).contiguous()
    off = batch_offset(q_offset, b, q.device)
    return qf, kf, vf, None if off is None else off.repeat_interleave(h)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    q_offset: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, KVH, D), H a multiple of KVH;
    ``q_offset``: an int or (B,). DTensors go through :func:`_sharded`."""
    if is_dtensor(q, k, v, q_offset):
        return _sharded(q, k, v, causal=causal, window=window,
                        softcap=softcap, q_offset=q_offset)
    if q.is_cuda and q.dtype == torch.bfloat16 and not _records_grad(q, k,
                                                                     v):
        return _kernel.flash_attention_gqa(
            q, k, v, causal=causal, window=window, softcap=softcap,
            q_offset=batch_offset(q_offset, q.shape[0], q.device))
    b, sq, h, d = q.shape
    qf, kf, vf, off = regroup(q, k, v, q_offset)
    out = flash_attention_bhsd(qf, kf, vf, causal=causal, window=window,
                               softcap=softcap, q_offset=off)
    return out.reshape(b, h, sq, d).transpose(1, 2)


def _sharded(q, k, v, *, causal, window, softcap, q_offset):
    """:func:`flash_attention` on DTensors, one ``local_map``: each rank
    runs it on its batch rows and query heads."""
    from torch.distributed.tensor.experimental import local_map

    from torch.distributed.tensor import Partial, Shard

    mesh = mesh_of(q, k, v, q_offset)
    q, k, v = (as_dtensor(t, mesh) for t in (q, k, v))
    h = q.shape[2]
    g = h // k.shape[2]
    qp = keep_shards(q.placements, (0, 2), q.shape, mesh)
    n_h = shards(qp, 2, mesh)
    whole_kv = k.shape[2] % n_h != 0
    kvp = remap(qp, {0: 0, 2: None if whole_kv else 2})
    # K/V taken whole over the query heads' mesh dims: each rank's dK/dV
    # holds its heads' part, summed over those dims
    kv_grad = [Partial() if whole_kv and p == Shard(2) else kp
               for p, kp in zip(qp, kvp)]
    h_local = h // n_h
    h0 = shard_index(qp, 2, mesh) * h_local
    if isinstance(q_offset, torch.Tensor):
        q_offset = as_dtensor(q_offset, mesh)
        offp = remap(qp, {0: 0} if q_offset.dim() else {})
    else:
        offp = None

    def local(ql, kl, vl, off):
        global local_calls
        local_calls += 1
        if whole_kv:
            # each local query head on its KV head, h // G
            idx = torch.div(h0 + torch.arange(h_local, device=kl.device),
                            g, rounding_mode="floor")
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        return flash_attention(ql, kl, vl, causal=causal, window=window,
                               softcap=softcap, q_offset=off)

    return local_map(local, out_placements=qp,
                     in_placements=(qp, kvp, kvp, offp),
                     in_grad_placements=(qp, kv_grad, kv_grad, offp),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, q_offset)
