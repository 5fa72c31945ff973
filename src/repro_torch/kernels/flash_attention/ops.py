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
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from . import flash_attention as _kernel
from .ref import flash_attention_bhsd_bwd_ref, flash_attention_bhsd_ref

# calls that took a plain version (CPU tensors: forward or backward) in
# this process
plain_calls = 0


def _forward(q, k, v, *, causal, window, softcap, q_offset=None,
             return_lse=False):
    global plain_calls
    if q.is_cuda or k.is_cuda or v.is_cuda:
        return _kernel.flash_attention_bhsd(
            q, k, v, causal=causal, window=window, softcap=softcap,
            q_offset=q_offset, return_lse=return_lse)
    plain_calls += 1
    return flash_attention_bhsd_ref(q, k, v, causal=causal, window=window,
                                    softcap=softcap, q_offset=q_offset,
                                    return_lse=return_lse)


def flash_attention_bhsd_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0,
                             q_offset: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of :func:`flash_attention_bhsd` from its output, its
    logsumexp and the output's gradient: the backward kernels for CUDA
    tensors, the plain backward for CPU tensors."""
    global plain_calls
    if q.is_cuda:
        return _kernel.flash_attention_bhsd_bwd(
            q, k, v, o, do, lse, causal=causal, window=window,
            softcap=softcap, q_offset=q_offset)
    plain_calls += 1
    return flash_attention_bhsd_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                        window=window, softcap=softcap,
                                        q_offset=q_offset)


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
    ``q_offset``: an int or (B,)."""
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
