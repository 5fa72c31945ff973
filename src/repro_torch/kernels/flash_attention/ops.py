"""Dispatch for the flash-attention kernel, and its GQA layout.

:func:`flash_attention_bhsd` sends CUDA tensors to the hand-written
kernel (:mod:`.flash_attention`, which masks ragged edges itself, so
nothing is padded here) and CPU tensors to the kernel's plain version
(:func:`.ref.flash_attention_bhsd_ref`), counting those calls in
:data:`plain_calls`; the choice follows only where the tensors lie.
:func:`flash_attention` regroups ``(B, S, H, D)`` GQA tensors to
``(B·H, S, D)`` with K/V repeated over the query-head groups
(:func:`regroup`, the reference's ``ops.py``), runs that, and regroups
back. Its ``q_offset`` (the reference's ``plain_attention(...,
q_offset=...)``) is an int or one position per batch row, ``(B,)``,
repeated over the heads.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from . import flash_attention as _kernel
from .ref import flash_attention_bhsd_ref

# calls that took the plain version (CPU tensors) in this process
plain_calls = 0


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0,
                         q_offset: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """``q_offset``: None or int32 ``(BH,)``."""
    global plain_calls
    if q.is_cuda or k.is_cuda or v.is_cuda:
        return _kernel.flash_attention_bhsd(q, k, v, causal=causal,
                                            window=window, softcap=softcap,
                                            q_offset=q_offset)
    plain_calls += 1
    return flash_attention_bhsd_ref(q, k, v, causal=causal, window=window,
                                    softcap=softcap, q_offset=q_offset)


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
    if isinstance(q_offset, torch.Tensor):       # one per batch row, or 0-d
        off = q_offset.to(q.device, torch.int32).reshape(-1).expand(b) \
            .repeat_interleave(h)
    elif q_offset:
        off = torch.full((b * h,), int(q_offset), dtype=torch.int32,
                         device=q.device)
    else:
        off = None
    return qf, kf, vf, off


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    q_offset: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, KVH, D), H a multiple of KVH;
    ``q_offset``: an int or (B,)."""
    b, sq, h, d = q.shape
    qf, kf, vf, off = regroup(q, k, v, q_offset)
    out = flash_attention_bhsd(qf, kf, vf, causal=causal, window=window,
                               softcap=softcap, q_offset=off)
    return out.reshape(b, h, sq, d).transpose(1, 2)
