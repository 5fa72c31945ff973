"""Dispatch for the flash-attention kernel, and its GQA layout.

:func:`flash_attention_bhsd` sends CUDA tensors to the hand-written
kernel (:mod:`.flash_attention`, which masks ragged edges itself, so
nothing is padded here) and CPU tensors to the kernel's plain version
(:func:`.ref.flash_attention_bhsd_ref`); the choice follows only where
the tensors lie. :func:`flash_attention` regroups ``(B, S, H, D)`` GQA
tensors to ``(B·H, S, D)`` with K/V repeated over the query-head groups
(the reference's ``ops.py``), runs that, and regroups back.
"""

from __future__ import annotations

import torch

from . import flash_attention as _kernel
from .ref import flash_attention_bhsd_ref


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    if q.is_cuda or k.is_cuda or v.is_cuda:
        return _kernel.flash_attention_bhsd(q, k, v, causal=causal,
                                            window=window, softcap=softcap)
    return flash_attention_bhsd_ref(q, k, v, causal=causal, window=window,
                                    softcap=softcap)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, KVH, D), H a multiple of KVH."""
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
    out = flash_attention_bhsd(qf, kf, vf, causal=causal, window=window,
                               softcap=softcap)
    return out.reshape(b, h, sq, d).transpose(1, 2)
