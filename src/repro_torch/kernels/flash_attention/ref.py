"""Plain torch versions of the flash-attention kernel (its oracles, and
the path CPU tensors take).

* :func:`attention_ref` — the torch counterpart of
  ``repro/kernels/flash_attention/ref.py`` on ``(B, S, H, D)`` tensors
  with GQA: a plain softmax over the masked scores.
* :func:`flash_attention_bhsd_ref` — exactly what the kernel computes
  on ``(BH, S, D)``: masked scores at ``-1e30``, row max, ``exp``, the
  probabilities cast to ``v``'s dtype before the product with ``v``,
  and ``acc / max(l, 1e-30)``, all in ``promote(dtype, float32)``, cast
  to ``q``'s dtype. A row whose every key is masked averages all of
  ``v``, as the kernel's (and the reference's) running state does.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask(sq: int, skv: int, causal: bool, window: int,
          device) -> torch.Tensor:
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window and window > 0:
        mask &= k_pos > (q_pos - window)
    return mask


def _scores(q, k, acc, softcap: float):
    s = (q.to(acc) @ k.to(acc).transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if softcap and softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    return s


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, KVH, D). GQA via head groups."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, sq, kvh, g, d).permute(0, 2, 3, 1, 4)  # b k g q d
    kk = k.permute(0, 2, 1, 3)[:, :, None]                   # b k 1 s d
    vv = v.permute(0, 2, 1, 3)[:, :, None]
    s = _scores(qg, kk, acc, softcap)                         # b k g q s
    s = torch.where(_mask(sq, skv, causal, window, q.device), s,
                    torch.tensor(NEG_INF, dtype=acc, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = p.to(q.dtype) @ vv.to(q.dtype)                      # b k g q d
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


def flash_attention_bhsd_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0,
                             softcap: float = 0.0) -> torch.Tensor:
    """q: (BH, Sq, D); k/v: (BH, Skv, D) — the kernel's function."""
    acc = torch.promote_types(q.dtype, torch.float32)
    s = _scores(q, k, acc, softcap)                           # bh q s
    s = torch.where(_mask(q.shape[1], k.shape[1], causal, window,
                          q.device), s,
                    torch.tensor(NEG_INF, dtype=acc, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = p.to(v.dtype).to(acc) @ v.to(acc)
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)
