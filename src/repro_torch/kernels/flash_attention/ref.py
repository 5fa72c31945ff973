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
  Asked for, it also returns the logsumexp ``m + log(l)`` of each row.
* :func:`attention_split_ref` — the split-KV decode's partition on
  ``(B, S, H, D)`` with GQA (the tests' oracle of its algebra): the keys
  cut into splits, each split's ``(m, l, acc)`` over the keys the batch
  row's rows walk (the kernel's ``key_bounds``), merged in split order
  as ``combine_kernel`` merges them.
* :func:`flash_attention_bhsd_bwd_ref` — exactly what the backward
  kernels compute (``csrc/flash_attention_bwd.cu``), step by step from
  the forward's ``lse``: ``P = exp(S - lse)`` on the valid pairs,
  ``Δ = rowsum(dO ⊙ O)``, ``dV = Pᵀ dO``, ``dS = P ⊙ (dO Vᵀ - Δ)``
  (times ``1 - tanh²`` under a softcap), ``dK = dSᵀ Q · scale``,
  ``dQ = dS K · scale``, in ``promote(dtype, float32)``; a row with
  no valid key (whose forward P is uniform over all Skv keys) adds its
  dO / Skv to dV of every key and nothing to dQ or dK, as the
  reference's gradient through scores masked at -1e30.

Both take the reference's ``q_offset`` (``plain_attention(...,
q_offset=...)``): query row ``i`` sits at position ``q_offset + i``, an
int (None: 0) for every row or a tensor of one offset per batch (B,)
here, per batch-head (BH,) in the kernel's layout.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

NEG_INF = -1e30


Offset = Optional[Union[int, torch.Tensor]]


def _mask(sq: int, skv: int, causal: bool, window: int, device,
          q_offset: Offset = 0) -> torch.Tensor:
    """(sq, skv) for an int offset, (R, sq, skv) for R offsets (a 0-d
    tensor is one)."""
    q_pos = torch.arange(sq, device=device)
    if isinstance(q_offset, torch.Tensor):
        q_pos = q_offset.to(device, torch.int64).reshape(-1, 1) + q_pos
    else:
        q_pos = q_pos + int(q_offset or 0)
    q_pos = q_pos[..., None]
    k_pos = torch.arange(skv, device=device)
    mask = torch.ones(q_pos.shape[:-1] + (skv,), dtype=torch.bool,
                      device=device)
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


def _masked_scores(q, k, acc, causal, window, softcap, q_offset=0):
    """(BH, Sq, Skv) scores of the kernel's layout, masked at NEG_INF."""
    s = _scores(q, k, acc, softcap)
    return torch.where(_mask(q.shape[1], k.shape[1], causal, window,
                             q.device, q_offset), s,
                       torch.tensor(NEG_INF, dtype=acc, device=q.device))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0, q_offset: Offset = 0
                  ) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, KVH, D). GQA via head groups;
    ``q_offset``: an int or (B,)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, sq, kvh, g, d).permute(0, 2, 3, 1, 4)  # b k g q d
    kk = k.permute(0, 2, 1, 3)[:, :, None]                   # b k 1 s d
    vv = v.permute(0, 2, 1, 3)[:, :, None]
    s = _scores(qg, kk, acc, softcap)                         # b k g q s
    mask = _mask(sq, skv, causal, window, q.device, q_offset)
    if mask.dim() == 3:                                       # per batch
        mask = mask[:, None, None]
    s = torch.where(mask, s,
                    torch.tensor(NEG_INF, dtype=acc, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = p.to(q.dtype) @ vv.to(q.dtype)                      # b k g q d
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


def flash_attention_bhsd_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0,
                             q_offset: Offset = 0, return_lse: bool = False):
    """q: (BH, Sq, D); k/v: (BH, Skv, D) — the kernel's function;
    ``q_offset``: an int or (BH,). With ``return_lse``, (out, lse), lse
    (BH, Sq) in ``promote(dtype, float32)``."""
    acc = torch.promote_types(q.dtype, torch.float32)
    s = _masked_scores(q, k, acc, causal, window, softcap, q_offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = p.to(v.dtype).to(acc) @ v.to(acc)
    den = torch.clamp(l, min=1e-30)
    out = (o / den).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(den))[..., 0]
    return out


def _walked_keys(sq: int, skv: int, causal: bool, window: int, device,
                 q_offset: Offset = 0) -> torch.Tensor:
    """(B or 1, Skv) bool: the keys the kernels walk for each batch row's
    query rows, the union of their valid keys, or every key where one of
    the rows has none (it averages v over all of them)."""
    mask = _mask(sq, skv, causal, window, device, q_offset)
    if mask.dim() == 2:
        mask = mask[None]
    every_row = mask.any(dim=-1).all(dim=-1, keepdim=True)      # (R, 1)
    return mask.any(dim=1) | ~every_row


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, splits: int, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        q_offset: Offset = 0, return_lse: bool = False):
    """q: (B, Sq, H, D); k/v: (B, Skv, KVH, D); ``q_offset``: an int or
    (B,). The keys cut into ``splits`` splits of ceil(Skv / splits); per
    split and row, over the keys its batch row walks (masked keys at
    NEG_INF): m_s, l_s = sum exp(s - m_s), acc_s = sum P v with P cast to
    v's dtype; a split holding none of them is skipped. Merged in split
    order: M = max m_s, l = sum l_s e^(m_s - M), acc likewise, out = acc
    / max(l, 1e-30) in q's dtype. A row with valid keys takes nothing
    from a split where it has none (m_s = NEG_INF, weight 0); a row with
    none anywhere averages v over every key. With ``return_lse``, (out,
    lse (B, H, Sq))."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, sq, kvh, g, d).permute(0, 2, 3, 1, 4)  # b k g q d
    kk = k.permute(0, 2, 1, 3)[:, :, None]                   # b k 1 s d
    vv = v.permute(0, 2, 1, 3)[:, :, None].to(acc)
    s = _scores(qg, kk, acc, softcap)                         # b k g q s
    mask = _mask(sq, skv, causal, window, q.device, q_offset)
    if mask.dim() == 3:                                       # per batch
        mask = mask[:, None, None]
    neg = torch.tensor(NEG_INF, dtype=acc, device=q.device)
    s = torch.where(mask, s, neg)
    walked = _walked_keys(sq, skv, causal, window, q.device, q_offset)
    walked = walked.expand(b, skv)[:, None, None, None]       # b 1 1 1 s
    length = -(-skv // splits)
    parts = []
    for k0 in range(0, skv, length):
        keys = walked[..., k0:k0 + length]
        x = torch.where(keys, s[..., k0:k0 + length], neg)
        m = x.amax(dim=-1, keepdim=True)
        p = torch.where(keys, torch.exp(x - m), torch.zeros((), dtype=acc))
        took = keys.any(dim=-1, keepdim=True)                 # b 1 1 1 1
        parts.append((m, took, p.sum(dim=-1, keepdim=True),
                      p.to(v.dtype).to(acc) @ vv[..., k0:k0 + length, :]))
    top = torch.stack([torch.where(t, m, torch.tensor(
        -math.inf, dtype=acc)) for m, t, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(top)
    o = torch.zeros(qg.shape, dtype=acc, device=q.device)
    for m, took, ls, os in parts:            # in split order
        w = torch.where(took, torch.exp(m - top), torch.zeros((), dtype=acc))
        l = l + ls * w
        o = o + os * w
    den = torch.clamp(l, min=1e-30)
    out = (o / den).to(q.dtype).permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    if return_lse:
        return out, (top + torch.log(den))[..., 0].reshape(b, h, sq)
    return out


def flash_attention_bhsd_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, o: torch.Tensor,
                                 do: torch.Tensor, lse: torch.Tensor, *,
                                 causal: bool = True, window: int = 0,
                                 softcap: float = 0.0,
                                 q_offset: Offset = 0):
    """(dq, dk, dv) of :func:`flash_attention_bhsd_ref` from its output
    ``o``, its logsumexp ``lse`` (BH, Sq) and the output's gradient
    ``do``, in q's dtype; ``q_offset``: an int or (BH,)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qa, ka, va, oa, da = (t.to(acc) for t in (q, k, v, o, do))
    x = (qa @ ka.transpose(-1, -2)) * scale                   # bh q s
    if softcap and softcap > 0:
        t = torch.tanh(x / softcap)
        x = t * softcap
    mask = _mask(q.shape[1], k.shape[1], causal, window, q.device,
                 q_offset)
    p = torch.where(mask, torch.exp(x - lse.to(acc)[..., None]),
                    torch.zeros((), dtype=acc, device=q.device))
    delta = (da * oa).sum(dim=-1)                             # bh q
    dv = p.transpose(-1, -2) @ da
    # rows with no valid key: P uniform over the keys in the forward
    empty = ~mask.any(dim=-1, keepdim=True)                   # (…, q, 1)
    if bool(empty.any()):
        dv = dv + (empty.to(acc) * da).sum(dim=-2, keepdim=True) \
            / k.shape[1]
    ds = p * (da @ va.transpose(-1, -2) - delta[..., None])
    if softcap and softcap > 0:
        ds = ds * (1 - t * t)
    dq = (ds @ ka) * scale
    dk = (ds.transpose(-1, -2) @ qa) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
