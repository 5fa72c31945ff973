"""Mixture-of-Experts FFN with token-choice top-k routing, in PyTorch.

The reference's ``repro/models/moe.py``: the sort-free capacity scheme.
Per-token expert assignments are flattened, positions within each expert
computed by a cumulative sum over the (tokens·topk, experts) one-hot, so
earlier tokens come first and, within a token, its higher top-k weight;
tokens beyond an expert's capacity are dropped; activations are
scattered into an (experts·capacity, d) buffer that is batch-multiplied
against the stacked expert weights. Every token of the batch competes
for capacity, the free slots' tokens of a serving decode step too, as
in the reference. Experts are padded up to a multiple of 16 (qwen2-moe:
60 → 64), with the router logits of padded experts masked to -1e30.

What changes against the reference: the scatter is ``index_add_`` into
an (E·cap + 1, D) buffer whose last row takes the dropped tokens and is
discarded (the reference's ``.at[slot].add``); the expert products are
``torch.bmm`` (plain products outside any kernel, as the reference left
them to XLA); ``_anchor`` (a sharding constraint) is gone, since nothing
is sharded on one card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import ArchConfig, KeyGen, _act, _init, _zeros, rmsnorm


def padded_experts(cfg: ArchConfig, tp: int = 16) -> int:
    e = cfg.n_experts
    return ((e + tp - 1) // tp) * tp


def init_moe(kg: KeyGen, cfg: ArchConfig, tp: int = 16,
             experts: bool = True) -> Tuple[Dict, Dict]:
    """The layer's params and specs; ``experts=False`` leaves out the
    routed experts' weights (``wi``, ``wg``, ``wo``), which the caller
    then shares from another layer."""
    d = cfg.d_model
    f = cfg.expert_d_ff or cfg.d_ff
    e_pad = padded_experts(cfg, tp)
    gated = cfg.mlp_act in ("silu", "gelu")
    p = {"router": _init(kg(), (d, e_pad), torch.float32),
         "ln": _zeros(kg, (d,), cfg.dtype)}
    s = {"router": ("embed", "experts"),
         "wi": ("experts", "embed", "mlp"),
         "wo": ("experts", "mlp", "embed"),
         "ln": ("embed",)}
    if experts:
        p["wi"] = _init(kg(), (e_pad, d, f), cfg.dtype)
        p["wo"] = _init(kg(), (e_pad, f, d), cfg.dtype)
    if gated:
        s["wg"] = ("experts", "embed", "mlp")
        if experts:
            p["wg"] = _init(kg(), (e_pad, d, f), cfg.dtype)
    if cfg.n_shared_experts:
        p["shared_wi"] = _init(kg(), (d, f * cfg.n_shared_experts),
                               cfg.dtype)
        p["shared_wo"] = _init(kg(), (f * cfg.n_shared_experts, d),
                               cfg.dtype)
        s["shared_wi"] = ("embed", "mlp")
        s["shared_wo"] = ("mlp", "embed")
        if gated:
            p["shared_wg"] = _init(kg(), (d, f * cfg.n_shared_experts),
                                   cfg.dtype)
            s["shared_wg"] = ("embed", "mlp")
    return p, s


def route(p, ht, cfg: ArchConfig):
    """(weights, slot, cap) for the tokens ``ht`` (T, D): each token's
    top-k softmax weights (T, K) in ``ht``'s dtype, and each of its T·K
    assignments' row of the (E·cap + 1, D) dispatch buffer (expert ·
    cap + position within the expert, or the last row, E·cap, for one
    past the expert's capacity ``cap``: dropped)."""
    e_pad = p["router"].shape[1]
    logits = ht.float() @ p["router"]                       # (T, E)
    if e_pad != cfg.n_experts:
        pad = torch.arange(e_pad, device=ht.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    weights, expert_ids = torch.topk(logits, cfg.experts_topk, dim=-1)
    weights = torch.softmax(weights, dim=-1).to(ht.dtype)  # (T, K)

    # --- capacity + position within expert -----------------------------
    # (a decode step of 4 slots gives olmoe one slot an expert)
    cap = int(max(1, (ht.shape[0] * cfg.experts_topk // e_pad)
                  * cfg.capacity_factor))
    flat_e = expert_ids.reshape(-1)                         # (T*K,)
    onehot = F.one_hot(flat_e, e_pad)                       # (T*K, E)
    pos = (onehot.cumsum(0) - 1).gather(1, flat_e[:, None])[:, 0]
    slot = torch.where(pos < cap, flat_e * cap + pos,
                       torch.full_like(pos, e_pad * cap))   # overflow row
    return weights, slot, cap


def apply_moe(p, x, cfg: ArchConfig):
    """x: (B, S, D) → (B, S, D) residual-added."""
    b, s, d = x.shape
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    t = b * s
    ht = h.reshape(t, d)
    e_pad = p["router"].shape[1]
    k = cfg.experts_topk
    act = _act(cfg.mlp_act)
    weights, slot, cap = route(p, ht, cfg)

    # --- dispatch -------------------------------------------------------
    xe = ht.repeat_interleave(k, dim=0)                     # (T*K, D)
    buf = torch.zeros((e_pad * cap + 1, d), dtype=x.dtype,
                      device=x.device).index_add_(0, slot, xe)
    buf = buf[:-1].reshape(e_pad, cap, d)

    # --- expert computation (batched over experts) -----------------------
    up = torch.bmm(buf, p["wi"])                            # (E, C, F)
    if "wg" in p:
        up = act(torch.bmm(buf, p["wg"])) * up
    else:
        up = act(up)
    out = torch.bmm(up, p["wo"])                            # (E, C, D)

    # --- combine ----------------------------------------------------------
    out_flat = torch.cat([out.reshape(e_pad * cap, d),
                          out.new_zeros((1, d))])
    gathered = out_flat[slot] * weights.reshape(-1)[:, None]  # (T*K, D)
    y = gathered.reshape(t, k, d).sum(dim=1)

    # --- shared experts (dense) -------------------------------------------
    if "shared_wi" in p:
        up_s = ht @ p["shared_wi"]
        if "shared_wg" in p:
            up_s = act(ht @ p["shared_wg"]) * up_s
        else:
            up_s = act(up_s)
        y = y + up_s @ p["shared_wo"]

    return x + y.reshape(b, s, d).to(x.dtype)
