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
them to XLA). On DTensors (the dry run, a sharded step) the routing,
the dispatch and the combine run on every rank alike over the whole
batch (``common.on_replicas``: an expert's capacity is shared by every
token of the batch, as in the reference), and the dispatch buffer and
the experts' output are anchored to the planner's expert and capacity
axes (``common.anchor``, the reference's ``_anchor``), so that the
expert products run sharded; plain tensors take none of this.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import (ArchConfig, KeyGen, _act, _init, _zeros, anchor,
                     gathered, on_replicas, product, rmsnorm)


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


def capacity(cfg: ArchConfig, tokens: int, e_pad: int) -> int:
    """Each expert's capacity for a batch of ``tokens`` (a decode step
    of 4 slots gives olmoe one slot an expert)."""
    return int(max(1, (tokens * cfg.experts_topk // e_pad)
                   * cfg.capacity_factor))


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
    cap = capacity(cfg, ht.shape[0], e_pad)
    flat_e = expert_ids.reshape(-1)                         # (T*K,)
    onehot = F.one_hot(flat_e, e_pad)                       # (T*K, E)
    pos = (onehot.cumsum(0) - 1).gather(1, flat_e[:, None])[:, 0]
    slot = torch.where(pos < cap, flat_e * cap + pos,
                       torch.full_like(pos, e_pad * cap))   # overflow row
    return weights, slot, cap


def _dispatch(ht, slot, e_pad: int, cap: int, k: int):
    """The (E, cap, D) buffer of each expert's tokens."""
    t, d = ht.shape
    xe = ht.repeat_interleave(k, dim=0)                     # (T*K, D)
    buf = torch.zeros((e_pad * cap + 1, d), dtype=ht.dtype,
                      device=ht.device).index_add_(0, slot, xe)
    return buf[:-1].reshape(e_pad, cap, d)


def _combine(out, slot, weights, k: int):
    """Each token's experts' outputs, weighted and summed: (T, D)."""
    e_pad, cap, d = out.shape
    out_flat = torch.cat([out.reshape(e_pad * cap, d),
                          out.new_zeros((1, d))])
    gathered = out_flat[slot] * weights.reshape(-1)[:, None]  # (T*K, D)
    return gathered.reshape(-1, k, d).sum(dim=1)


def _anchor(t, cfg: ArchConfig):
    """Pin (expert, capacity) dims to the planner's axes and the features
    whole (DTensors only): without it the expert products can stay
    replicated over idle mesh axes. The capacity dim takes the axes the
    expert count cannot cover. Where the capacity does not split over
    them (a decode step's few tokens), the weights stay sharded over
    those axes: the first products' partial sums are summed here, and
    the last one's features gathered."""
    if not cfg.moe_expert_axes:
        return t
    return anchor(t, (tuple(cfg.moe_expert_axes),
                      tuple(cfg.moe_capacity_axes or ()))
                  + ((),) * (t.dim() - 2))


def apply_moe(p, x, cfg: ArchConfig):
    """x: (B, S, D) → (B, S, D) residual-added."""
    b, s, d = x.shape
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    t = b * s
    ht = h.reshape(t, d)
    e_pad = p["router"].shape[1]
    k = cfg.experts_topk
    act = _act(cfg.mlp_act)
    cap = capacity(cfg, t, e_pad)
    weights, slot = on_replicas(
        lambda h_, r: route({"router": r}, h_, cfg)[:2], 2, ht, p["router"])

    # --- dispatch -------------------------------------------------------
    buf = _anchor(on_replicas(
        lambda h_, s_: _dispatch(h_, s_, e_pad, cap, k), 1, ht, slot), cfg)

    # --- expert computation (batched over experts) -----------------------
    # (each expert's weights gathered over the capacity's mesh dims)
    up = _anchor(torch.bmm(buf, gathered(p["wi"], buf, (1,))), cfg)
    if "wg" in p:
        up = act(_anchor(torch.bmm(buf, gathered(p["wg"], buf, (1,))),
                         cfg)) * up                         # (E, C, F)
    else:
        up = act(up)
    out = _anchor(torch.bmm(up, gathered(p["wo"], up, (1,))), cfg)

    # --- combine ----------------------------------------------------------
    y = on_replicas(lambda o, s_, w: _combine(o, s_, w, k), 1, out, slot,
                    weights)

    y = y.reshape(b, s, d)

    # --- shared experts (dense; on (B, S, D): a DTensor's tokens flattened
    # over two mesh dims would not reshape back) --------------------------
    if "shared_wi" in p:
        up_s = product("bsd,df->bsf", h, p["shared_wi"], torch.matmul)
        if "shared_wg" in p:
            up_s = act(product("bsd,df->bsf", h, p["shared_wg"],
                               torch.matmul)) * up_s
        else:
            up_s = act(up_s)
        y = y + product("bsf,fd->bsd", up_s, p["shared_wo"], torch.matmul)

    return x + y.to(x.dtype)
