"""Model assembly of the port: init, forward, prefill, decode — for the
dense family (every layer attention + MLP), as the reference's
``repro/models/transformer.py`` builds it.

Layer parameters are stacked over period instances (leading dim
``n_periods``), as in the reference, and :func:`forward` walks the
periods in a Python loop where the reference scans them (no remat, no
sharding constraints: the serving path on one card needs neither).
Caches are the reference's stacked pytrees and are written in place
(``common.apply_attn``). Mamba, xLSTM, MoE and encoder-decoder layers
wait for their slices (ROADMAP Queue 1, item 3) and raise
``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .common import (ArchConfig, KeyGen, _init, apply_attn, apply_mlp,
                     init_attn, init_mlp, mask_padded_vocab, rmsnorm,
                     softcap)

TP_DEFAULT = 16  # production mesh model-axis size (vocab/expert padding)


def _require_dense(cfg: ArchConfig) -> None:
    """Raise for what only the reference runs yet."""
    kinds = {cfg.layer_kind(i) for i in range(cfg.period)}
    moe = any(cfg.layer_is_moe(i) for i in range(cfg.period))
    if kinds != {"attn"} or moe or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense attention + MLP stacks; "
            f"layer kinds {sorted(kinds)}, MoE {moe}, enc-dec "
            f"{cfg.is_encdec} wait for their slices (ROADMAP Queue 1, "
            f"item 3)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(kg: KeyGen, cfg: ArchConfig) -> Tuple[Dict, Dict]:
    p: Dict = {}
    s: Dict = {}
    p["attn"], s["attn"] = init_attn(kg, cfg)
    if cfg.d_ff > 0:
        p["mlp"], s["mlp"] = init_mlp(kg, cfg)
    return p, s


def _stack(trees: List[Dict]) -> Dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def _stack_specs(s: Dict) -> Dict:
    return {k: _stack_specs(v) if isinstance(v, dict) else ("layers",) + v
            for k, v in s.items()}


def init_params(cfg: ArchConfig, gen: torch.Generator
                ) -> Tuple[Dict, Dict]:
    """Returns (params, specs) on ``gen``'s device. specs mirrors params
    with logical-axis tuples on every leaf."""
    _require_dense(cfg)
    kg = KeyGen(gen)
    vpad = cfg.padded_vocab(TP_DEFAULT)
    params: Dict = {
        # N(0, 1/d): unit-variance inputs after the sqrt(d) embed scaling
        # and modest logits when tied as the unembedding.
        "embed": _init(kg(), (vpad, cfg.d_model), cfg.dtype,
                       scale=1.0 / math.sqrt(cfg.d_model)),
        "final_ln": torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                device=gen.device),
    }
    specs: Dict = {
        "embed": ("vocab", "embed"),
        "final_ln": ("embed",),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = _init(kg(), (vpad, cfg.d_model), cfg.dtype,
                                  scale=1.0 / math.sqrt(cfg.d_model))
        specs["unembed"] = ("vocab", "embed")
    blocks, bspecs = [], []
    for _ in range(cfg.period):
        layers = [_init_layer(kg, cfg) for _ in range(cfg.n_periods)]
        blocks.append(_stack([p for p, _ in layers]))
        bspecs.append(_stack_specs(layers[0][1]))
    params["blocks"] = blocks
    specs["blocks"] = bspecs
    return params, specs


def params_from_reference(tree, cfg: ArchConfig, device) -> Dict:
    """The reference's params (``repro.models.transformer.init_params``),
    as a nested dict/list of numpy arrays, in the port's layout on
    ``device``: floating leaves in ``cfg.dtype`` (bf16 leaves travel as
    float32, which holds them exactly)."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, cfg, device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_reference(v, cfg, device) for v in tree]
    t = torch.from_numpy(np.ascontiguousarray(tree))
    if t.is_floating_point():
        t = t.to(cfg.dtype)
    return t.to(device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_layer(p, x, cfg: ArchConfig, idx_in_period: int, *, positions,
                 cache=None):
    window = cfg.layer_window(idx_in_period)
    x, kv = apply_attn(p["attn"], x, cfg, positions=positions,
                       window=window,
                       cache=None if cache is None else cache["kv"])
    if "mlp" in p:
        x = apply_mlp(p["mlp"], x, cfg)
    return x, None if kv is None else {"kv": kv}


def _period(tree, j: int):
    """Period instance ``j`` of a stacked tree: every leaf's j-th slice
    (a view, so writes land in the stacked tensor)."""
    return {k: _period(v, j) if isinstance(v, dict) else v[j]
            for k, v in tree.items()}


def forward(params, x, cfg: ArchConfig, *, positions, caches=None):
    """x: (B, S, D) embeddings. caches: list per idx_in_period of stacked
    cache pytrees (leading dim n_periods) or None; they are updated in
    place. Returns (x, caches)."""
    _require_dense(cfg)
    blocks = params["blocks"]
    for j in range(cfg.n_periods):
        for i in range(cfg.period):
            cache = None if caches is None else _period(caches[i], j)
            x, nc = _apply_layer(_period(blocks[i], j), x, cfg, i,
                                 positions=positions, cache=cache)
            if caches is not None:
                caches[i]["kv"]["index"][j] = nc["kv"]["index"]
    return x, caches


def embed_tokens(params, tokens, cfg: ArchConfig):
    return params["embed"][tokens] * torch.tensor(
        math.sqrt(cfg.d_model), dtype=cfg.dtype)


def _unembed(params):
    return params.get("unembed", params["embed"])


# ---------------------------------------------------------------------------
# Top-level steps (prefill / decode)
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, max_seq: int,
                uniform_index: bool = False, device="cpu"):
    """Stacked decode caches: list per idx_in_period.
    ``uniform_index`` → scalar per-layer position (steady-state decode)
    instead of per-slot positions (continuous batching)."""
    _require_dense(cfg)
    caches = []
    for _ in range(cfg.period):
        shape = (cfg.n_periods, batch, max_seq, cfg.kv_heads, cfg.head_dim)
        idx_shape = (cfg.n_periods,) if uniform_index \
            else (cfg.n_periods, batch)
        caches.append({"kv": {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "index": torch.zeros(idx_shape, dtype=torch.int32,
                                 device=device)}})
    return caches


def _input(params, batch, cfg: ArchConfig):
    if cfg.embeds_input and "embeds" in batch:
        return batch["embeds"].to(cfg.dtype)
    return embed_tokens(params, batch["tokens"], cfg)


def prefill(params, batch, cfg: ArchConfig, max_seq: int):
    """Run the prompt through the model, filling caches.
    Returns (caches, last_token_logits). As in the reference, these
    logits take no final softcap (decode's do); the argmax is the same."""
    x = _input(params, batch, cfg)
    b, s = x.shape[0], x.shape[1]
    caches = init_caches(cfg, b, max_seq, device=x.device)
    positions = torch.arange(s, device=x.device)
    x, caches = forward(params, x, cfg, positions=positions, caches=caches)
    x = rmsnorm(x[:, -1:], params["final_ln"], cfg.norm_eps)
    logits = mask_padded_vocab(
        torch.einsum("btd,vd->btv", x, _unembed(params)), cfg.vocab)[:, 0]
    return caches, logits


def decode_step(params, tokens, caches, cfg: ArchConfig):
    """One decode step. tokens: (B, 1) int. Returns (logits, caches)."""
    x = embed_tokens(params, tokens, cfg)
    # position from the first attention cache's index (all layers share)
    pos0 = caches[0]["kv"]["index"][0]
    steps = torch.arange(x.shape[1], device=x.device)
    if pos0.dim() == 0:  # uniform decode position
        positions = pos0 + steps
    else:
        positions = pos0[:, None] + steps[None, :]
    x, caches = forward(params, x, cfg, positions=positions, caches=caches)
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = torch.einsum("btd,vd->btv", x, _unembed(params))
    logits = mask_padded_vocab(softcap(logits, cfg.logit_softcap),
                               cfg.vocab)[:, 0]
    return logits, caches
