"""Model assembly of the port: init, forward, prefill, decode — for the
dense, MoE, hybrid (Jamba: attention + Mamba) and ssm (xLSTM: mLSTM +
sLSTM) families, as the reference's ``repro/models/transformer.py``
builds them.

Each layer = mixer (attn | mamba | mlstm | slstm) + optional FFN (dense
MLP | MoE). Layer parameters are stacked over period instances (leading
dim ``n_periods``), as in the reference, and :func:`forward` walks the
periods in a Python loop where the reference scans them (no remat, no
sharding constraints: the serving path on one card needs neither).
Caches are the reference's stacked pytrees and are written in place
(``common.apply_attn`` for KV; the recurrent states are copied into
theirs). A prefill's recurrent layers hand their state after the prompt
to decode (``models/ssm.py``; the reference's took a single-token branch
over the prompt). Encoder-decoder models wait for their slice (ROADMAP
Queue 1, item 3) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import moe as moe_mod
from . import ssm as ssm_mod
from .common import (ArchConfig, KeyGen, _init, apply_attn, apply_mlp,
                     init_attn, init_mlp, mask_padded_vocab, rmsnorm,
                     softcap)

TP_DEFAULT = 16  # production mesh model-axis size (vocab/expert padding)

# leaves the reference keeps in float32 whatever the model's dtype
F32_LEAVES = ("router", "dt_bias", "a_log", "d_skip")

_MIXERS = {"mamba": ssm_mod.apply_mamba, "mlstm": ssm_mod.apply_mlstm,
           "slstm": ssm_mod.apply_slstm}


def _require_supported(cfg: ArchConfig) -> None:
    """Raise for what only the reference runs yet."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the port runs decoder-only stacks; "
            f"encoder-decoder models wait for their slice (ROADMAP Queue "
            f"1, item 3)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(kg: KeyGen, cfg: ArchConfig, idx_in_period: int,
                experts: bool = True) -> Tuple[Dict, Dict]:
    """One layer's params and specs; ``experts=False`` leaves a MoE
    layer's routed experts out (see :func:`init_params`)."""
    kind = cfg.layer_kind(idx_in_period)
    p: Dict = {}
    s: Dict = {}
    init = {"attn": init_attn, "mamba": ssm_mod.init_mamba,
            "mlstm": ssm_mod.init_mlstm, "slstm": ssm_mod.init_slstm}[kind]
    p[kind], s[kind] = init(kg, cfg)
    if cfg.layer_is_moe(idx_in_period):
        p["moe"], s["moe"] = moe_mod.init_moe(kg, cfg, TP_DEFAULT, experts)
    elif cfg.d_ff > 0:
        p["mlp"], s["mlp"] = init_mlp(kg, cfg)
    return p, s


def _stack(trees: List[Dict]) -> Dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def _stack_specs(s: Dict) -> Dict:
    return {k: _stack_specs(v) if isinstance(v, dict) else ("layers",) + v
            for k, v in s.items()}


def init_params(cfg: ArchConfig, gen: torch.Generator,
                share_experts: bool = False) -> Tuple[Dict, Dict]:
    """Returns (params, specs) on ``gen``'s device. specs mirrors params
    with logical-axis tuples on every leaf. With ``share_experts`` the
    MoE layers of a period hold its first MoE layer's routed experts
    (``wi``, ``wg``, ``wo``: the same tensors; each layer's router, norm
    and shared experts are its own): a cut that fits a model's full
    width on one card, each layer still computing at that width."""
    _require_supported(cfg)
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
    shared = None
    for i in range(cfg.period):
        own = shared is None or not cfg.layer_is_moe(i)
        layers = [_init_layer(kg, cfg, i, own)
                  for _ in range(cfg.n_periods)]
        block = _stack([p for p, _ in layers])
        if cfg.layer_is_moe(i) and share_experts:
            if shared is None:
                shared = {w: block["moe"][w] for w in ("wi", "wg", "wo")
                          if w in block["moe"]}
            block["moe"].update(shared)
        blocks.append(block)
        bspecs.append(_stack_specs(layers[0][1]))
    params["blocks"] = blocks
    specs["blocks"] = bspecs
    return params, specs


def params_from_reference(tree, cfg: ArchConfig, device,
                          name: str = "") -> Dict:
    """The reference's params (``repro.models.transformer.init_params``),
    as a nested dict/list of numpy arrays, in the port's layout on
    ``device``: floating leaves in ``cfg.dtype`` but those the reference
    keeps in float32 (:data:`F32_LEAVES`: the router, Mamba's
    ``dt_bias``, ``a_log`` and ``d_skip``); bf16 leaves travel as
    float32, which holds them exactly. ``name`` is the leaf's key."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, cfg, device, k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_reference(v, cfg, device) for v in tree]
    t = torch.from_numpy(np.ascontiguousarray(tree))
    if t.is_floating_point():
        t = t.to(torch.float32 if name in F32_LEAVES else cfg.dtype)
    return t.to(device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_layer(p, x, cfg: ArchConfig, idx_in_period: int, *, positions,
                 cache=None):
    kind = cfg.layer_kind(idx_in_period)
    if kind == "attn":
        window = cfg.layer_window(idx_in_period)
        x, kv = apply_attn(p["attn"], x, cfg, positions=positions,
                           window=window,
                           cache=None if cache is None else cache["kv"])
        new_cache = None if kv is None else {"kv": kv}
    else:
        x, st = _MIXERS[kind](p[kind], x, cfg,
                              None if cache is None else cache["ssm"])
        new_cache = None if st is None else {"ssm": st}
    if "moe" in p:
        x = moe_mod.apply_moe(p["moe"], x, cfg)
    elif "mlp" in p:
        x = apply_mlp(p["mlp"], x, cfg)
    return x, new_cache


def _period(tree, j: int):
    """Period instance ``j`` of a stacked tree: every leaf's j-th slice
    (a view, so writes land in the stacked tensor)."""
    return {k: _period(v, j) if isinstance(v, dict) else v[j]
            for k, v in tree.items()}


def forward(params, x, cfg: ArchConfig, *, positions, caches=None):
    """x: (B, S, D) embeddings. caches: list per idx_in_period of stacked
    cache pytrees (leading dim n_periods) or None; they are updated in
    place. Returns (x, caches)."""
    _require_supported(cfg)
    blocks = params["blocks"]
    for j in range(cfg.n_periods):
        for i in range(cfg.period):
            cache = None if caches is None else _period(caches[i], j)
            x, nc = _apply_layer(_period(blocks[i], j), x, cfg, i,
                                 positions=positions, cache=cache)
            if caches is None:
                continue
            if "kv" in nc:         # k and v are already written in place
                caches[i]["kv"]["index"][j] = nc["kv"]["index"]
            else:
                for name, st in nc["ssm"].items():
                    caches[i]["ssm"][name][j] = st
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
    _require_supported(cfg)
    caches = []
    for i in range(cfg.period):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            shape = (cfg.n_periods, batch, max_seq, cfg.kv_heads,
                     cfg.head_dim)
            idx_shape = (cfg.n_periods,) if uniform_index \
                else (cfg.n_periods, batch)
            caches.append({"kv": {
                "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "index": torch.zeros(idx_shape, dtype=torch.int32,
                                     device=device)}})
            continue
        if kind == "mamba":
            st = ssm_mod.init_mamba_state(cfg, batch, device)
        else:
            st = ssm_mod.init_xlstm_state(cfg, kind, batch, device)
        # one state per period instance, written in place
        caches.append({"ssm": {
            name: a[None].repeat((cfg.n_periods,) + (1,) * a.dim())
            for name, a in st.items()}})
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
    # position from the first attention cache's index (all layers share
    # it); a stack without attention (xLSTM) has none: zeros, as in the
    # reference
    pos0 = next((c["kv"]["index"][0] for c in caches if "kv" in c), None)
    if pos0 is None:
        pos0 = torch.zeros((x.shape[0],), dtype=torch.int32,
                           device=x.device)
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
