"""Model assembly of the port: init, forward, loss, prefill, decode —
for every family of the reference's ``repro/models/transformer.py``:
dense, MoE, hybrid (Jamba: attention + Mamba), ssm (xLSTM: mLSTM +
sLSTM), encoder-decoder (seamless: a non-causal encoder, cross attention
in every decoder layer) and the frontend stubs (inputs given as
embeddings: llava's patches, seamless's audio frames).

Each layer = mixer (attn | mamba | mlstm | slstm) + optional cross
attention + optional FFN (dense MLP | MoE). Layer parameters are stacked
over period instances (leading dim ``n_periods``), as in the reference,
and :func:`forward` walks the periods in a Python loop where the
reference scans them. On DTensors each period's input and output is
anchored to the planner's activation axes (:func:`_anchor_acts`, the
reference's ``seq_constraint``); a plain tensor passes unchanged.
``cfg.remat`` "full" checkpoints each period (and each encoder layer)
with ``torch.utils.checkpoint`` (non-reentrant) when a gradient is
asked for: the backward runs its forward again. "dots" (nemotron's:
the reference keeps the products' outputs) takes the same path here.
Caches are the reference's stacked pytrees and are written in place
(``common.apply_attn`` for KV; the recurrent states and the cross
attention's keys and values are copied into theirs). A prefill's
recurrent layers hand their state after the prompt to decode
(``models/ssm.py``; the reference's took a single-token branch over the
prompt). The encoder's self attention and the cross attention run
through the flash op, not causal: softcap 0 in the encoder (the
reference's ``plain_attention(q, k, v, causal=False)``), the model's in
cross attention; the cross query is roped, the keys taken from the
encoder's output are not.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from . import moe as moe_mod
from . import ssm as ssm_mod
from ..kernels.flash_attention import ops as flash_ops
from ..kernels.sharded import is_dtensor, remap
from .common import (ArchConfig, KeyGen, _init, anchor, apply_attn,
                     apply_mlp, cross_kv_from_encoder, gathered, heads_proj,
                     init_attn, init_mlp, lm_head_loss, lookup,
                     mask_padded_vocab, out_proj, product, rmsnorm, rope,
                     softcap)

TP_DEFAULT = 16  # production mesh model-axis size (vocab/expert padding)

# leaves the reference keeps in float32 whatever the model's dtype
F32_LEAVES = ("router", "dt_bias", "a_log", "d_skip")

_MIXERS = {"mamba": ssm_mod.apply_mamba, "mlstm": ssm_mod.apply_mlstm,
           "slstm": ssm_mod.apply_slstm}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(kg: KeyGen, cfg: ArchConfig, idx_in_period: int,
                experts: bool = True, with_cross: bool = False,
                expert_multiple: int = TP_DEFAULT) -> Tuple[Dict, Dict]:
    """One layer's params and specs; ``experts=False`` leaves a MoE
    layer's routed experts out (see :func:`init_params`);
    ``with_cross`` adds cross attention (an enc-dec decoder layer);
    routed experts padded to a multiple of ``expert_multiple``."""
    kind = cfg.layer_kind(idx_in_period)
    p: Dict = {}
    s: Dict = {}
    init = {"attn": init_attn, "mamba": ssm_mod.init_mamba,
            "mlstm": ssm_mod.init_mlstm, "slstm": ssm_mod.init_slstm}[kind]
    p[kind], s[kind] = init(kg, cfg)
    if with_cross:
        p["cross"], s["cross"] = init_attn(kg, cfg)
    if cfg.layer_is_moe(idx_in_period):
        p["moe"], s["moe"] = moe_mod.init_moe(kg, cfg, expert_multiple,
                                              experts)
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
                share_experts: bool = False,
                expert_multiple: int = TP_DEFAULT) -> Tuple[Dict, Dict]:
    """Returns (params, specs) on ``gen``'s device. specs mirrors params
    with logical-axis tuples on every leaf. With ``share_experts`` the
    MoE layers of a period hold its first MoE layer's routed experts
    (``wi``, ``wg``, ``wo``: the same tensors; each layer's router, norm
    and shared experts are its own): a cut that fits a model's full
    width on one card, each layer still computing at that width (and,
    tied, a training step sums their gradient over the layers:
    ``train/tree.py``). The routed experts are padded to a multiple of
    ``expert_multiple``: the production mesh's model axis (TP_DEFAULT),
    as the reference pads them, or 1 on one card, which has no such
    axis (padded experts are never routed to, but they hold weights and
    make each expert's capacity smaller). An enc-dec model adds cross
    attention to each decoder layer, an ``encoder`` stack of
    ``cfg.enc_layers`` attention + MLP layers and ``enc_final_ln``, as
    the reference's."""
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
        layers = [_init_layer(kg, cfg, i, own, cfg.is_encdec,
                              expert_multiple)
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
    if cfg.is_encdec:
        layers = [_init_layer(kg, cfg, 0) for _ in range(cfg.enc_layers)]
        params["encoder"] = _stack([p for p, _ in layers])
        specs["encoder"] = _stack_specs(layers[0][1])
        params["enc_final_ln"] = torch.zeros(
            (cfg.d_model,), dtype=cfg.dtype, device=gen.device)
        specs["enc_final_ln"] = ("embed",)
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
                 cache=None, enc_out=None):
    kind = cfg.layer_kind(idx_in_period)
    x = _anchor_tokens(x, cfg)
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
    if "cross" in p:
        if enc_out is not None:
            ckv = cross_kv_from_encoder(p["cross"], enc_out, cfg)
        elif cache is not None and "cross_kv" in cache:
            ckv = cache["cross_kv"]
        else:
            ckv = None
        if ckv is not None:
            x, _ = apply_attn(p["cross"], x, cfg, positions=positions,
                              cross_kv=ckv)
            if new_cache is not None and enc_out is not None:
                new_cache["cross_kv"] = ckv      # new: stored by forward
    if "moe" in p:
        x = moe_mod.apply_moe(p["moe"], _anchor_tokens(x, cfg), cfg)
    elif "mlp" in p:
        x = apply_mlp(p["mlp"], _anchor_tokens(x, cfg), cfg)
    return x, new_cache


def _period(tree, j: int):
    """Period instance ``j`` of a stacked tree: every leaf's j-th slice
    (a view, so writes land in the stacked tensor); a tuple (the cross
    attention's keys and values) slices each of its tensors."""
    if isinstance(tree, tuple):
        return tuple(t[j] for t in tree)
    return {k: _period(v, j) if isinstance(v, (dict, tuple)) else v[j]
            for k, v in tree.items()}


def _remat(cfg: ArchConfig) -> bool:
    """Whether a forward checkpoints its periods: remat asked for by the
    config and a gradient by the caller."""
    return cfg.remat in ("full", "dots") and torch.is_grad_enabled()


def _store_cross_kv(cache, ckv, j: int, n: int) -> None:
    """Write period ``j``'s cross keys and values into the stacked slot
    of ``cache`` (allocated, for ``n`` periods, where it is missing or
    of another source length)."""
    slot = cache.get("cross_kv")
    if slot is None or slot[0].shape[1:] != ckv[0].shape:
        slot = tuple(t.new_zeros((n,) + tuple(t.shape)) for t in ckv)
        cache["cross_kv"] = slot
    for dst, src in zip(slot, ckv):
        dst[j] = src


def _anchor_acts(x, cfg: ArchConfig):
    """Activation anchoring between periods (DTensors only): the batch
    dim pinned to the planner's axes, and optionally seq → model
    (sequence-parallel residual stream) so that remat checkpoints shard
    over the TP degree."""
    want_seq = cfg.seq_shard and x.shape[1] % 16 == 0
    if not want_seq and not cfg.act_batch_axes:
        return x
    b_spec = tuple(cfg.act_batch_axes or ())
    s_spec = "model" if want_seq and "model" not in b_spec else None
    return anchor(x, (b_spec, s_spec, None))


def _anchor_tokens(x, cfg: ArchConfig):
    """A mixer's or FFN's input (DTensors only): the batch dim on the
    planner's axes, the sequence whole on every rank (gathered where
    the residual stream was sequence-sharded, as sequence parallelism
    gathers before its column-parallel products) and the features whole
    (a row-parallel product's partial sum summed). DTensor flattens
    (batch, seq) into a product's rows; with both sharded, over two
    mesh dims, the flattened rows' sharding is one its matrix products
    cannot take."""
    return anchor(x, (tuple(cfg.act_batch_axes or ()), (), ()))


def forward(params, x, cfg: ArchConfig, *, positions, caches=None,
            enc_out=None):
    """x: (B, S, D) embeddings. caches: list per idx_in_period of stacked
    cache pytrees (leading dim n_periods) or None; they are updated in
    place. enc_out: the encoder's output (enc-dec). Returns (x,
    caches)."""
    blocks = params["blocks"]

    def period(x, j):
        x = _anchor_acts(x, cfg)
        for i in range(cfg.period):
            x, _ = _apply_layer(_period(blocks[i], j), x, cfg, i,
                                positions=positions, enc_out=enc_out)
        return _anchor_acts(x, cfg)

    for j in range(cfg.n_periods):
        if caches is None:
            x = torch.utils.checkpoint.checkpoint(
                period, x, j, use_reentrant=False) if _remat(cfg) \
                else period(x, j)
            continue
        x = _anchor_acts(x, cfg)
        for i in range(cfg.period):
            x, nc = _apply_layer(_period(blocks[i], j), x, cfg, i,
                                 positions=positions,
                                 cache=_period(caches[i], j),
                                 enc_out=enc_out)
            if "kv" in nc:         # k and v are already written in place
                caches[i]["kv"]["index"][j] = nc["kv"]["index"]
            else:
                for name, st in nc["ssm"].items():
                    caches[i]["ssm"][name][j] = st
            if "cross_kv" in nc:
                _store_cross_kv(caches[i], nc["cross_kv"], j, cfg.n_periods)
        x = _anchor_acts(x, cfg)
    return x, caches


def encode(params, src_embeds, cfg: ArchConfig):
    """Encoder stack (non-causal attention, no softcap) for enc-dec
    archs. On DTensors each layer's input and output is anchored as the
    decoder's periods are, and its attention's and MLP's inputs as the
    decoder's layers' (:func:`_anchor_tokens`; the reference's encoder
    scan has no constraint)."""
    enc = params["encoder"]
    positions = torch.arange(src_embeds.shape[1], device=src_embeds.device)

    def layer(x, j):
        bp = _period(enc, j)
        x = _anchor_tokens(_anchor_acts(x, cfg), cfg)
        h = rmsnorm(x, bp["attn"]["ln"], cfg.norm_eps)
        q = heads_proj(h, bp["attn"]["wq"])
        k = heads_proj(h, bp["attn"]["wk"])
        v = heads_proj(h, bp["attn"]["wv"])
        if cfg.qkv_bias:
            q, k, v = (t + gathered(bp["attn"][b], t, (0, 1))
                       for t, b in ((q, "bq"), (k, "bk"), (v, "bv")))
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        out = flash_ops.flash_attention(q, k, v, causal=False, window=0,
                                        softcap=0.0)
        x = x + out_proj(out, bp["attn"]["wo"]).to(x.dtype)
        return _anchor_acts(apply_mlp(bp["mlp"], _anchor_tokens(x, cfg),
                                      cfg), cfg)

    x = src_embeds
    for j in range(cfg.enc_layers):
        x = torch.utils.checkpoint.checkpoint(
            layer, x, j, use_reentrant=False) if _remat(cfg) \
            else layer(x, j)
    return rmsnorm(x, params["enc_final_ln"], cfg.norm_eps)


def embed_tokens(params, tokens, cfg: ArchConfig):
    return lookup(params["embed"], tokens) * torch.tensor(
        math.sqrt(cfg.d_model), dtype=cfg.dtype)


def _unembed(params):
    return params.get("unembed", params["embed"])


def _logits(params, x):
    """(B, T, Vpad) logits of the final norm's output ``x``."""
    return product("btd,vd->btv", x, _unembed(params))


# ---------------------------------------------------------------------------
# Top-level steps (loss / prefill / decode)
# ---------------------------------------------------------------------------

def _input(params, batch, cfg: ArchConfig):
    if cfg.embeds_input and "embeds" in batch:
        return batch["embeds"].to(cfg.dtype)
    return embed_tokens(params, batch["tokens"], cfg)


def _encoded(params, batch, cfg: ArchConfig):
    return encode(params, batch["src_embeds"].to(cfg.dtype), cfg) \
        if cfg.is_encdec else None


def loss_fn(params, batch, cfg: ArchConfig):
    """batch: {'tokens' or 'embeds', 'labels', optional 'src_embeds'}."""
    x = _input(params, batch, cfg)
    enc_out = _encoded(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = forward(params, x, cfg, positions=positions, enc_out=enc_out)
    return lm_head_loss(params, x, batch["labels"], cfg,
                        cfg.padded_vocab(TP_DEFAULT))


def init_caches(cfg: ArchConfig, batch: int, max_seq: int,
                cross_len: int = 0, uniform_index: bool = False,
                device="cpu"):
    """Stacked decode caches: list per idx_in_period. ``cross_len`` > 0
    adds encoder cross-KV slots (enc-dec decode entry point).
    ``uniform_index`` → scalar per-layer position (steady-state decode)
    instead of per-slot positions (continuous batching)."""
    caches = []
    for i in range(cfg.period):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            shape = (cfg.n_periods, batch, max_seq, cfg.kv_heads,
                     cfg.head_dim)
            idx_shape = (cfg.n_periods,) if uniform_index \
                else (cfg.n_periods, batch)
            c = {"kv": {
                "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "index": torch.zeros(idx_shape, dtype=torch.int32,
                                     device=device)}}
        else:
            if kind == "mamba":
                st = ssm_mod.init_mamba_state(cfg, batch, device)
            else:
                st = ssm_mod.init_xlstm_state(cfg, kind, batch, device)
            # one state per period instance, written in place
            c = {"ssm": {
                name: a[None].repeat((cfg.n_periods,) + (1,) * a.dim())
                for name, a in st.items()}}
        if cfg.is_encdec and cross_len > 0:
            shape = (cfg.n_periods, batch, cross_len, cfg.kv_heads,
                     cfg.head_dim)
            c["cross_kv"] = tuple(torch.zeros(shape, dtype=cfg.dtype,
                                              device=device)
                                  for _ in range(2))
        caches.append(c)
    return caches


def _sharded_like(caches, x):
    """Where ``x`` is a DTensor, the caches as DTensors with their batch
    dim (1) sharded as ``x``'s batch dim, the rest replicated; else the
    caches as they are."""
    if not is_dtensor(x):
        return caches
    from torch.distributed.tensor import distribute_tensor

    mesh = x.device_mesh
    rows = remap(x.placements, {0: 1})

    def place(t):
        if isinstance(t, dict):
            return {k: place(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(place(v) for v in t)
        return distribute_tensor(t, mesh, rows if t.dim() > 1
                                 else remap(x.placements, {}))

    return place(caches)


def prefill(params, batch, cfg: ArchConfig, max_seq: int):
    """Run the prompt through the model, filling caches.
    Returns (caches, last_token_logits). As in the reference, these
    logits take no final softcap (decode's do); the argmax is the same."""
    x = _input(params, batch, cfg)
    b, s = x.shape[0], x.shape[1]
    enc_out = _encoded(params, batch, cfg)
    caches = _sharded_like(init_caches(cfg, b, max_seq, device=x.device), x)
    positions = torch.arange(s, device=x.device)
    x, caches = forward(params, x, cfg, positions=positions, caches=caches,
                        enc_out=enc_out)
    x = rmsnorm(x[:, -1:], params["final_ln"], cfg.norm_eps)
    logits = mask_padded_vocab(_logits(params, x), cfg.vocab)[:, 0]
    return caches, logits


def decode_step(params, tokens, caches, cfg: ArchConfig, *, enc_out=None):
    """One decode step. tokens: (B, 1) int. Returns (logits, caches). An
    enc-dec model takes its cross keys and values from ``enc_out`` or,
    without it, from the caches (as prefill left them)."""
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
    x, caches = forward(params, x, cfg, positions=positions, caches=caches,
                        enc_out=enc_out)
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = _logits(params, x)
    logits = mask_padded_vocab(softcap(logits, cfg.logit_softcap),
                               cfg.vocab)[:, 0]
    return logits, caches
