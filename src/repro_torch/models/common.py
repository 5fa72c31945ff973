"""Common model substrate of the port: config, layers, attention.

The reference's ``repro/models/common.py`` in PyTorch. Parameters are
nested dicts of tensors in the reference's layout, with a parallel
``specs`` tree of logical axis names on every leaf (kept so that the
two packages describe a model alike; no planner reads them here).

What changes against the reference, and why:

* ``ArchConfig.dtype`` is ``torch.bfloat16``; ``use_pallas`` is gone.
  :func:`attention` always calls the flash op
  (``kernels.flash_attention.ops.flash_attention``) with the query
  offset: the hand-written kernel for tensors on the card, its plain
  version for tensors on the CPU. The reference's kernel path dropped
  the offset (a decode step's query then sat at position 0); its
  default path, ``plain_attention`` / ``chunked_attention``, computes
  what the op computes here, and the tests hold the port to it.
* Initialisers draw from one ``torch.Generator`` (:class:`KeyGen`),
  which gives other numbers than ``jax.random`` from the same seed;
  tests carry the reference's weights over instead
  (``transformer.params_from_reference``).
* :func:`apply_attn` writes the KV cache in place (the reference
  returns a new cache): a served cache of several GB is not copied each
  step. Its three ``index`` cases are the reference's.
* :func:`lm_head_loss` with ``fused_xent`` walks the same chunks along S
  as the reference's scan, each under ``torch.utils.checkpoint`` when a
  gradient is asked for, so that only one chunk's logits are ever live
  (autograd would otherwise keep every chunk's for the backward).
* Gone, since one card needs none of them: the sharding knobs' effect
  (``with_sharding_constraint``) and the planner's knobs (``attn_chunk``:
  the flash op takes any length, ``seq_shard``, the mesh axes,
  ``force_strategy``) and ``param_count``. The training knobs the port
  reads are back: ``microbatch`` and ``opt_8bit`` (``train/``),
  ``remat`` (``transformer.forward``) and ``fused_xent``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..kernels.flash_attention import ops as flash_ops


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclass
class ArchConfig:
    name: str
    # 'dense' | 'moe' | 'encdec' | 'hybrid' | 'ssm' | 'vlm' | 'audio'
    family: str
    layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    kv_heads: int = 12
    d_ff: int = 3072
    vocab: int = 50304
    head_dim: Optional[int] = None
    # MoE
    n_experts: int = 0
    experts_topk: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0
    moe_every: int = 1           # MoE where idx % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # attention flavor
    mlp_act: str = "silu"        # 'silu' | 'gelu' | 'sqrelu' | 'relu'
    qkv_bias: bool = False
    sliding_window: int = 0      # gemma2 local layers
    alt_local_global: bool = False
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    # hybrid (jamba): period pattern of layer kinds
    period: int = 1
    attn_every: int = 1          # attention at idx % period == attn_idx
    attn_idx: int = 0
    ssm_state: int = 16          # mamba state size
    ssm_expand: int = 2
    # xlstm
    xlstm_pattern: Tuple[str, ...] = ()
    # encoder-decoder
    enc_layers: int = 0
    is_encdec: bool = False
    # frontend stub (audio frames / vision patches): inputs are embeddings
    embeds_input: bool = False
    # numerics / training
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # training knobs (filled by configs)
    microbatch: int = 1          # grad-accumulation steps
    remat: str = "full"          # 'full' | 'dots' | 'none'
    fused_xent: bool = True      # cross-entropy chunked along S
    opt_8bit: bool = False       # int8 Adam moments
    # skip list: shapes this arch cannot run (with reason)
    skip_shapes: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.d_model // self.n_heads
        if self.period == 1 and self.alt_local_global:
            self.period = 2
        if self.xlstm_pattern and self.period == 1:
            self.period = len(self.xlstm_pattern)

    @property
    def n_periods(self) -> int:
        assert self.layers % self.period == 0, (self.name, self.layers,
                                                self.period)
        return self.layers // self.period

    def layer_kind(self, idx_in_period: int) -> str:
        if self.xlstm_pattern:
            return self.xlstm_pattern[idx_in_period]
        if self.family == "hybrid":
            return "attn" if idx_in_period == self.attn_idx else "mamba"
        return "attn"

    def layer_is_moe(self, idx_in_period: int) -> bool:
        if self.n_experts == 0:
            return False
        return idx_in_period % self.moe_every == self.moe_offset

    def layer_window(self, idx_in_period: int) -> int:
        if self.alt_local_global:
            return self.sliding_window if idx_in_period % 2 == 0 else 0
        return self.sliding_window  # 0 = no window; mistral: all layers

    def padded_vocab(self, tp: int = 16, align: int = 128) -> int:
        q = tp * align
        return ((self.vocab + q - 1) // q) * q


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

class KeyGen:
    """The reference's key splitter on one ``torch.Generator``: each call
    hands out the generator, whose stream advances with every draw."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def __call__(self) -> torch.Generator:
        return self.gen


def _init(gen: torch.Generator, shape, dtype, scale=None) -> torch.Tensor:
    """N(0, scale²) drawn in float32 on the generator's device, cast to
    ``dtype``; ``scale`` defaults to 1/sqrt(fan-in = shape[0])."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0] if shape else 1)
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(dtype)


def _zeros(kg: KeyGen, shape, dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=kg.gen.device)


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def rope(x, positions, theta=10000.0):
    """x: (..., S, H, D). positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    angles = positions[..., :, None].float() * freqs  # (...,S,half)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap):
    if cap and cap > 0:
        return torch.tanh(x / cap) * cap
    return x


def _act(name: str):
    return {
        "silu": F.silu,
        # jax.nn.gelu's default is the tanh approximation
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "sqrelu": lambda x: torch.square(F.relu(x)),
    }[name]


# ---------------------------------------------------------------------------
# Attention (GQA, sliding window, softcap, KV cache)
# ---------------------------------------------------------------------------

def attention(q, k, v, cfg: ArchConfig, *, causal=True, window=0,
              q_offset=0):
    """q: (B, Sq, H, D); k/v: (B, Skv, KVH, D); ``q_offset``: an int or
    one position per batch row (B,) — query row ``i`` of batch ``b``
    sits at ``q_offset[b] + i``."""
    return flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=cfg.attn_softcap,
                                     q_offset=q_offset)


# ---------------------------------------------------------------------------
# Attention block (params + apply, with optional KV cache)
# ---------------------------------------------------------------------------

def init_attn(kg: KeyGen, cfg: ArchConfig) -> Tuple[Dict, Dict]:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    p = {
        "wq": _init(kg(), (d, h, hd), cfg.dtype),
        "wk": _init(kg(), (d, kvh, hd), cfg.dtype),
        "wv": _init(kg(), (d, kvh, hd), cfg.dtype),
        "wo": _init(kg(), (h, hd, d), cfg.dtype),
        "ln": _zeros(kg, (d,), cfg.dtype),
    }
    s = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
        "ln": ("embed",),
    }
    if cfg.qkv_bias:
        p["bq"] = _zeros(kg, (h, hd), cfg.dtype)
        p["bk"] = _zeros(kg, (kvh, hd), cfg.dtype)
        p["bv"] = _zeros(kg, (kvh, hd), cfg.dtype)
        s["bq"] = ("heads", "head_dim")
        s["bk"] = ("kv_heads", "head_dim")
        s["bv"] = ("kv_heads", "head_dim")
    return p, s


def _write_cache(cache, k, v):
    """Write the new keys and values into ``cache`` in place, at the
    reference's positions for its three kinds of ``index``."""
    idx, ck, cv = cache["index"], cache["k"], cache["v"]
    s_new, s_max = k.shape[1], ck.shape[1]
    k, v = k.to(ck.dtype), v.to(cv.dtype)
    if idx.dim() == 0:
        # a uniform decode position: dynamic_update_slice, whose start
        # is clamped so that the update fits
        start = int(idx.clamp(0, s_max - s_new))
        ck[:, start:start + s_new] = k
        cv[:, start:start + s_new] = v
    elif s_new == 1:
        # per-slot positions (continuous batching): each slot's row at its
        # own index, none for an index outside the cache (the reference's
        # one-hot select)
        rows = torch.arange(k.shape[0], device=ck.device)
        at = idx.clamp(0, s_max - 1).long()
        keep = ((idx >= 0) & (idx < s_max))[:, None, None]
        ck[rows, at] = torch.where(keep, k[:, 0], ck[rows, at])
        cv[rows, at] = torch.where(keep, v[:, 0], cv[rows, at])
    else:
        # per-slot prefill always fills from position 0
        ck[:, :s_new] = k
        cv[:, :s_new] = v


def apply_attn(p, x, cfg: ArchConfig, *, positions, window=0, cache=None,
               cross_kv=None):
    """x: (B, S, D). cache: dict(k, v, index) for decode, written in
    place; the returned cache holds the same k and v and the advanced
    index. cross_kv: (k, v) for encoder-decoder cross attention (no
    cache, not causal, no window; the softcap is the model's)."""
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    if cross_kv is not None:
        if cfg.qkv_bias:
            q = q + p["bq"]
        k, v = cross_kv
        q = rope(q, positions, cfg.rope_theta)
        out = attention(q, k, v, cfg, causal=False, window=0)
        y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
        return x + y.to(x.dtype), cache
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is not None:
        idx = cache["index"]
        _write_cache(cache, k, v)
        out = attention(q, cache["k"], cache["v"], cfg, causal=True,
                        window=window, q_offset=idx)
        cache = {"k": cache["k"], "v": cache["v"],
                 "index": idx + k.shape[1]}
    else:
        out = attention(q, k, v, cfg, causal=True, window=window)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return x + y.to(x.dtype), cache


def cross_kv_from_encoder(p, enc_out, cfg: ArchConfig):
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
    return k, v


# ---------------------------------------------------------------------------
# MLP block
# ---------------------------------------------------------------------------

def init_mlp(kg: KeyGen, cfg: ArchConfig, d_ff: Optional[int] = None
             ) -> Tuple[Dict, Dict]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    gated = cfg.mlp_act in ("silu", "gelu")
    p = {
        "wi": _init(kg(), (d, f), cfg.dtype),
        "wo": _init(kg(), (f, d), cfg.dtype),
        "ln": _zeros(kg, (d,), cfg.dtype),
    }
    s = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed"), "ln": ("embed",)}
    if gated:
        p["wg"] = _init(kg(), (d, f), cfg.dtype)
        s["wg"] = ("embed", "mlp")
    return p, s


def apply_mlp(p, x, cfg: ArchConfig):
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    up = h @ p["wi"]
    act = _act(cfg.mlp_act)
    if "wg" in p:
        up = act(h @ p["wg"]) * up
    else:
        up = act(up)
    y = up @ p["wo"]
    return x + y.to(x.dtype)


# ---------------------------------------------------------------------------
# Logits
# ---------------------------------------------------------------------------

def mask_padded_vocab(logits, vocab: int):
    vpad = logits.shape[-1]
    if vpad == vocab:
        return logits
    mask = torch.arange(vpad, device=logits.device) < vocab
    return torch.where(mask, logits, -1e30)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _xent_terms(logits, labels):
    """(sum of the valid positions' losses, their count) in float32;
    labels < 0 are ignored."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    valid = labels >= 0
    loss = torch.where(valid, lse - gold, torch.zeros((), device=lse.device))
    return loss.sum(), valid.sum().float()


def cross_entropy(logits, labels, vocab: int):
    """logits: (B,S,V) f32-able; labels: (B,S) int; -100 → ignore.
    Entries ≥ vocab in the padded dimension are masked (by the caller,
    :func:`mask_padded_vocab`)."""
    tot, cnt = _xent_terms(logits, labels)
    return tot / torch.clamp(cnt, min=1)


def lm_head_loss(params, x, labels, cfg: ArchConfig, padded_vocab: int):
    """Final norm + unembed + xent. With cfg.fused_xent the (B,S,V) logit
    tensor is consumed chunk-wise along S (the reference's chunks), each
    chunk's logits recomputed in the backward, so only a chunk is ever
    live."""
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    w = params.get("unembed", params["embed"])  # (Vpad, D)

    def logit_fn(chunk):
        logits = torch.einsum("btd,vd->btv", chunk, w)
        return mask_padded_vocab(softcap(logits, cfg.logit_softcap),
                                 cfg.vocab)

    if not cfg.fused_xent:
        return cross_entropy(logit_fn(x), labels, cfg.vocab)

    # chunk along sequence to bound live logits
    b, s, d = x.shape
    n_chunks = min(8, s) if s >= 8 else 1
    while s % n_chunks:
        n_chunks -= 1
    size = s // n_chunks

    def chunk_terms(xc, lc):
        return _xent_terms(logit_fn(xc), lc)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        xc = x[:, c * size:(c + 1) * size]
        lc = labels[:, c * size:(c + 1) * size]
        if torch.is_grad_enabled():
            t, n = torch.utils.checkpoint.checkpoint(
                chunk_terms, xc, lc, use_reentrant=False)
        else:
            t, n = chunk_terms(xc, lc)
        tot = tot + t
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)
