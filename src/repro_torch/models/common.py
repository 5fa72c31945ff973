"""Common model substrate of the port: config, layers, attention.

The reference's ``repro/models/common.py`` in PyTorch. Parameters are
nested dicts of tensors in the reference's layout, with a parallel
``specs`` tree of logical axis names on every leaf, which the
auto-sharding planner (``core/planner.py``) reads.

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
  as the reference's scan and, when a gradient is asked for, takes each
  chunk's gradient as its logits are made (:class:`_ChunkedXent`), so
  that only one chunk's logits are ever live (autograd would keep every
  chunk's for the backward) and none is computed again.
* The planner's inputs are the reference's: ``param_count``,
  ``active_param_count``, ``seq_shard``, ``force_strategy`` and the mesh
  axes the launch layer fills (``act_batch_axes``, ``moe_expert_axes``,
  ``moe_capacity_axes``). Where a tensor is a DTensor (the dry run's, or
  a sharded step's), :func:`anchor` redistributes it to those axes, the
  counterpart of the reference's ``with_sharding_constraint``, and each
  product with a weight is one ``local_map`` whose rows stay sharded
  (:func:`product`, :func:`lookup`; a weight gathered over the batch's
  mesh axes as GSPMD's FSDP gathers it, or the rows gathered where that
  moves fewer bytes); a plain tensor passes unchanged. ``attn_chunk`` is gone: the flash op takes
  any length. The training knobs are the reference's: ``microbatch``
  and ``opt_8bit`` (``train/``), ``remat`` (``transformer.forward``)
  and ``fused_xent``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..kernels.flash_attention import ops as flash_ops
from ..kernels.sharded import gather_over, is_dtensor, mesh_of


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
    # parallelism knobs (filled by configs and by the launch layer)
    seq_shard: bool = False      # sequence-parallel residual stream: remat
                                 # checkpoints shard seq over `model`
    act_batch_axes: Optional[Tuple[str, ...]] = None
    # ^ planner-chosen mesh axes for the activation batch dim; anchored
    #   between periods (runtime knob, set by launch/dryrun.py)
    moe_expert_axes: Optional[Tuple[str, ...]] = None
    # ^ planner-chosen mesh axes for the expert dim of MoE dispatch
    #   buffers (same anchoring, applied inside apply_moe)
    moe_capacity_axes: Optional[Tuple[str, ...]] = None
    # ^ mesh axes for the capacity dim (covers axes experts cannot)
    force_strategy: Optional[str] = None   # pin the planner's strategy
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

    def param_count(self) -> int:
        """Approximate total parameters (for roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        for p in range(self.period):
            kind = self.layer_kind(p)
            if kind == "attn":
                total_l = d * self.n_heads * self.head_dim \
                    + 2 * d * self.kv_heads * self.head_dim \
                    + self.n_heads * self.head_dim * d
            elif kind == "mamba":
                inner = self.ssm_expand * d
                total_l = d * inner * 2 + inner * d \
                    + inner * (2 * self.ssm_state + 2)
            elif kind in ("mlstm", "slstm"):
                inner = d * 2
                total_l = 4 * d * inner + inner * d
            else:
                total_l = 0
            if self.layer_is_moe(p):
                eff = self.expert_d_ff or self.d_ff
                total_l += self.n_experts * 3 * d * eff
                total_l += self.n_shared_experts * 3 * d * eff
                total_l += d * self.n_experts  # router
            elif kind == "attn" and self.d_ff > 0:
                mult = 3 if self.mlp_act in ("silu", "gelu") else 2
                total_l += mult * d * self.d_ff
            total += total_l * self.n_periods
        if self.is_encdec:
            total = int(total * 1.6)  # encoder stack + cross attention
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        eff = self.expert_d_ff or self.d_ff
        per_layer_all = self.n_experts * 3 * d * eff
        per_layer_act = (self.experts_topk + self.n_shared_experts) \
            * 3 * d * eff
        n_moe_layers = sum(1 for p in range(self.period)
                           if self.layer_is_moe(p)) * self.n_periods
        return self.param_count() - n_moe_layers * (per_layer_all -
                                                    per_layer_act)


# ---------------------------------------------------------------------------
# Sharded activations (DTensors; a plain tensor passes every helper as is)
# ---------------------------------------------------------------------------

def anchor(t, spec):
    """``t`` redistributed so that each dimension named in ``spec`` (one
    entry per dimension: None for unconstrained, ``()`` for whole on
    every rank, a mesh axis name or a tuple of them in mesh order) is
    sharded over those axes, where it splits evenly; the other mesh
    dimensions keep their placement, but none shards a dimension
    ``spec`` names or asks whole, and a partial sum is summed. The
    counterpart of the reference's ``with_sharding_constraint`` (which
    never leaves a partial sum either): without it DTensor's propagation
    may leave an activation replicated over idle axes. A plain tensor,
    or a mesh without the axes (or with them of size 1), passes
    unchanged."""
    if not is_dtensor(t):
        return t
    out = anchored(t.placements, t.shape, spec, t.device_mesh)
    if tuple(out) == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, out)


def anchored(placements, shape, spec, mesh) -> list:
    """The placements :func:`anchor` gives a tensor of ``shape`` placed
    by ``placements`` on ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    want = {}
    whole = {d for d, entry in enumerate(spec) if entry == ()}
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        axes = tuple(a for a in axes if a in names
                     and mesh.size(names.index(a)) > 1)
        n = math.prod(mesh.size(names.index(a)) for a in axes)
        if axes and shape[d] % n == 0:
            want.update({names.index(a): d for a in axes})
    out = []
    for m, cur in enumerate(placements):
        if m in want:
            out.append(Shard(want[m]))
        elif cur.is_partial() or (isinstance(cur, Shard) and (
                cur.dim in want.values() or cur.dim in whole)):
            out.append(Replicate())
        else:
            out.append(cur)
    return out


def _row_dims(x, rows):
    """The mesh dimensions that shard one of ``x``'s dimensions ``rows``
    (by default every one but the last, the contracted feature)."""
    from torch.distributed.tensor import Shard

    rows = set(range(x.dim() - 1) if rows is None else rows)
    return {m for m, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim in rows}


def gathered(w, x, rows=None):
    """The weight ``w`` gathered whole over each mesh dimension that
    shards one of the activation ``x``'s ``rows``, before ``w`` meets
    ``x`` in an elementwise op or a product: the counterpart of GSPMD's
    FSDP all-gather, after which the result's rows stay sharded as
    ``x``'s. ``w``'s shards over the other mesh dimensions (tensor
    parallelism) stay. Where either is a plain tensor, ``w`` is
    returned as it is."""
    if not (is_dtensor(w) and is_dtensor(x)):
        return w
    return gather_over(w, _row_dims(x, rows))


def _local_nbytes(t) -> int:
    """Bytes of each rank's piece of the DTensor ``t``."""
    from ..kernels.sharded import shards

    n = t.numel() * t.element_size()
    for d in range(t.dim()):
        n //= shards(t.placements, d, t.device_mesh)
    return n


def product(eq, x, w, plain=None):
    """``torch.einsum(eq, x, w)`` of an activation ``x`` and a weight
    ``w`` (``plain(x, w)``, the same product, on plain tensors, where
    given). On DTensors, one ``local_map`` (:func:`_einsum_local`) whose
    result's rows (``x``'s letters that ``w`` lacks) are sharded as
    ``x``'s, never a partial sum over the mesh dimensions that shard
    them (:func:`_fsdp`). DTensor's own propagation, where ``w`` is
    sharded (FSDP) over those mesh dimensions, moves ``x`` onto ``w``'s
    shards of the contracted dimension and leaves such a partial sum:
    every rank then holds every row (a decode step's attention ran on
    the whole batch on every rank). Its search for the product's
    placements also took minutes a step on a three-axis mesh, where the
    flattened rows of a sharded batch become strided shards."""
    if not (is_dtensor(w) and is_dtensor(x)):
        return plain(x, w) if plain is not None else torch.einsum(eq, x, w)
    (xs, ws), out = eq.split("->")[0].split(","), eq.split("->")[1]
    rows = [d for d, c in enumerate(xs) if c not in ws]
    width = math.prod(w.shape[j] for j, c in enumerate(ws) if c not in xs)
    return _fsdp(lambda a, b: _einsum_local(eq, a, b), x, w, rows, width,
                 [out.index(xs[d]) for d in rows])


def _fsdp(local, x, w, rows, width, out_dims):
    """``local(x, w)`` for an activation ``x`` whose ``rows`` (its
    dimensions at ``out_dims`` of the result) come out sharded as they
    go in, and a weight ``w`` sharded (FSDP) over some of the mesh
    dimensions that shard them. The cheaper of GSPMD's two ways, by the
    bytes each gathers to a rank: ``w`` gathered over those mesh
    dimensions (a training step's many rows), or ``x``'s rows gathered
    over them, multiplied by ``w`` as it lies, and the result's rows
    (``width`` elements each) scattered back (a decode step's few). Any
    other partial sum of the result (a row-parallel product's, over
    ``model``) is summed."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    by_rows = _row_dims(x, rows)
    over = {m for m in by_rows if isinstance(w.placements[m], Shard)}
    n_rows = math.prod(x.shape[d] for d in rows) \
        // math.prod(mesh.size(m) for m in by_rows)
    moved = n_rows * width * w.element_size()
    if not over:
        y = local(x, w)
    elif _local_nbytes(w) <= _local_nbytes(x) + moved:
        y = local(x, gather_over(w, over))
    else:
        y = local(gather_over(x, over), w)
    back = [Shard(out_dims[rows.index(x.placements[m].dim)]) if m in over
            else Replicate() if p.is_partial() else p
            for m, p in enumerate(y.placements)]
    return y if back == list(y.placements) else y.redistribute(mesh, back)


def _einsum_local(eq, x, w):
    """``torch.einsum(eq, x, w)`` on DTensors, one ``local_map``. Every
    letter is a row (``x`` and the result), a contracted one (``x`` and
    ``w``) or an output of ``w`` (``w`` and the result). Per mesh
    dimension: ``x``'s rows sharded, ``w`` whole (gathered here if it is
    not), the result's rows sharded; a contracted letter sharded (in
    ``x`` or ``w``: the other sliced to it), the result a partial sum;
    ``x`` whole and an output of ``w`` sharded, the result sharded so
    (``x`` gathered first where it shards a contracted letter that
    ``w`` does not); both whole, the result whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    (xs, ws), out = eq.split("->")[0].split(","), eq.split("->")[1]
    mesh = x.device_mesh
    xp, wp, yp, xg, wg = [], [], [], [], []
    for m in range(mesh.ndim):
        a, b = x.placements[m], w.placements[m]
        ca = xs[a.dim] if isinstance(a, Shard) else None
        cb = ws[b.dim] if isinstance(b, Shard) else None
        if ca is not None and ca not in ws:            # a row
            pl = (a, Replicate(), Shard(out.index(ca)), a, Partial())
        elif ca is not None and cb in (None, ca):      # contracted
            wc = Shard(ws.index(ca))
            pl = (a, wc, Partial(), a, wc)
        elif cb is not None and cb in xs:              # contracted, in w
            xc = Shard(xs.index(cb))
            pl = (xc, b, Partial(), xc, b)
        elif cb is not None:                           # an output of w
            pl = (Replicate(), b, Shard(out.index(cb)), Partial(), b)
        else:
            pl = (Replicate(),) * 5
        for acc, p in zip((xp, wp, yp, xg, wg), pl):
            acc.append(p)
    return local_map(lambda a, b: torch.einsum(eq, a, b),
                     out_placements=yp, in_placements=(xp, wp),
                     in_grad_placements=(xg, wg), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


def lookup(table, tokens):
    """``table[tokens]``: the rows of a (V, D) table. On DTensors, one
    ``local_map``: each rank takes the tokens that fall in its slice of
    the vocabulary (zeros for the others), a partial sum over the
    vocabulary's mesh dims, and the embedding dimension keeps its
    shards; the table gathered over the tokens' shards, or the tokens
    over the table's, whichever moves fewer bytes (:func:`_fsdp`). The
    counterpart of GSPMD's sharded gather; DTensor's own embedding
    leaves a masked partial sum that its redistribution cannot take on
    meta tensors."""
    if not is_dtensor(table, tokens):
        return table[tokens]
    from ..kernels.sharded import as_dtensor

    mesh = mesh_of(table, tokens)
    tokens, table = as_dtensor(tokens, mesh), as_dtensor(table, mesh)
    rows = list(range(tokens.dim()))
    return _fsdp(_lookup, tokens, table, rows, table.shape[-1], rows)


def _lookup(tokens, table):
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..kernels.sharded import shard_index, shards

    mesh = table.device_mesh
    tp, kp = table.placements, tokens.placements
    n = table.shape[0] // shards(tp, 0, mesh)
    start = shard_index(tp, 0, mesh) * n
    vocab = [m for m, p in enumerate(tp) if p == Shard(0)]
    kp = [Replicate() if m in vocab else p for m, p in enumerate(kp)]
    out = [Partial() if m in vocab else Shard(tokens.dim())
           if tp[m] == Shard(1) else kp[m] for m in range(mesh.ndim)]
    grad = [Partial() if isinstance(kp[m], Shard) else tp[m]
            for m in range(mesh.ndim)]

    def local(tab, tok):
        idx = tok.long() - start
        hit = (idx >= 0) & (idx < n)
        return tab[idx.clamp(0, n - 1)] * hit[..., None].to(tab.dtype)

    return local_map(local, out_placements=out, in_placements=(tp, kp),
                     in_grad_placements=(grad, kp), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


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
    scale = gathered(scale, x)
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


def out_proj(out, w):
    """``einsum("bshk,hkd->bsd", out, w)``: the attention heads' output
    projection (:func:`product`)."""
    return product("bshk,hkd->bsd", out, w)


def heads_proj(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` (:func:`product`: on DTensors
    one ``local_map``, which takes head_dim sharded where the heads are
    too few to split, the planner's GQA fallback, gemma2's 4 KV heads
    on 8; DTensor's einsum flattens (heads, head_dim) and cannot)."""
    return product("bsd,dhk->bshk", x, w)


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
    if idx.dim() == 0 and is_dtensor(ck):
        # the same write with the position left on the device: a DTensor
        # (the dry run's on meta tensors) has no value for the host to
        # read. The new rows take the cache's placements, and each rank
        # writes its own into its piece (torch 2.11's DTensor has no
        # sharding rule for index_copy_)
        at = (idx.clamp(0, s_max - s_new).long()
              + torch.arange(s_new, device=ck.device))
        at = at.full_tensor() if is_dtensor(at) else at
        for c, t in ((ck, k), (cv, v)):
            t = t.redistribute(c.device_mesh, c.placements)
            c.to_local().index_copy_(1, at, t.to_local())
    elif idx.dim() == 0:
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
    q = heads_proj(h, p["wq"])
    if cross_kv is not None:
        if cfg.qkv_bias:
            q = q + gathered(p["bq"], q, (0, 1))
        k, v = cross_kv
        q = rope(q, positions, cfg.rope_theta)
        out = attention(q, k, v, cfg, causal=False, window=0)
        y = out_proj(out, p["wo"])
        return x + y.to(x.dtype), cache
    k = heads_proj(h, p["wk"])
    v = heads_proj(h, p["wv"])
    if cfg.qkv_bias:
        q = q + gathered(p["bq"], q, (0, 1))
        k = k + gathered(p["bk"], k, (0, 1))
        v = v + gathered(p["bv"], v, (0, 1))
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
    y = out_proj(out, p["wo"])
    return x + y.to(x.dtype), cache


def cross_kv_from_encoder(p, enc_out, cfg: ArchConfig):
    k = heads_proj(enc_out, p["wk"])
    v = heads_proj(enc_out, p["wv"])
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
    up = product("bsd,df->bsf", h, p["wi"], torch.matmul)
    act = _act(cfg.mlp_act)
    if "wg" in p:
        up = act(product("bsd,df->bsf", h, p["wg"], torch.matmul)) * up
    else:
        up = act(up)
    y = product("bsf,fd->bsd", up, p["wo"], torch.matmul)
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
    idx = labels.clamp(min=0).long()[..., None]
    if is_dtensor(logits):
        # the vocab dim may be sharded: the gold logit as a masked sum,
        # which shards (DTensor's gather along a sharded dim does not)
        hit = torch.arange(logits.shape[-1], device=logits.device) == idx
        gold = torch.where(hit, logits, 0.0).sum(-1)
    else:
        gold = logits.gather(-1, idx)[..., 0]
    valid = labels >= 0
    loss = torch.where(valid, lse - gold, torch.zeros((), device=lse.device))
    return loss.sum(), valid.sum().float()


def cross_entropy(logits, labels, vocab: int):
    """logits: (B,S,V) f32-able; labels: (B,S) int; -100 → ignore.
    Entries ≥ vocab in the padded dimension are masked (by the caller,
    :func:`mask_padded_vocab`)."""
    tot, cnt = _xent_terms(logits, labels)
    return tot / torch.clamp(cnt, min=1)


class _ChunkedXent(torch.autograd.Function):
    """(sum of the valid positions' losses, their count) over chunks of
    S, with each chunk's gradient taken in the forward: the chunk's
    logits (one product), their gradient, and from it the chunk's dX and
    its share of dW (two products), so that no chunk's logits stay live
    and none is computed twice. The backward scales the sums by the
    loss's gradient. Three products per chunk, as autograd through the
    reference's chunk scan takes."""

    @staticmethod
    def forward(ctx, x, w, labels, post, n_chunks):
        size = x.shape[1] // n_chunks
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        dxs, dw = [], None
        for c in range(n_chunks):
            xc = x[:, c * size:(c + 1) * size]
            lc = labels[:, c * size:(c + 1) * size]
            raw = torch.einsum("btd,vd->btv", xc, w).requires_grad_(True)
            with torch.enable_grad():
                t, n = _xent_terms(post(raw), lc)
                (dlg,) = torch.autograd.grad(t, raw)
            dxs.append(torch.einsum("btv,vd->btd", dlg, w))
            part = torch.einsum("btv,btd->vd", dlg, xc).float()
            dw = part if dw is None else dw + part
            tot = tot + t.detach()
            cnt = cnt + n
        ctx.save_for_backward(torch.cat(dxs, dim=1), dw)
        ctx.dtypes = (x.dtype, w.dtype)
        return tot, cnt

    @staticmethod
    def backward(ctx, g_tot, g_cnt):
        dx, dw = ctx.saved_tensors
        return ((dx.float() * g_tot).to(ctx.dtypes[0]),
                (dw * g_tot).to(ctx.dtypes[1]), None, None, None)


def lm_head_loss(params, x, labels, cfg: ArchConfig, padded_vocab: int):
    """Final norm + unembed + xent. With cfg.fused_xent the (B,S,V) logit
    tensor is consumed chunk-wise along S (the reference's chunks), so
    only a chunk is ever live: where a gradient is asked for, each
    chunk's gradient is taken as its logits are made
    (:class:`_ChunkedXent`)."""
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    w = gathered(params.get("unembed", params["embed"]), x)  # (Vpad, D)

    def post(logits):
        return mask_padded_vocab(softcap(logits, cfg.logit_softcap),
                                 cfg.vocab)

    def logit_fn(chunk):
        return post(torch.einsum("btd,vd->btv", chunk, w))

    if not cfg.fused_xent:
        return cross_entropy(logit_fn(x), labels, cfg.vocab)

    # chunk along sequence to bound live logits
    b, s, d = x.shape
    n_chunks = min(8, s) if s >= 8 else 1
    while s % n_chunks:
        n_chunks -= 1
    size = s // n_chunks

    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        tot, cnt = _ChunkedXent.apply(x, w, labels, post, n_chunks)
        return tot / torch.clamp(cnt, min=1.0)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        t, n = _xent_terms(logit_fn(x[:, c * size:(c + 1) * size]),
                           labels[:, c * size:(c + 1) * size])
        tot = tot + t
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)
