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
them to XLA). Plain tensors (served, or trained on one card) take only
this.

On DTensors (the dry run, a sharded step) the routing, the dispatch and
the combine are one ``local_map`` each on each rank's own shard, as the
reference's GSPMD program partitions them (the tokens sharded over the
batch's mesh axes, their sequence whole: ``transformer._anchor_tokens``):

* routing: each rank routes its own tokens. A token's position within
  its expert is its rank in the global flat order (b·S + s, then top-k
  order), so each rank adds to its local cumsum the assignments to that
  expert of the shards before its own (one all-gather of E counts a
  rank): the reference's positions and drops.
* dispatch: the token rows and their slots are gathered over the
  batch's mesh axes only, and each rank fills its own piece of the
  (E, cap, D) buffer, placed on the planner's expert and capacity axes
  (``common.anchor``'s placements, the reference's ``_anchor``), so
  that the expert products run sharded.
* combine: each rank weights its piece's rows into a partial sum for
  the gathered tokens, which one reduce-scatter over the batch's mesh
  axes returns to their ranks; one all-reduce sums over the axes that
  shard only the experts.

No rank holds the experts' whole output, and no row crosses a mesh axis
that shards neither the tokens nor the buffer (:class:`_Sharded`).
Where the plan gives the experts no mesh axis, the buffer is whole on
every rank, as the reference keeps it, and the expert products run on
each rank's shard of the weights (:func:`_experts_on_shards`).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.sharded import (group_name, is_dtensor, keep_shards,
                               regrid, shard_index, shards)
from .common import (ArchConfig, KeyGen, _act, _init, _zeros, anchor,
                     anchored, gathered, product, rmsnorm)

#: the DTensor path's calls (:func:`_routed_sharded`: one a MoE layer
#: and forward)
local_calls = 0
#: its calls with no expert axis in the plan (:func:`_experts_on_shards`)
shard_calls = 0


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
    weights, flat_e, pos, _ = _assignments(ht, p["router"], cfg)
    cap = capacity(cfg, ht.shape[0], e_pad)
    return weights, _slots(flat_e, pos, cap, e_pad), cap


def _assignments(ht, router, cfg: ArchConfig):
    """(weights, flat_e, pos, counts) for the tokens ``ht`` (T, D): the
    top-k softmax weights (T, K), each of the T·K assignments' expert
    and its position among these tokens' assignments to that expert,
    and the number of assignments to each expert (E,)."""
    e_pad = router.shape[1]
    logits = ht.float() @ router                            # (T, E)
    if e_pad != cfg.n_experts:
        pad = torch.arange(e_pad, device=ht.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    weights, expert_ids = torch.topk(logits, cfg.experts_topk, dim=-1)
    weights = torch.softmax(weights, dim=-1).to(ht.dtype)  # (T, K)

    # --- position within expert ------------------------------------------
    flat_e = expert_ids.reshape(-1)                         # (T*K,)
    running = F.one_hot(flat_e, e_pad).cumsum(0)            # (T*K, E)
    pos = (running - 1).gather(1, flat_e[:, None])[:, 0]
    return weights, flat_e, pos, running[-1]


def _slots(flat_e, pos, cap: int, e_pad: int):
    """Each assignment's row of the dispatch buffer; E·cap (the overflow
    row) where its position is past the capacity."""
    return torch.where(pos < cap, flat_e * cap + pos,
                       torch.full_like(pos, e_pad * cap))


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


def _spec(cfg: ArchConfig, ndim: int):
    """The anchor spec of an (expert, capacity, ...) tensor."""
    return (tuple(cfg.moe_expert_axes), tuple(cfg.moe_capacity_axes or ())) \
        + ((),) * (ndim - 2)


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
    return anchor(t, _spec(cfg, t.dim()))


def _ffn(buf, product, act, gated: bool):
    """The experts' FFN over their tokens ``buf`` (E, cap, D), batched
    over the experts: ``product(name, x)`` is ``x`` times the weight
    ``name`` (``wi``, ``wg``, ``wo``)."""
    up = product("wi", buf)
    if gated:
        up = act(product("wg", buf)) * up                   # (E, C, F)
    else:
        up = act(up)
    return product("wo", up)


def _experts(p, buf, act, cfg: ArchConfig):
    """The experts' outputs (E, cap, D) for their tokens ``buf`` (each
    expert's weights gathered over the capacity's mesh dims). On
    DTensors whose plan gives the experts no mesh axis, each rank
    multiplies the whole buffer by its own shard of the weights
    (:func:`_experts_on_shards`)."""
    if is_dtensor(buf) and not cfg.moe_expert_axes:
        return _experts_on_shards(p, buf, act)
    return _ffn(_anchor(buf, cfg), lambda k, x: _anchor(
        torch.bmm(x, gathered(p[k], x, (1,))), cfg), act, "wg" in p)


def _experts_on_shards(p, buf, act):
    """:func:`_experts` where the plan gives the experts no mesh axis
    (Jamba under FSDP: 16 experts over 256 chips) and the buffer lies
    whole on every rank: one ``local_map`` in which each rank multiplies
    the whole buffer by its 1/n of every weight's F dimension, n the
    ranks of the mesh dims that shard the weights (Megatron's column
    then row split). The up and gate products give this rank's F/n
    columns, the down product a partial sum (E, cap, D) that one
    all-reduce over those ranks adds; the buffer's gradient, a partial
    sum too, is added likewise. ``wo`` lies on F as planned. ``wi`` and
    ``wg``, which the plan shards on D, each take the cheaper of two
    ways by the bytes a rank receives: moved to F by one all-to-all (the
    weight's shard, E·D·F/n; ``kernels/sharded.py::regrid``), or left
    on D, multiplied by the buffer's D/n columns that match, and the
    partial sums (E, cap, F) reduce-scattered onto F (about E·cap·F): a
    training step's many rows move the weights, a decode step's few
    (cap < D/n) the sums. Their gradients go back the same ways.

    The reference's program gathers ``up`` whole in F instead, puts
    ``wo`` on D and gathers the output along D: in the op count's
    output bytes that moves (E·cap·F) + (E·cap·D) forward and as much
    backward against this way's (E·cap·D) each, and on a ring more
    whenever F > D / 2."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    global shard_calls
    shard_calls += 1
    mesh = buf.device_mesh
    names = [k for k in ("wi", "wg", "wo") if k in p]
    grid = sorted({m for k in names for m, q in enumerate(p[k].placements)
                   if isinstance(q, Shard)})
    n = math.prod(mesh.size(m) for m in grid)
    group = group_name(mesh, grid) if grid else None

    def on(dim):
        return [Shard(dim) if m in grid else Replicate()
                for m in range(mesh.ndim)]

    _, cap, d = buf.shape
    summed = {k for k in ("wi", "wg") if k in p and n > 1 and cap * n < d
              and list(p[k].placements) == on(1)}
    r = shard_index(on(1), 1, mesh)
    lo, hi = r * d // n, (r + 1) * d // n          # this rank's D block
    dims = {k: 1 if k in summed or k == "wo" else 2 for k in names}
    rep = [Replicate()] * mesh.ndim
    ins = [rep] + [on(dims[k]) for k in names]

    def local(buf_, *ws):
        weight = dict(zip(names, ws))

        def product(k, x):
            if k in summed:
                return _ScatterSum.apply(torch.bmm(x[..., lo:hi], weight[k]),
                                         group, n)
            return torch.bmm(x, weight[k])

        out = _ffn(_SumGrad.apply(buf_, group), product, act,
                   "wg" in weight)
        return _SumOver.apply(out, group)

    return local_map(local, out_placements=rep, in_placements=ins,
                     in_grad_placements=ins, device_mesh=mesh,
                     redistribute_inputs=True)(
        buf, *(regrid(p[k], dims[k], grid) for k in names))


def apply_moe(p, x, cfg: ArchConfig):
    """x: (B, S, D) → (B, S, D) residual-added."""
    b, s, d = x.shape
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    t = b * s
    e_pad = p["router"].shape[1]
    k = cfg.experts_topk
    act = _act(cfg.mlp_act)
    cap = capacity(cfg, t, e_pad)
    if is_dtensor(h):
        y = _routed_sharded(p, h, cap, act, cfg)
    else:
        ht = h.reshape(t, d)
        weights, slot, _ = route(p, ht, cfg)
        out = _experts(p, _dispatch(ht, slot, e_pad, cap, k), act, cfg)
        y = _combine(out, slot, weights, k).reshape(b, s, d)

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


# ---------------------------------------------------------------------------
# DTensors: routing, dispatch and combine on each rank's own shard
# ---------------------------------------------------------------------------

class _Sharded:
    """One MoE layer's routing, dispatch and combine on DTensors, each
    one ``local_map`` on each rank's own shard.

    The tokens ``h`` (B, S, D) are sharded by batch rows over the mesh
    dims ``tok`` (a rank's rows are block :attr:`index` of the global
    flat order, blocks nested in mesh order); the dispatch buffer (E,
    cap, D) lies on the placements ``bp`` (the planner's expert and
    capacity axes, where they split it), its dims ``buf``. Each rank
    gathers every ``tok`` rank's rows (:meth:`gather`). The combine's
    partial sums over them go back (:meth:`reduce`) by one
    reduce-scatter over the ``tok`` dims that shard the buffer; along
    the others a rank's piece of the buffer is every rank's, so each
    keeps its own block of rows only; then one all-reduce over the
    ``buf`` dims that do not shard the tokens (:meth:`total`). The
    exchanges take and give plain tensors (inside a ``local_map``)."""

    def __init__(self, h, e_pad: int, cap: int, cfg: ArchConfig):
        from torch.distributed.tensor import Replicate, Shard

        mesh = self.mesh = h.device_mesh
        self.cfg, self.e_pad, self.cap = cfg, e_pad, cap
        self.hp = keep_shards(h.placements, (0,), h.shape, mesh)
        bp = [Replicate()] * mesh.ndim
        if cfg.moe_expert_axes:
            bp = anchored(bp, (e_pad, cap, h.shape[-1]), _spec(cfg, 3),
                          mesh)
        self.bp = bp
        tok = self.tok = [m for m, q in enumerate(self.hp)
                          if isinstance(q, Shard)]
        buf = self.buf = [m for m, q in enumerate(bp)
                          if isinstance(q, Shard)]
        coord = mesh.get_coordinate()
        self.sizes = [mesh.size(m) for m in tok]
        self.n = math.prod(self.sizes)
        # per tok dim: summed over (it shards the buffer), or this rank's
        # coordinate along it
        self.pick = tuple(slice(None) if m in buf else coord[m]
                          for m in tok)
        self.index = shard_index(self.hp, 0, mesh)
        red = [m for m in tok if m in buf]
        rest = [m for m in buf if m not in tok]
        self.n_red = math.prod(mesh.size(m) for m in red)
        self.gather_group = group_name(mesh, tok) if tok else None
        self.reduce_group = group_name(mesh, red) if red else None
        self.sum_group = group_name(mesh, rest) if rest else None
        # this rank's piece of the buffer: experts [e0, e0 + ne),
        # positions [c0, c0 + nc)
        self.ne = e_pad // shards(bp, 0, mesh)
        self.nc = cap // shards(bp, 1, mesh)
        self.e0 = shard_index(bp, 0, mesh) * self.ne
        self.c0 = shard_index(bp, 1, mesh) * self.nc

    # --- the three steps (DTensors) --------------------------------------

    def route(self, h, router):
        """(weights (B, S, K), slot (B, S·K)) of :func:`route`, sharded
        as ``h``: each rank routes its own tokens and adds to each
        position the assignments to its expert of the blocks before its
        own."""
        cfg, rep = self.cfg, self._placements()

        def local(h_, router_):
            b, s, d = h_.shape
            weights, flat_e, pos, counts = _assignments(
                h_.reshape(-1, d), router_, cfg)
            if self.n > 1:
                pos = pos + self.gather(counts[None])[:self.index].sum(
                    0)[flat_e]
            slot = _slots(flat_e, pos, self.cap, self.e_pad)
            return weights.reshape(b, s, -1), slot.reshape(b, -1)

        # the router's gradient: each tok rank's own tokens'
        return self._map(local, (self.hp, rep), (self.hp, self.hp),
                         (self.hp, self._placements(partial=self.tok))
                         )(h, router)

    def dispatch(self, h, slot):
        """The dispatch buffer (E, cap, D) on ``bp``: each rank fills its
        piece from every tok rank's rows."""
        k = self.cfg.experts_topk

        def local(h_, slot_):
            every = _Gathered.apply(h_.reshape(-1, h_.shape[-1]), self)
            return _fill(every, self._own(slot_), self.ne * self.nc,
                         k).reshape(self.ne, self.nc, -1)

        return self._map(local, (self.hp, self.hp), self.bp,
                         (self._by_expert(), self.hp))(h, slot)

    def combine(self, out, slot, weights):
        """Each token's experts' outputs, weighted and summed (B, S, D),
        sharded as ``h``."""
        k = self.cfg.experts_topk

        def local(out_, slot_, weights_):
            every = _Gathered.apply(weights_.reshape(-1, k), self)
            y = _Reduced.apply(_combine(out_, self._own(slot_), every, k),
                               self)
            return y.reshape(slot_.shape[0], -1, y.shape[-1])

        return self._map(local, (self.bp, self.hp, self.hp), self.hp,
                         (self.bp, self.hp, self._by_expert())
                         )(out, slot, weights)

    def _own(self, slot_):
        """Each gathered assignment's row of this rank's piece (or the
        piece's overflow row)."""
        every = self.gather(slot_.reshape(-1))
        e, c = every // self.cap, every % self.cap
        mine = (e >= self.e0) & (e < self.e0 + self.ne) \
            & (c >= self.c0) & (c < self.c0 + self.nc)
        return torch.where(mine, (e - self.e0) * self.nc + c - self.c0,
                           torch.full_like(every, self.ne * self.nc))

    def _placements(self, base=None, partial=()):
        from torch.distributed.tensor import Partial, Replicate

        base = base or [Replicate()] * self.mesh.ndim
        return [Partial() if m in partial else q
                for m, q in enumerate(base)]

    def _by_expert(self):
        """A gradient of the tokens' rows or weights: sharded as ``h``,
        a partial sum over the dims that shard only the buffer (each rank
        has its experts' share)."""
        return self._placements(self.hp, [m for m in self.buf
                                          if m not in self.tok])

    def _map(self, fn, ins, out, grads):
        from torch.distributed.tensor.experimental import local_map

        return local_map(fn, out_placements=out, in_placements=ins,
                         in_grad_placements=grads, device_mesh=self.mesh,
                         redistribute_inputs=True)

    # --- the exchanges (plain tensors) -----------------------------------

    def gather(self, x):
        """(T, ...) rows of each tok rank → (n·T, ...), in rank order."""
        if self.gather_group is None:
            return x
        ops = torch.ops._c10d_functional
        return ops.wait_tensor(ops.all_gather_into_tensor(
            x.contiguous(), self.n, self.gather_group))

    def reduce(self, xg):
        """(n·T, ...) partial sums → this rank's (T, ...)."""
        if self.gather_group is None:
            return xg
        rest = xg.shape[1:]
        x = xg.reshape(*self.sizes, -1, *rest)[self.pick]
        x = x.reshape(-1, *rest)
        if self.reduce_group is None:
            return x
        ops = torch.ops._c10d_functional
        return ops.wait_tensor(ops.reduce_scatter_tensor(
            x.contiguous(), "sum", self.n_red, self.reduce_group))

    def total(self, y):
        """``y`` summed over the buf dims that do not shard the tokens."""
        return _all_reduce(y, self.sum_group)


def _all_reduce(y, group):
    """``y`` summed over the ranks of ``group`` (None: as it is)."""
    if group is None:
        return y
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(ops.all_reduce(y.contiguous(), "sum", group))


class _SumOver(torch.autograd.Function):
    """Partial sums added over ``group``; the gradient of the sum, the
    same on every rank, is each partial sum's."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterSum(torch.autograd.Function):
    """Partial sums (E, cap, F) added over ``group``, this rank's F/n
    block kept (one reduce-scatter); its gradient, every rank's block,
    gathered (one all-gather)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        ops = torch.ops._c10d_functional
        return ops.wait_tensor(ops.reduce_scatter_tensor(
            x.movedim(2, 0).contiguous(), "sum", n, group)).movedim(0, 2)

    @staticmethod
    def backward(ctx, g):
        ops = torch.ops._c10d_functional
        return ops.wait_tensor(ops.all_gather_into_tensor(
            g.movedim(2, 0).contiguous(), ctx.n, ctx.group)
        ).movedim(0, 2), None, None


class _SumGrad(torch.autograd.Function):
    """``x``, the same on every rank of ``group``, as it is; its
    gradient, each rank's partial sum, added over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Gathered(torch.autograd.Function):
    """``layer.gather(x)``, its gradient ``layer.reduce``."""

    @staticmethod
    def forward(ctx, x, layer):
        ctx.layer = layer
        return layer.gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.layer.reduce(g), None


class _Reduced(torch.autograd.Function):
    """``layer.total(layer.reduce(x))`` of partial sums ``x`` over every
    tok rank's rows, its gradient ``layer.gather``: each rank's gradient
    of the partial sums is every row's (a partial sum over the tok dims
    that shard the buffer: its rows' gradient whole; along the others
    alike on each rank, as ``x`` is; the sum ``total`` takes is
    replicated, and so is its gradient)."""

    @staticmethod
    def forward(ctx, x, layer):
        ctx.layer = layer
        return layer.total(layer.reduce(x))

    @staticmethod
    def backward(ctx, g):
        return ctx.layer.gather(g), None


def _routed_sharded(p, h, cap: int, act, cfg: ArchConfig):
    """The routed experts' sum (B, S, D) for the DTensor ``h``."""
    global local_calls
    local_calls += 1
    layer = _Sharded(h, p["router"].shape[1], cap, cfg)
    weights, slot = layer.route(h, p["router"])
    out = _experts(p, layer.dispatch(h, slot), act, cfg)
    return layer.combine(out, slot, weights)


def _fill(every, own, n: int, k: int):
    """The (n, D) rows of a piece of the dispatch buffer: the row of the
    token of the assignment ``own`` sends there (an assignment a row of
    the piece, or ``n``: elsewhere), zeros where none is sent. A gather
    of the piece's rows (``_dispatch`` scatters all T·K)."""
    t = every.shape[0]
    tok = torch.full((n + 1,), t, dtype=own.dtype, device=own.device)
    tok = tok.scatter(0, own, torch.arange(own.numel(), device=own.device)
                      // k)[:n]
    sent = tok < t
    return torch.where(sent[:, None], every[tok.clamp(max=t - 1)],
                       every.new_zeros(()))
