"""Auto-sharding planner: the paper's inter-node parallelization applied
to LM training/serving steps.

The compiler's `pfor (output=…, input=…, transfer=…)` clause (paper §4.3)
reappears here as a *sharding plan*: for every parameter/activation leaf
(annotated with logical axes by the model zoo), the planner

  1. enumerates candidate strategies (DP / FSDP / FSDP×TP),
  2. filters by LEGALITY — divisibility of each logical axis by its mesh
     axes and per-chip HBM fit (the paper's type/rank runtime checks become
     static shape checks; §4.1 decision-tree top level),
  3. scores by PROFITABILITY — a three-term roofline estimate from the
     knowledge base (compute / memory / collective; §4.1 lower level),

and emits a :class:`MeshSharding` per leaf: the spec (one entry per
tensor dimension: ``None``, a mesh axis name, or a tuple of axis names,
the counterpart of a ``PartitionSpec``) and the DTensor placements it
means (one ``Shard(d)`` / ``Replicate()`` per mesh dimension, for
``distribute_tensor``). Per-leaf fallbacks implement the paper's
multi-versioning: an indivisible axis falls back to the next legal
mapping (e.g. gemma2's 8 heads < tp=16 → shard head_dim or fold the
model axis into the embed axis) instead of failing the arch.

The reference's ``repro/core/planner.py`` on PyTorch: the same
strategies, legality rules and estimate, line for line. A mesh is read
only through its axis names and sizes, so a ``DeviceMesh``
(``launch/mesh.py``) and a plain stand-in with ``axis_names``, a
``shape`` dict and ``size`` both work. The estimate is priced on
:data:`~repro_torch.core.cost.H100_SXM` unless ``chip=`` says otherwise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.models.common import ArchConfig

from .cost import H100_SXM, ChipSpec

# A spec: one entry per tensor dimension (None, an axis name, or a tuple
# of axis names in mesh order)
Spec = Tuple[Any, ...]


# ---------------------------------------------------------------------------
# Mesh access (axis names and sizes only)
# ---------------------------------------------------------------------------

def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names: ``axis_names`` of a stand-in, or a
    ``DeviceMesh``'s ``mesh_dim_names``."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}: a stand-in's ``shape`` dict, or a
    ``DeviceMesh``'s shape tuple by its dimension names."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), tuple(shape)))


def mesh_chips(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


# ---------------------------------------------------------------------------
# Shardings
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class MeshSharding:
    """A leaf's sharding on ``mesh``: ``spec`` per tensor dimension, and
    its DTensor ``placements`` per mesh dimension. A dimension sharded
    over several mesh axes takes them in mesh order (the only order the
    planner produces, and DTensor's own for several ``Shard`` of one
    dimension)."""

    mesh: Any
    spec: Spec

    def __post_init__(self):
        names = axis_names(self.mesh)
        seen: List[str] = []
        for entry in self.spec:
            axes = _entry_axes(entry)
            order = [names.index(a) for a in axes]
            assert order == sorted(order), (
                f"spec {self.spec}: {axes} not in mesh order {names}")
            assert not set(axes) & set(seen), (
                f"spec {self.spec} uses a mesh axis twice")
            seen.extend(axes)

    @property
    def placements(self) -> tuple:
        """One per mesh dimension: ``Shard(d)`` where the spec puts the
        axis on tensor dimension d, else ``Replicate()`` (so too for an
        axis of size 1, over which a shard is the whole)."""
        from torch.distributed.tensor import Replicate, Shard

        sizes = axis_sizes(self.mesh)
        out = []
        for name in axis_names(self.mesh):
            dims = [d for d, entry in enumerate(self.spec)
                    if name in _entry_axes(entry)]
            out.append(Shard(dims[0]) if dims and sizes[name] > 1
                       else Replicate())
        return tuple(out)


def map_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a tree of logical-axis tuples (the
    model zoo's ``specs``) and the matching leaves of ``trees`` (nested
    dicts and lists of the same structure)."""
    if isinstance(specs, tuple) and all(isinstance(e, str) for e in specs):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    return type(specs)(map_specs(fn, v, *(t[i] for t in trees))
                       for i, v in enumerate(specs))


# ---------------------------------------------------------------------------
# Strategy definitions
# ---------------------------------------------------------------------------

@dataclass
class Strategy:
    """Maps logical axes to mesh-axis preference lists."""

    name: str
    # logical axis → ordered candidate mesh-axis tuples (first legal wins;
    # None = replicate)
    rules: Dict[str, List[Optional[Tuple[str, ...]]]]
    batch_axes: Tuple[str, ...]          # data-parallel mesh axes


def make_strategies(mesh) -> List[Strategy]:
    axes = axis_names(mesh)
    dp: Tuple[str, ...] = tuple(a for a in axes if a in ("pod", "data"))
    all_axes: Tuple[str, ...] = tuple(axes)
    tp = ("model",) if "model" in axes else ()
    fsdp = dp
    tp_l: List[Optional[Tuple[str, ...]]] = [tp, None] if tp else [None]

    strategies = [
        Strategy(
            name="fsdp_tp",
            rules={
                "vocab": tp_l,
                # GQA: kv_heads takes the model axis when divisible;
                # otherwise head_dim (must mirror cache_sharding priority)
                "heads": tp_l,
                "kv_heads": tp_l,
                "head_dim": tp_l,
                "mlp": tp_l,
                "experts": tp_l,
                "inner": tp_l,
                "ssm": [None],
                "embed": [fsdp, None],
                "layers": [None],
            },
            batch_axes=dp,
        ),
        Strategy(
            name="fsdp",
            # ZeRO-3 style: every parameter fully sharded over the whole
            # mesh on its largest legal dim; activations batch-sharded
            # over the whole mesh too.
            rules={
                "vocab": [all_axes, fsdp, None],
                "heads": [None],
                "kv_heads": [None],
                "head_dim": [None],
                "mlp": [all_axes, fsdp, None],
                "experts": [all_axes, fsdp, None],
                "inner": [all_axes, fsdp, None],
                "ssm": [None],
                "embed": [all_axes, fsdp, None],
                "layers": [None],
            },
            batch_axes=all_axes,
        ),
        Strategy(
            name="dp",
            rules={k: [None] for k in
                   ("vocab", "heads", "kv_heads", "head_dim", "mlp",
                    "experts", "inner", "ssm", "embed", "layers")},
            batch_axes=all_axes,
        ),
    ]
    return strategies


def _mesh_size(mesh, axes: Optional[Tuple[str, ...]]) -> int:
    if not axes:
        return 1
    sizes = axis_sizes(mesh)
    out = 1
    for a in axes:
        out *= sizes[a]
    return out


# ---------------------------------------------------------------------------
# Per-leaf spec resolution (legality with fallback)
# ---------------------------------------------------------------------------

def resolve_leaf_spec(shape: Tuple[int, ...], logical: Tuple[str, ...],
                      strategy: Strategy, mesh) -> Spec:
    """Choose mesh axes per dim: first legal candidate, each mesh axis used
    at most once per leaf."""
    used: set = set()
    parts: List[Any] = []
    for dim, axis_name in zip(shape, logical):
        choice: Optional[Tuple[str, ...]] = None
        for cand in strategy.rules.get(axis_name, [None]):
            if cand is None:
                choice = None
                break
            if any(a in used for a in cand):
                continue
            if dim % _mesh_size(mesh, cand) == 0:
                choice = cand
                break
        if choice:
            used.update(choice)
            parts.append(choice if len(choice) > 1 else choice[0])
        else:
            parts.append(None)
    # big 2-D+ leaves with an unused model axis: fold model into the embed
    # dim when divisible (gemma2 fallback — row-parallel attention)
    if ("model" in axis_names(mesh) and "model" not in used
            and strategy.name == "fsdp_tp"):
        nbytes = math.prod(shape)
        if nbytes >= 1 << 20:
            for i, (dim, axis_name) in enumerate(zip(shape, logical)):
                if axis_name != "embed":
                    continue
                prev = parts[i]
                prev_t = (prev,) if isinstance(prev, str) else \
                    (tuple(prev) if prev else ())
                cand = prev_t + ("model",)
                if dim % _mesh_size(mesh, cand) == 0:
                    parts[i] = cand if len(cand) > 1 else cand[0]
                    used.add("model")
                    break
    return tuple(parts)


def plan_params(specs, shapes, strategy: Strategy, mesh):
    """specs: tree of logical-axis tuples; shapes: matching tree of
    anything with a ``.shape`` (tensors, fake tensors). Returns the tree
    of :class:`MeshSharding`."""
    def mk(logical, shp):
        spec = resolve_leaf_spec(tuple(shp.shape), logical, strategy, mesh)
        return MeshSharding(mesh, spec)

    return map_specs(mk, specs, shapes)


# ---------------------------------------------------------------------------
# Batch / cache shardings
# ---------------------------------------------------------------------------

def batch_sharding(mesh, strategy: Strategy, batch: int,
                   extra_dims: int = 1) -> MeshSharding:
    """(B, …): shard B over the dp axes that divide it."""
    # choose the largest dp prefix that divides batch
    chosen: Tuple[str, ...] = ()
    for i in range(len(strategy.batch_axes), 0, -1):
        cand = strategy.batch_axes[:i]
        if batch % _mesh_size(mesh, cand) == 0:
            chosen = cand
            break
    spec = [chosen if len(chosen) > 1 else
            (chosen[0] if chosen else None)] + [None] * extra_dims
    return MeshSharding(mesh, tuple(spec))


def cache_sharding(mesh, strategy: Strategy, cfg: ArchConfig,
                   batch: int, leaf_shape: Tuple[int, ...]) -> MeshSharding:
    """Decode caches: (n_periods, B, S, KVH, HD) KV tensors, (n_periods, B)
    indices, (n_periods, B, …) ssm states. Shard B over dp when divisible,
    the trailing feature dim over model when divisible."""
    ndim = len(leaf_shape)
    parts: List[Any] = [None] * ndim
    # batch dim is axis 1 when present
    if ndim >= 2 and leaf_shape[1] == batch:
        chosen: Tuple[str, ...] = ()
        for i in range(len(strategy.batch_axes), 0, -1):
            cand = strategy.batch_axes[:i]
            if batch % _mesh_size(mesh, cand) == 0:
                chosen = cand
                break
        if chosen:
            parts[1] = chosen if len(chosen) > 1 else chosen[0]
    if ndim >= 4 and "model" in axis_names(mesh) \
            and strategy.name == "fsdp_tp":
        # try kv_heads (axis -2) then head_dim (axis -1)
        m = axis_sizes(mesh)["model"]
        if leaf_shape[-2] % m == 0 and leaf_shape[-2] > 1:
            parts[-2] = "model"
        elif leaf_shape[-1] % m == 0:
            parts[-1] = "model"
    return MeshSharding(mesh, tuple(parts))


# ---------------------------------------------------------------------------
# Analytic roofline (profitability scoring)
# ---------------------------------------------------------------------------

@dataclass
class PlanEstimate:
    strategy: str
    hbm_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    legal: bool
    note: str = ""
    microbatch: int = 1          # planner-adapted grad-accumulation steps

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s) + self.collective_s


def effective_dp(mesh, batch_axes: Tuple[str, ...], rows: int) -> int:
    """Largest prefix of batch_axes whose size divides ``rows`` — the DP
    extent the sharded step can actually use. Anything less than the full
    product leaves trailing axes REPLICATING compute (the silent waste
    the estimate must see)."""
    for i in range(len(batch_axes), 0, -1):
        size = _mesh_size(mesh, batch_axes[:i])
        if rows % size == 0:
            return size
    return 1


def adapt_microbatch(cfg: ArchConfig, batch: int, mesh,
                     batch_axes: Tuple[str, ...]) -> Tuple[int, int]:
    """Choose (microbatch, effective_dp): maximize DP utilization first
    (a replicated model axis is a compute waste), then accumulation
    depth (memory relief). The paper's legality-branch resolution: adjust
    the variant instead of failing."""
    best = (1, effective_dp(mesh, batch_axes, batch))
    for mb in range(1, max(1, cfg.microbatch) + 1):
        if batch % mb:
            continue
        eff = effective_dp(mesh, batch_axes, batch // mb)
        if (eff, mb) > (best[1], best[0]):
            best = (mb, eff)
    return best


def estimate_plan(cfg: ArchConfig, strategy: Strategy, mesh,
                  seq: int, batch: int, kind: str,
                  chip: ChipSpec = H100_SXM) -> PlanEstimate:
    chips = mesh_chips(mesh)
    tp = axis_sizes(mesh).get("model", 1) \
        if strategy.name == "fsdp_tp" else 1
    if kind == "train":
        mb, dp = adapt_microbatch(cfg, batch, mesh, strategy.batch_axes)
    else:
        mb = 1
        dp = effective_dp(mesh, strategy.batch_axes, batch)
    # chips not covered by dp×tp replicate compute — chargeable waste
    replication = chips / max(1, dp * tp)
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    p_bytes = 2.0 * n_params
    if strategy.name == "dp":
        shard = 1
    elif strategy.name == "fsdp":
        shard = chips  # params fully sharded regardless of batch extent
    else:
        shard = _mesh_size(mesh, strategy.batch_axes) * tp
    param_per_chip = p_bytes / shard

    tokens = batch * seq if kind != "decode" else batch
    flops = (6.0 if kind == "train" else 2.0) * n_active * tokens
    compute_s = flops * replication / (chips * chip.peak_flops)

    # memory term: params read once per microbatch pass + activations
    act_bytes = 2.0 * tokens / max(1, dp) * cfg.d_model * cfg.layers / \
        max(1, mb)
    if cfg.seq_shard and tp > 1:
        act_bytes /= tp  # sequence-parallel checkpoints
    passes = mb if kind == "train" else 1
    mem_bytes = param_per_chip * passes + act_bytes
    memory_s = mem_bytes / chip.hbm_bw

    # collective term (per chip): FSDP all-gather of params + DP grad
    # reduce-scatter (train) + TP activation psum
    coll = 0.0
    if strategy.name in ("fsdp", "fsdp_tp") and dp > 1:
        coll += param_per_chip * (dp - 1) / dp * passes      # all-gather
        if kind == "train":
            coll += 2.0 * param_per_chip * (dp - 1) / dp     # grad RS+AG
    if tp > 1:
        act = 2.0 * tokens / max(1, dp) * cfg.d_model
        coll += 2.0 * act * cfg.layers * (tp - 1) / tp / max(1, mb)
    collective_s = coll / chip.ici_bw

    # HBM legality (bytes relative to bf16 params: grads f32 = 2×,
    # moments int8 = 1× / f32 = 4×)
    if kind == "train":
        opt_mult = 2.0 + (1.0 if cfg.opt_8bit else 4.0)
        hbm = param_per_chip * (1.0 + opt_mult) + act_bytes * 2
    else:
        kv = 0.0
        if kind in ("prefill", "decode"):
            n_attn = sum(1 for i in range(cfg.period)
                         if cfg.layer_kind(i) == "attn") * cfg.n_periods
            kv = 2.0 * 2.0 * batch * seq * cfg.kv_heads * cfg.head_dim \
                * n_attn
            kv /= max(1, dp if batch % dp == 0 else 1)
            kv /= max(1, tp if (cfg.kv_heads % tp == 0
                                or cfg.head_dim % tp == 0) else 1)
        hbm = param_per_chip + kv + act_bytes * 2
    legal = hbm < chip.hbm_bytes * 0.92
    return PlanEstimate(strategy.name, hbm, compute_s, memory_s,
                        collective_s, legal, microbatch=mb)


# ---------------------------------------------------------------------------
# Top-level plan
# ---------------------------------------------------------------------------

@dataclass
class ShardingPlan:
    strategy: Strategy
    estimate: PlanEstimate
    param_shardings: Any
    mesh: Any
    alternatives: List[PlanEstimate] = field(default_factory=list)

    def describe(self) -> str:
        e = self.estimate
        lines = [f"plan: {self.strategy.name}  "
                 f"hbm/chip={e.hbm_bytes_per_chip/2**30:.2f}GiB  "
                 f"compute={e.compute_s*1e3:.2f}ms "
                 f"memory={e.memory_s*1e3:.2f}ms "
                 f"collective={e.collective_s*1e3:.2f}ms"]
        for a in self.alternatives:
            lines.append(f"  alt {a.strategy}: step={a.step_s*1e3:.2f}ms "
                         f"hbm={a.hbm_bytes_per_chip/2**30:.2f}GiB "
                         f"legal={a.legal}")
        return "\n".join(lines)


def plan(cfg: ArchConfig, specs, param_shapes, mesh, *, seq: int,
         batch: int, kind: str, chip: ChipSpec = H100_SXM) -> ShardingPlan:
    """Pick the min-cost legal strategy; emit each param's
    :class:`MeshSharding`."""
    cands = []
    for st in make_strategies(mesh):
        est = estimate_plan(cfg, st, mesh, seq, batch, kind, chip)
        cands.append((st, est))
    legal = [(st, e) for st, e in cands if e.legal]
    pool = legal if legal else cands  # nothing fits: pick least-bad
    if getattr(cfg, "force_strategy", None):
        forced = [(st, e) for st, e in cands
                  if st.name == cfg.force_strategy]
        pool = forced or pool
    st, est = min(pool, key=lambda p: p[1].step_s)
    shardings = plan_params(specs, param_shapes, st, mesh)
    return ShardingPlan(st, est, shardings, mesh,
                        alternatives=[e for _, e in cands])
