"""Per-chip operation count of one eager step: the port's counterpart of
the reference's ``launch/hlo_analysis.py``.

The reference reads the optimized HLO of the compiled per-device SPMD
program and corrects XLA's ``cost_analysis()`` for ``while`` loops
(whose bodies it counts once) by their trip counts. Eager PyTorch runs
no ``while`` loop: every period, microbatch and loss chunk is its own
dispatched op, so nothing needs correcting (``max_trip_product`` is 1),
and there is no module text (the reference's ``hlo_bytes`` is gone).
:class:`OpCounter` is a ``TorchDispatchMode`` that sees every op of the
step; on DTensors it lets DTensor dispatch first (``NotImplemented``) and
counts the local ops each rank runs, on the local shards' shapes, as the
reference's per-device program counts:

  * flops            — ``torch.utils.flop_counter``'s formulas (matmuls,
                       convolutions, attention), with formulas registered
                       here for the port's custom ops: the flash
                       attention's forward and backward (torch's SDPA
                       counts) and the selective scan's (its recurrence's
                       operations per (batch, step, channel, state), as
                       ``chip_smoke.py`` bounds the kernels), so a kernel
                       call counts alike whether the kernel or its plain
                       version runs, or a meta tensor's shape function;
                       the scan's share also under a key of its own
                       (``flops_scan``: elementwise operations, where the
                       reference's ``hlo_analysis`` counts only dots);
                       the largest single call's by op
                       (``max_op_flops``);
  * memory bytes     — Σ (result + operand bytes) of every op that is not
                       a view (the reference's post-fusion boundaries;
                       eager has no fusion, so every op is a boundary),
                       at each tensor's own dtype;
  * collective bytes — result bytes of every ``c10d_functional``
                       collective (output-size convention), under the
                       reference's five kinds, with their counts.

Run it on meta tensors (the dry run: shapes only) or on real ones
(``chip_smoke.py`` phase 12 holds the two counts of one step together),
not under ``FakeTensorMode``, where DTensor's own metadata propagation
would reach it.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import (flop_registry, register_flop_formula,
                                      sdpa_backward_flop_count,
                                      sdpa_flop_count)

from repro_torch.kernels.flash_attention import ops as _flash_ops  # noqa: F401
from repro_torch.kernels.mamba_scan import ops as _scan_ops  # noqa: F401

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d_functional op name fragments → the reference's kinds
_KIND_OF = (("all_gather", "all-gather"), ("reduce_scatter",
                                            "reduce-scatter"),
            ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
            ("alltoall", "all-to-all"), ("broadcast", "collective-permute"),
            ("permute", "collective-permute"))

# the selective scan's operations per (batch, step, channel, state):
# forward exp, two products and a multiply-add for the state, and the
# multiply-add of y's contraction; the backward's recompute, adjoint and
# the four gradients' products (chip_smoke.py's SCAN_OPS, SCAN_BWD_OPS)
SCAN_FWD_OPS = 5
SCAN_BWD_OPS = 12


def _bhsd(shape) -> Tuple[int, int, int, int]:
    """(BH, S, D) as SDPA's (1, BH, S, D)."""
    return (1,) + tuple(shape)


def _register(target, formula) -> None:
    if target not in flop_registry:
        register_flop_formula(target)(formula)


def _flash_fwd_flops(q, k, v, *args, out_shape=None, **kwargs):
    return sdpa_flop_count(_bhsd(q), _bhsd(k), _bhsd(v))


def _flash_bwd_flops(q, k, v, o, do, *args, out_shape=None, **kwargs):
    return sdpa_backward_flop_count(_bhsd(do), _bhsd(q), _bhsd(k),
                                    _bhsd(v))


def _scan_fwd_flops(x, dt, bm, *args, out_shape=None, **kwargs):
    b, length, inner = x
    return SCAN_FWD_OPS * b * length * inner * bm[-1]


def _scan_bwd_flops(x, dt, bm, *args, out_shape=None, **kwargs):
    b, length, inner = x
    return SCAN_BWD_OPS * b * length * inner * bm[-1]


_register(torch.ops.repro_torch.flash_attention_fwd, _flash_fwd_flops)
_register(torch.ops.repro_torch.flash_attention_bwd, _flash_bwd_flops)
_register(torch.ops.repro_torch.mamba_scan_fwd, _scan_fwd_flops)
_register(torch.ops.repro_torch.mamba_scan_bwd, _scan_bwd_flops)
_SCAN_OPS = (torch.ops.repro_torch.mamba_scan_fwd,
             torch.ops.repro_torch.mamba_scan_bwd)


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _is_view(func) -> bool:
    schema = getattr(func, "_schema", None)
    return schema is not None and any(
        r.alias_info is not None and not r.alias_info.is_write
        for r in schema.returns)


def _collective_kind(func):
    if func.namespace not in ("_c10d_functional", "c10d_functional",
                              "_dtensor"):
        return None
    name = func.__name__
    if name.startswith("wait_tensor"):
        return None
    for frag, kind in _KIND_OF:
        if frag in name:
            return kind
    return None


def _under_fake_mode() -> bool:
    """Whether a ``FakeTensorMode`` is active: in a count of real or meta
    tensors, only while DTensor learns an op's output metadata by
    running it on global-shape fake tensors, no work of the step's."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


# DTensor's sharding propagation: where an op has no sharding rule of
# its own, torch 2.13 propagates through its decomposition, run on meta
# tensors of the global shape (an in-place ``index_copy_`` into a KV
# cache: the whole cache, in every layer). No rank runs those ops; they
# are not counted. Looked up by name: a torch without them has nothing
# to skip.
_PROPAGATION = ("propagate_op_sharding_non_cached",
                "_propagate_tensor_meta_non_cached")


class _Propagation:
    """While entered, marks every call of DTensor's propagation methods
    (:data:`_PROPAGATION`), so that the counter skips the ops run
    inside them."""

    def __init__(self):
        self.depth = 0
        self.saved = {}

    def __enter__(self):
        try:
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator
        except ImportError:
            return self
        for name in _PROPAGATION:
            fn = ShardingPropagator.__dict__.get(name)
            if fn is not None:
                self.saved[name] = fn
                setattr(ShardingPropagator, name, self._marked(fn))
        return self

    def _marked(self, fn):
        def marked(*args, **kwargs):
            self.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth -= 1
        return marked

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator

        for name, fn in self.saved.items():
            setattr(ShardingPropagator, name, fn)
        self.saved = {}


class OpCounter(TorchDispatchMode):
    """Counts what every op of the enclosed code does on this rank."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.scan_flops = 0.0
        self.memory_bytes = 0.0
        self.collective_bytes = 0.0
        self.per_kind: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.counts: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.by_op: Dict[str, float] = {}
        self.max_flops: Dict[str, float] = {}
        self.ops = 0

    def __enter__(self):
        if _under_fake_mode():
            raise RuntimeError("OpCounter counts real or meta tensors, not "
                               "under FakeTensorMode")
        self.propagation = _Propagation().__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self.propagation.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            # DTensor desugars into local ops (and collectives) first
            return NotImplemented
        out = func(*args, **kwargs)
        if not _under_fake_mode() and not self.propagation.depth:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        name = str(packet).replace("aten.", "")
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            self.flops += flops
            if packet in _SCAN_OPS:
                self.scan_flops += flops
            self.max_flops[name] = max(self.max_flops.get(name, 0.0), flops)
        kind = _collective_kind(func)
        res = _nbytes(out)
        if kind is not None:
            self.collective_bytes += res
            self.per_kind[kind] += res
            self.counts[kind] += 1
        if _is_view(func) or func.__name__.startswith("wait_tensor") \
                or not isinstance(out, (torch.Tensor, list, tuple)):
            return
        self.ops += 1
        b = float(res + _nbytes((args, kwargs)))
        self.memory_bytes += b
        self.by_op[name] = self.by_op.get(name, 0.0) + b

    def result(self) -> Dict[str, Any]:
        top = sorted(self.by_op.items(), key=lambda kv: -kv[1])[:10]
        return {
            "flops_corrected": self.flops,
            "flops_scan": self.scan_flops,
            "memory_bytes_corrected": self.memory_bytes,
            "collective_bytes_corrected": self.collective_bytes,
            "collective_per_kind": dict(self.per_kind),
            "collective_counts": dict(self.counts),
            "max_trip_product": 1,
            "top_memory_opcodes": {k: v for k, v in top},
            "max_op_flops": dict(self.max_flops),
            "ops": self.ops,
        }


def analyze_step(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once under :class:`OpCounter` and
    return its counts (the reference's ``analyze_compiled`` keys)."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.result()

