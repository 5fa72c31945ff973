"""Gradient compression for the data-parallel all-reduce: the
reference's ``repro/train/grad_compress.py`` on torch tensors.

  * ``int8`` — int8 with a per-leaf absmax scale; stochastic rounding
    where a ``torch.Generator`` is given (the reference takes a
    ``jax.random`` key: the two draw different numbers from one seed),
    round half to even otherwise.
  * ``topk`` — magnitude top-k sparsification with error feedback; the
    residual is carried to the next step.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from .tree import leaves, tree_map, unflatten


class CompressedGrad(NamedTuple):
    payload: torch.Tensor
    scale: torch.Tensor


def compress_int8(g: torch.Tensor,
                  gen: Optional[torch.Generator] = None) -> CompressedGrad:
    g32 = g.to(torch.float32)
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    x = g32 / scale
    if gen is not None:  # stochastic rounding
        x = torch.floor(x + torch.rand(x.shape, generator=gen,
                                       device=x.device))
    else:
        x = torch.round(x)
    q = torch.clamp(x, -127, 127).to(torch.int8)
    return CompressedGrad(q, scale.to(torch.float32))


def decompress_int8(c: CompressedGrad) -> torch.Tensor:
    return c.payload.to(torch.float32) * c.scale


def compress_tree_int8(grads, gen: Optional[torch.Generator] = None):
    return tree_map(lambda g: compress_int8(g, gen), grads)


def decompress_tree_int8(ctree):
    flat = leaves(ctree)
    return unflatten(_skeleton(ctree), iter([
        decompress_int8(CompressedGrad(flat[i], flat[i + 1]))
        for i in range(0, len(flat), 2)]))


def _skeleton(ctree):
    """The tree of ``ctree`` with each CompressedGrad as one leaf (its
    payload, so that a tied gradient stays one leaf)."""
    if isinstance(ctree, CompressedGrad):
        return ctree.payload
    if isinstance(ctree, dict):
        return {k: _skeleton(v) for k, v in ctree.items()}
    if isinstance(ctree, (list, tuple)):
        return type(ctree)(_skeleton(v) for v in ctree)
    return ctree


def roundtrip_int8(grads, gen: Optional[torch.Generator] = None):
    """compress→decompress (what each DP replica sends/receives)."""
    return decompress_tree_int8(compress_tree_int8(grads, gen))


# ---------------------------------------------------------------------------
# top-k with error feedback
# ---------------------------------------------------------------------------

class TopKState(NamedTuple):
    residual: Any  # pytree of float32 residuals


def init_topk_state(grads) -> TopKState:
    return TopKState(tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads))


def topk_sparsify(g: torch.Tensor, res: torch.Tensor,
                  frac: float) -> Tuple[torch.Tensor, torch.Tensor]:
    g32 = g.to(torch.float32) + res
    flat = g32.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = g32.abs() >= thresh
    sent = torch.where(mask, g32, torch.zeros((), dtype=torch.float32,
                                              device=g32.device))
    new_res = g32 - sent
    return sent, new_res


def topk_roundtrip(grads, state: TopKState,
                   frac: float = 0.05) -> Tuple[Any, TopKState]:
    outs = [topk_sparsify(g, r, frac)
            for g, r in zip(leaves(grads), leaves(state.residual),
                            strict=True)]
    sent = unflatten(grads, iter([o[0] for o in outs]))
    res = unflatten(grads, iter([o[1] for o in outs]))
    return sent, TopKState(res)
