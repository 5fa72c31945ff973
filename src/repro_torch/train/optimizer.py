"""AdamW with optional int8-quantized moments: the reference's
``repro/train/optimizer.py`` on torch tensors.

Moments are stored per parameter either in float32 or as (int8 payload,
per-tensor float32 absmax scale); parameters stay in their own dtype
(``cfg.dtype``). ``_q8`` rounds half to even, as ``jnp.round`` does
(``torch.round`` does too). What changes against the reference:
:func:`adamw_update` writes the new parameters and moments into the old
tensors, where the reference returns new ones: on one card a
functional update would hold two copies of every moment at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from .tree import leaves, unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_moments: bool = False  # int8 m/v


# ---------------------------------------------------------------------------
# int8 moment codec
# ---------------------------------------------------------------------------

def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


class MomentState(NamedTuple):
    payload: torch.Tensor           # float32 or int8
    scale: torch.Tensor             # () float32; unused when float32


def _encode(x: torch.Tensor, quantize: bool) -> MomentState:
    if quantize:
        q, s = _q8(x)
        return MomentState(q, s)
    return MomentState(x.to(torch.float32),
                       torch.ones((), dtype=torch.float32, device=x.device))


def _decode(st: MomentState) -> torch.Tensor:
    if st.payload.dtype == torch.int8:
        return _dq8(st.payload, st.scale)
    return st.payload


class OptState(NamedTuple):
    step: torch.Tensor
    m: Any   # pytree of MomentState
    v: Any


def _moment_leaves(tree):
    """The MomentStates of a moment tree, in the params' leaf order."""
    flat = leaves(tree)
    return [MomentState(flat[i], flat[i + 1])
            for i in range(0, len(flat), 2)]


def init_opt_state(params, cfg: AdamWConfig) -> OptState:
    flat = leaves(params)
    device = flat[0].device if flat else "cpu"

    def moments():
        return unflatten(params, iter([
            _encode(torch.zeros_like(p, dtype=torch.float32),
                    cfg.quantize_moments)
            for p in flat]))

    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=moments(), v=moments())


def global_norm(grads) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.to(torch.float32)))
             for g in leaves(grads))
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(params, grads, state: OptState, cfg: AdamWConfig):
    """One AdamW step, written into the tensors of ``params`` and
    ``state``; returns them, (params, state)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0) if cfg.grad_clip > 0 else 1.0

    bc1 = 1.0 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1.0 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m_st, v_st):
        g32 = g.to(torch.float32) * clip
        m = cfg.b1 * _decode(m_st) + (1 - cfg.b1) * g32
        v = cfg.b2 * _decode(v_st) + (1 - cfg.b2) * torch.square(g32)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        p32 = p.to(torch.float32)
        if cfg.weight_decay > 0 and p.dim() >= 2:
            delta = delta + cfg.weight_decay * p32
        p.copy_((p32 - cfg.lr * delta).to(p.dtype))
        for old, new in ((m_st, m), (v_st, v)):
            new = _encode(new, cfg.quantize_moments)
            old.payload.copy_(new.payload)
            old.scale.copy_(new.scale)

    for p, g, m, v in zip(leaves(params), leaves(grads),
                          _moment_leaves(state.m), _moment_leaves(state.v),
                          strict=True):
        upd(p, g, m, v)
    state.step.copy_(step)
    return params, state


def opt_state_bytes(state: OptState) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(state))
