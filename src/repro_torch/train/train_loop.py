"""Training step factory: grad accumulation, remat, compression, optimizer
— the reference's ``repro/train/train_loop.py`` on torch tensors.

``make_train_step(cfg)`` returns

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

with the global batch split into ``cfg.microbatch`` accumulation steps
run in turn (each microbatch's loss rematerialized per period where
``cfg.remat`` asks: ``models/transformer.py``), their gradients summed
in float32 and averaged, optional int8 gradient compression, and AdamW
(optionally 8-bit moments) applied once. Where the reference's step is
a pure function, this one writes the new parameters and moments into
the given tensors (one card cannot hold two copies of a model's
optimizer state) and returns them. ``mark``, where given,
is called with "forward", "backward", "optimizer" and "end" as each
phase of a step begins and the step ends (a caller's timer: CUDA
events); it costs nothing when left out.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels.sharded import is_dtensor
from repro_torch.models import transformer as T
from repro_torch.models.common import ArchConfig

from . import grad_compress
from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .tree import leaves, unflatten


def _split_rows(x, n: int):
    """A DTensor's n microbatches, each rank splitting its own rows, as
    data parallelism does: microbatch i holds every rank's i-th part and
    is sharded as ``x`` is (other rows than the whole batch's split into
    n, the same rows in all; a reshape of a batch sharded over more
    ranks than a microbatch has rows cannot be sharded)."""
    from torch.distributed.tensor.experimental import local_map

    rows = x.to_local().shape[0]
    if rows % n:
        raise ValueError(f"{rows} rows a rank do not split into {n} "
                         f"microbatches")
    pl = x.placements
    return local_map(lambda t: tuple(t.chunk(n)), out_placements=(pl,) * n,
                     in_placements=(pl,), device_mesh=x.device_mesh)(x)


def _split_microbatches(batch: Dict, n: int) -> List[Dict]:
    """(B, …) → n microbatches of (B/n, …), every leaf split alike."""
    def split(x):
        b = x.shape[0]
        assert b % n == 0, f"global batch {b} not divisible by {n}"
        if is_dtensor(x):
            return _split_rows(x, n)
        return x.reshape(n, b // n, *x.shape[1:])

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_loss_fn(cfg: ArchConfig):
    def loss_fn(params, microbatch):
        return T.loss_fn(params, microbatch, cfg)

    return loss_fn


Mark = Optional[Callable[[str], None]]


def _no_mark(_: str) -> None:
    pass


def value_and_grad(loss_fn, params, batch, mark: Mark = None
                   ) -> Tuple[torch.Tensor, List]:
    """(loss, the gradient of every leaf of ``params`` in leaf order, in
    the leaf's dtype): the reference's ``jax.value_and_grad`` on torch,
    through leaves that alias the parameters' storage. Each gradient is
    a tensor of its own: autograd hands one tensor to every input of a
    sum, and a tree holding one tensor at two places ties them
    (``tree.py``), so a repeat is copied."""
    mark = mark or _no_mark
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        mark("forward")
        loss = loss_fn(unflatten(params, iter(flat)), batch)
        mark("backward")
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    mark("end")
    out, seen = [], set()
    for p, g in zip(flat, grads):
        if g is None:
            g = torch.zeros_like(p)
        elif id(g) in seen:
            g = g.clone()
        seen.add(id(g))
        out.append(g)
    return loss.detach(), out


def accumulate_grads(cfg: ArchConfig, params, batch, mark: Mark = None
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(mean loss, mean gradient of every leaf, in leaf order) over the
    ``cfg.microbatch`` microbatches of ``batch``: the gradient a train
    step applies, summed in float32. With one microbatch each leaf's
    gradient stays in the leaf's dtype: its float32 value is the same,
    and every reader (the optimizer, the norm) takes it in float32; a
    model at full width on one card has no room for a float32 copy."""
    loss_fn = make_loss_fn(cfg)
    n = max(1, cfg.microbatch)
    if n == 1:
        loss, grads = value_and_grad(loss_fn, params, batch, mark)
        return loss.to(torch.float32), grads
    gsum = lsum = None
    for mb in _split_microbatches(batch, n):
        loss, grads = value_and_grad(loss_fn, params, mb, mark)
        if gsum is None:
            gsum = [torch.zeros_like(g, dtype=torch.float32)
                    for g in grads]
            lsum = torch.zeros((), dtype=torch.float32, device=loss.device)
        for a, g in zip(gsum, grads):
            a.add_(g.to(torch.float32))
        del grads
        lsum = lsum + loss.to(torch.float32)
    for g in gsum:
        g.div_(n)
    return lsum / n, gsum


def _summed(grads, params) -> List:
    """Each gradient on its parameter's placements (DTensors only): a
    partial sum over the batch's mesh axes summed once, one all-reduce
    or reduce-scatter a leaf, as GSPMD reduces each gradient once; a
    partial sum left as it is would be summed again at each of the
    optimizer's and the norm's reads (five all-reduces a leaf)."""
    if not is_dtensor(*grads):
        return grads
    return [g.redistribute(g.device_mesh, p.placements)
            if is_dtensor(g) and tuple(g.placements) != tuple(p.placements)
            else g for g, p in zip(grads, params)]


def loss_and_grads(cfg: ArchConfig, params, batch, mark: Mark = None):
    """(mean loss, the gradient tree shaped as ``params``, each leaf on
    its parameter's placements): a train step before its optimizer."""
    loss, gsum = accumulate_grads(cfg, params, batch, mark)
    return loss, unflatten(params, iter(_summed(gsum, leaves(params))))


def grad_norm(grads):
    """The gradient tree's global norm, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in leaves(grads)))


def make_train_step(cfg: ArchConfig, opt_cfg: Optional[AdamWConfig] = None,
                    compress: Optional[str] = None, mark: Mark = None):
    opt_cfg = opt_cfg or AdamWConfig(quantize_moments=cfg.opt_8bit)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch, mark)
        if compress == "int8":
            grads = grad_compress.roundtrip_int8(grads)
        (mark or _no_mark)("optimizer")
        new_params, new_opt = adamw_update(params, grads, opt_state,
                                           opt_cfg)
        (mark or _no_mark)("end")
        metrics = {
            "loss": loss,
            "grad_norm": grad_norm(grads),
            "step": new_opt.step.clone(),
        }
        return new_params, new_opt, metrics

    return train_step


def make_init(cfg: ArchConfig, opt_cfg: Optional[AdamWConfig] = None):
    opt_cfg = opt_cfg or AdamWConfig(quantize_moments=cfg.opt_8bit)

    def init(gen: torch.Generator):
        params, specs = T.init_params(cfg, gen)
        opt_state = init_opt_state(params, opt_cfg)
        return params, opt_state, specs

    return init
