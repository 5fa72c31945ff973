"""DTensor helpers shared by the kernels' ops and the models.

A kernel's op takes DTensor inputs through ``local_map``: each rank runs
the op's plain-tensor path (the kernel on the card, its plain version on
CPU or fake tensors) on its local slice, over the dimensions the kernel
can split (batch and heads for attention, batch and channels for the
scan); any other sharding of an input is gathered first. These helpers
build those placements. ``torch.distributed.tensor`` is looked up in
``sys.modules`` (:func:`is_dtensor`): where nothing has loaded it, no
DTensor exists, and a plain-tensor call costs one dictionary lookup.
"""

from __future__ import annotations

import sys
from typing import Iterable, Sequence

import torch


def is_dtensor(*ts) -> bool:
    """Whether any of ``ts`` is a DTensor."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and any(isinstance(t, mod.DTensor) for t in ts)


def mesh_of(*ts):
    """The device mesh of the first DTensor among ``ts``."""
    return next(t.device_mesh for t in ts if is_dtensor(t))


def as_dtensor(t, mesh):
    """``t`` as a DTensor on ``mesh``: a plain tensor is the same tensor
    on every rank (replicated)."""
    from torch.distributed.tensor import DTensor, Replicate

    if is_dtensor(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def keep_shards(placements, dims: Iterable[int], shape: Sequence[int],
                mesh) -> list:
    """``placements`` with each ``Shard(d)`` of a dimension in ``dims``
    kept where the dimension splits evenly over its mesh dimensions, and
    every other placement (a shard of another dimension, a partial sum)
    replaced by ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    dims = set(dims)
    out = [p if isinstance(p, Shard) and p.dim in dims else Replicate()
           for p in placements]
    for d in dims:
        n = shards(out, d, mesh)
        if shape[d] % n:
            out = [Replicate() if isinstance(p, Shard) and p.dim == d
                   else p for p in out]
    return out


def shards(placements, dim: int, mesh) -> int:
    """How many pieces ``placements`` cut tensor dimension ``dim`` into."""
    from torch.distributed.tensor import Shard

    n = 1
    for m, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= mesh.size(m)
    return n


def shard_index(placements, dim: int, mesh) -> int:
    """This rank's piece of tensor dimension ``dim`` under ``placements``
    (mesh dimensions that shard it nest in mesh order)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    idx = 0
    for m, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            idx = idx * mesh.size(m) + coord[m]
    return idx


def remap(placements, dims: dict) -> list:
    """Placements for another tensor: ``Shard(d)`` becomes
    ``Shard(dims[d])`` (``Replicate()`` where ``dims[d]`` is None or ``d``
    is not in ``dims``)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for p in placements:
        to = dims.get(p.dim) if isinstance(p, Shard) else None
        out.append(Shard(to) if to is not None else Replicate())
    return out


def gather_over(t, mdims):
    """``t`` (a DTensor) whole over the mesh dimensions ``mdims``, its
    other placements kept. Where several of them shard one tensor
    dimension, and they are the innermost that shard it, that dimension
    is gathered by one all-gather over their flattened group
    (:class:`_FlatGather`), as GSPMD gathers over a product of mesh
    axes: DTensor's redistribute takes one mesh dimension at a time, and
    each step's all-gather moves its output again (1.5x the bytes of
    one gather over a 2x2 group)."""
    from torch.distributed.tensor import Replicate, Shard

    mdims = set(mdims)
    place = list(t.placements)
    by_dim: dict = {}
    for m in sorted(mdims):
        if type(place[m]) is Shard:
            by_dim.setdefault(place[m].dim, []).append(m)
    for d, ms in by_dim.items():
        sharding = [m for m, p in enumerate(place)
                    if isinstance(p, Shard) and p.dim == d]
        if (len(ms) < 2 or sharding[-len(ms):] != ms
                or t.shape[d] % shards(place, d, t.device_mesh)):
            continue
        out = [Replicate() if m in ms else p for m, p in enumerate(place)]
        t = _FlatGather.apply(t, d, tuple(ms), tuple(out))
        place = out
    out = [Replicate() if m in mdims else p for m, p in enumerate(place)]
    if out == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, out)


def regrid(t, dim: int, mdims):
    """``t`` (a DTensor) sharded on its dimension ``dim`` over the mesh
    dimensions ``mdims`` (nested in mesh order) and whole over the
    others. Where ``t`` lies on one other dimension over exactly those
    mesh dimensions (a weight's FSDP shard, wanted on another of its
    dimensions), one all-to-all over their flattened group moves it
    (:class:`_AllToAll`), as GSPMD reshards; otherwise DTensor's own
    redistribute does."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = t.device_mesh
    mdims = sorted(mdims)
    want = [Shard(dim) if m in mdims else Replicate()
            for m in range(mesh.ndim)]
    if list(t.placements) == want:
        return t
    on = [m for m, p in enumerate(t.placements) if type(p) is Shard]
    src = {t.placements[m].dim for m in on}
    n = 1
    for m in mdims:
        n *= mesh.size(m)
    if (on == mdims and len(src) == 1 and not any(
            p.is_partial() for p in t.placements)
            and t.shape[dim] % n == 0 and t.shape[min(src)] % n == 0):
        return _AllToAll.apply(t, src.pop(), dim, tuple(mdims),
                               tuple(want))
    return t.redistribute(mesh, want)


def _all_to_all(x, src: int, dst: int, mesh, mdims):
    """This rank's piece ``x``, a block of dimension ``src`` (the group
    rank's, in order), as its block of dimension ``dst`` instead: ``x``'s
    ``dst`` cut into one block a rank of the flattened group over
    ``mdims``, block j sent to rank j, and the blocks received joined
    along ``src`` in rank order."""
    n = 1
    for m in mdims:
        n *= mesh.size(m)
    if n == 1:
        return x
    rows = x.movedim(dst, 0).contiguous()
    split = [rows.shape[0] // n] * n
    ops = torch.ops._c10d_functional
    got = ops.wait_tensor(ops.all_to_all_single(
        rows, split, split, group_name(mesh, list(mdims)))).movedim(0, dst)
    return torch.cat(got.chunk(n, dst), dim=src).contiguous()


class _AllToAll(torch.autograd.Function):
    """A DTensor sharded on dimension ``src`` over the mesh dimensions
    ``mdims`` resharded on ``dst`` over them by one all-to-all; its
    gradient goes back by the inverse one."""

    @staticmethod
    def forward(ctx, t, src, dst, mdims, out_placements):
        from torch.distributed.tensor import DTensor

        mesh = t.device_mesh
        ctx.meta = (mesh, tuple(t.placements), src, dst, mdims,
                    out_placements)
        return DTensor.from_local(
            _all_to_all(t.to_local(), src, dst, mesh, mdims), mesh,
            list(out_placements), run_check=False)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        mesh, placements, src, dst, mdims, out = ctx.meta
        if tuple(g.placements) != tuple(out):
            g = g.redistribute(mesh, list(out))
        local = _all_to_all(g.to_local(), dst, src, mesh, mdims)
        return (DTensor.from_local(local, mesh, list(placements),
                                   run_check=False),
                None, None, None, None)


def _flat_group(mesh, mdims):
    """The 1-D mesh of ``mesh``'s dimensions ``mdims`` flattened (ranks in
    mesh order; the root mesh keeps it by name, its group made once)."""
    names = tuple(mesh.mesh_dim_names[m] for m in mdims)
    return mesh[names]._flatten("_".join(names))


def group_name(mesh, mdims) -> str:
    """The name, as the functional collectives take it, of the process
    group over ``mesh``'s dimensions ``mdims`` (several: flattened, ranks
    in mesh order)."""
    if len(mdims) == 1:
        return mesh.get_group(mdims[0]).group_name
    return _flat_group(mesh, mdims).get_group().group_name


class _FlatGather(torch.autograd.Function):
    """Tensor dimension ``dim`` of a DTensor, sharded (nested, in mesh
    order) over the mesh dimensions ``mdims``, gathered by one
    all-gather over their flattened group. The gradient comes back by
    one reduce-scatter where it is a partial sum over those dimensions
    (a product over the rows they shard), else by each rank's slice."""

    @staticmethod
    def forward(ctx, t, dim, mdims, out_placements):
        from torch.distributed.tensor import DTensor

        mesh = t.device_mesh
        group = _flat_group(mesh, mdims)
        ctx.meta = (mesh, tuple(t.placements), dim, mdims, group)
        ops = torch.ops._c10d_functional
        # the collective ops themselves (stable across torch versions;
        # funcol's wrappers are not): along dim 0, in group rank order
        local = ops.wait_tensor(ops.all_gather_into_tensor(
            t.to_local().movedim(dim, 0).contiguous(), group.size(),
            group.get_group().group_name)).movedim(0, dim)
        return DTensor.from_local(local, mesh, out_placements,
                                  run_check=False)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate

        mesh, placements, dim, mdims, group = ctx.meta
        partial = all(g.placements[m].is_partial() for m in mdims)
        want = [(g.placements[m] if partial else Replicate())
                if m in mdims else placements[m] for m in range(mesh.ndim)]
        if want != list(g.placements):
            g = g.redistribute(mesh, want)
        local, n = g.to_local(), group.size()
        if partial:
            ops = torch.ops._c10d_functional
            local = ops.wait_tensor(ops.reduce_scatter_tensor(
                local.movedim(dim, 0).contiguous(), "sum", n,
                group.get_group().group_name)).movedim(0, dim)
        else:
            local = local.chunk(n, dim)[group.get_local_rank()]
        return (DTensor.from_local(local.contiguous(), mesh, placements,
                                   run_check=False), None, None, None)
