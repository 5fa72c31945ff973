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
