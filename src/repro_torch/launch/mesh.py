"""Production and host meshes of the port, as ``DeviceMesh`` objects.

Single-pod: (data=32, model=8) = 256 H100s, 32 nodes of 8 cards, with
``model`` inside a node, on its NVLink. Multi-pod: (pod=2, data=32,
model=8) = 512 cards; the ``pod`` axis composes with ``data`` for
hierarchical data parallelism. The reference's TPU pod put 16 chips on
its ``model`` axis; an H100 node has 8 cards on one NVLink switch, so
tensor parallelism stops at 8 here and ``data`` takes the other factor
of 2, which keeps the chip counts (256, 512) of the reference's meshes.

The production meshes sit over a ``fake`` process group of that many
ranks (this process is rank 0; collectives move nothing): the
counterpart of the reference's 512 placeholder XLA host devices, for
the dry run (``launch/dryrun.py``), which runs on the host. A torch
without the ``fake`` backend raises :class:`FakeBackendUnavailable`;
nothing falls back to a smaller mesh.

:func:`make_host_mesh` is a mesh over the devices this process drives:
with no process group up, a 1-rank ``nccl`` group on the card (the
default) or a 1-rank ``gloo`` group for ``device="cpu"``; where the
caller has started a group (``torchrun``), its ranks.

The default process group belongs to the whole process, so this module
owns its setup and teardown: one mesh size a process, or
:func:`release` before a mesh of another size or backend. Defined as
functions, so importing this module starts no group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SINGLE_POD = ((32, 8), ("data", "model"))
MULTI_POD = ((2, 32, 8), ("pod", "data", "model"))


class FakeBackendUnavailable(RuntimeError):
    """This torch has no ``fake`` process-group backend, which the
    production meshes need."""


class GroupInUse(RuntimeError):
    """A process group of another backend or size is up; :func:`release`
    it first."""


def _register_fake() -> None:
    if "FAKE" in getattr(dist.Backend, "_plugins", {}):
        return
    try:
        from torch._C._distributed_c10d import FakeProcessGroup
    except ImportError as exc:
        raise FakeBackendUnavailable(
            "torch.distributed has no FakeProcessGroup: the production "
            "meshes cannot be built") from exc

    def create(common_opts, backend_opts):
        return FakeProcessGroup._create_internal(
            common_opts.group_rank, common_opts.group_size, backend_opts)

    dist.Backend.register_backend(dist.Backend.FAKE, create,
                                  extended_api=True,
                                  devices=["cpu", "cuda"])


def _group(backend: str, world_size: int) -> None:
    """Start the default group (rank 0 of ``world_size``, an in-process
    store), or check that the one up is of this backend and size."""
    if dist.is_initialized():
        up = (dist.get_backend(), dist.get_world_size())
        if up != (backend, world_size):
            raise GroupInUse(f"a {up[0]} group of {up[1]} ranks is up; "
                             f"release() it before a {backend} group of "
                             f"{world_size}")
        return
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=world_size)


def make_fake_mesh(shape, axes) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a ``fake`` group
    of as many ranks (this process rank 0)."""
    if not dist.is_available():
        raise FakeBackendUnavailable("torch.distributed is not available")
    _register_fake()
    n = 1
    for s in shape:
        n *= s
    _group(dist.Backend.FAKE, n)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    return make_fake_mesh(*(MULTI_POD if multi_pod else SINGLE_POD))


def make_host_mesh(model: int = 1, device: str = "cuda") -> DeviceMesh:
    """(data, model) mesh over the ranks of this process's group: one
    rank, ``nccl`` on the card or ``gloo`` for ``device="cpu"``, unless
    the caller started a group of its own."""
    if dist.is_initialized() and dist.get_backend() == dist.Backend.FAKE:
        raise GroupInUse("a fake group (a production mesh) is up; "
                         "release() it before a host mesh")
    if not dist.is_initialized():
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh: no CUDA device (pass "
                               "device='cpu' for the CPU)")
        _group("nccl" if device == "cuda" else "gloo", 1)
    n = dist.get_world_size()
    assert n % model == 0, (n, model)
    return init_device_mesh(device, (n // model, model),
                            mesh_dim_names=("data", "model"))


def release() -> None:
    """Destroy the default process group (and the mesh groups under it),
    if one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
