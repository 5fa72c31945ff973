"""Runtime surface of the cuda backend (bound as ``__cuk`` in twins).

The pattern matcher (:mod:`repro_torch.core.patterns`) rewrites a
recognized pfor unit body onto an entry point here; generated cuda twins
call it with plain numpy blocks — possibly
:class:`repro_torch.distrib.serial.ChunkSlice` views of a worker's chunk
rows — and store the numpy result back into the captured arrays. Each
entry point makes its blocks contiguous, moves them to this process's
device, runs the kernel and returns numpy:

* :func:`matmul` — the hand-written CUDA matmul (``kernels/matmul``),
  which masks ragged edges itself.

The device is the process's: a cluster worker binds its own with
:func:`set_device` at startup. On ``"cuda"`` (the default) the kernels
launch on the card, and a host without one raises; on ``"cpu"`` the
kernels' plain torch versions run (the CPU tests). Nothing falls back
from the card to the CPU. ``REPRO_CUDA_CHAOS=fail`` makes every entry
point raise, as a failed kernel would: a ``device="cpu"`` fleet steps
the chunk down to its np body (a counted fallback), a CUDA fleet fails
the task.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..distrib import accel
from .matmul import matmul as _matmul_kernel
from .matmul import ops as _matmul_ops

_STATS: Dict[str, float] = {}

# the device this process computes on (see module docstring)
_DEVICE = "cuda"


def set_device(device: str) -> None:
    """Bind this process's kernel device: ``"cuda"`` or ``"cpu"``. A
    CUDA device on a host without one raises here, at binding."""
    global _DEVICE
    if device != "cpu" and not str(device).startswith("cuda"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device != "cpu":
        _check_cuda(device)
    _DEVICE = device


def device() -> str:
    return _DEVICE


def _check_cuda(device: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"the kernel runtime is bound to {device!r} but torch sees no "
            f"CUDA device; bind 'cpu' to run the plain versions")


def build() -> None:
    """Compile (or find) and load every kernel library this surface
    calls — done once by the cluster head before its workers start."""
    _matmul_kernel.build()


def _bump(key: str, val: float = 1) -> None:
    _STATS[key] = _STATS.get(key, 0) + val


def stats() -> Dict[str, float]:
    """Counters accumulated since the last :func:`take_stats`, with the
    kernel wrappers' launch counts."""
    out = dict(_STATS)
    if _matmul_kernel.launches:
        out["matmul_launches"] = _matmul_kernel.launches
    return out


def take_stats() -> Dict[str, float]:
    """Drain the counters (the wrappers' launch counts included); the
    worker piggybacks them on chunk ``done`` messages exactly like
    :func:`repro_torch.distrib.accel.take_stats`."""
    out = stats()
    reset()
    return out


def reset() -> None:
    _STATS.clear()
    _matmul_kernel.launches = 0


def _target() -> torch.device:
    if _DEVICE != "cpu":
        _check_cuda(_DEVICE)
    return torch.device(_DEVICE)


def _chaos() -> None:
    if os.environ.get("REPRO_CUDA_CHAOS") == "fail":
        raise RuntimeError("cuda-chaos")


def _count(dev: torch.device) -> None:
    _bump("cuda_calls")
    if dev.type == "cpu":
        _bump("cuda_plain_calls")


def _div_block(n: int, pref: int) -> int:
    """Largest block <= pref that divides n (for kernels that refuse
    ragged tiles)."""
    b = max(1, min(pref, n))
    while n % b:
        b -= 1
    return b


def matmul(a, b):
    """``a @ b`` through the hand-written CUDA matmul, in the operands'
    promoted float dtype (float64 on the compiler path)."""
    _chaos()
    dev = _target()
    dtype = np.result_type(a, b)
    if dtype not in (np.float64, np.float32):
        raise TypeError(f"cuda-lowering-infeasible: matmul of {dtype} "
                        f"operands (the kernel takes float64 or float32)")
    _count(dev)
    # contiguous base-class copies: a ChunkSlice's rebasing indexer must
    # not leak into torch, and the kernel reads row-major operands
    a = np.ascontiguousarray(a, dtype=dtype)
    b = np.ascontiguousarray(b, dtype=dtype)
    out = _matmul_ops.matmul(accel.device_tensor(a, dev),
                             accel.device_tensor(b, dev))
    return out.cpu().numpy()
