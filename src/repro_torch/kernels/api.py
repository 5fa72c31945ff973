"""Runtime surface of the cuda backend (bound as ``__cuk`` in twins).

The pattern matcher (:mod:`repro_torch.core.patterns`) rewrites a
recognized pfor unit body onto an entry point here; generated cuda twins
call it with plain numpy blocks — possibly
:class:`repro_torch.distrib.serial.ChunkSlice` views of a worker's chunk
rows — and store the numpy result back into the captured arrays. Each
entry point makes its blocks contiguous, moves them to this process's
device, runs the kernel and returns numpy:

* :func:`matmul` — the hand-written CUDA matmul (``kernels/matmul``).
* :func:`attention_rows` — unscaled-softmax row attention onto the
  hand-written flash attention (``kernels/flash_attention``): the kernel
  bakes in a ``1/sqrt(d)`` score scale, so queries are pre-multiplied by
  ``sqrt(d)`` to cancel it.
* :func:`scan_rows` — first-order linear recurrence onto the
  hand-written selective scan (``kernels/mamba_scan``) via the identity
  mapping ``dt=1, B=C=1 (N=1), a=log(-log(c))``, which needs
  ``0 < c < 1``; an out-of-range coefficient raises a
  ``cuda-lowering-infeasible`` error, which the cluster counts as a
  fallback and steps the chunk down to its np body.

Every kernel masks its ragged edges itself, so no block is padded.

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

import math
import os
from typing import Dict

import numpy as np
import torch

from ..distrib import accel
from .flash_attention import flash_attention as _flash_kernel
from .flash_attention import ops as _flash_ops
from .mamba_scan import mamba_scan as _scan_kernel
from .mamba_scan import ops as _scan_ops
from .matmul import matmul as _matmul_kernel
from .matmul import ops as _matmul_ops

# each hand-written kernel's wrapper module, by the name of its launch
# counter in stats()
_KERNELS = {"matmul_launches": _matmul_kernel,
            "flash_attention_launches": _flash_kernel,
            "mamba_scan_launches": _scan_kernel}

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
    for kernel in _KERNELS.values():
        kernel.build()


def _bump(key: str, val: float = 1) -> None:
    _STATS[key] = _STATS.get(key, 0) + val


def stats() -> Dict[str, float]:
    """Counters accumulated since the last :func:`take_stats`, with the
    kernel wrappers' launch counts."""
    out = dict(_STATS)
    for key, kernel in _KERNELS.items():
        if kernel.launches:
            out[key] = kernel.launches
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
    for kernel in _KERNELS.values():
        kernel.launches = 0


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


def _float_dtype(name: str, *blocks) -> np.dtype:
    """The blocks' promoted dtype, which the kernels take when it is
    float64 (the compiler path) or float32."""
    dtype = np.result_type(*blocks)
    if dtype not in (np.float64, np.float32):
        raise TypeError(f"cuda-lowering-infeasible: {name} of {dtype} "
                        f"operands (the kernel takes float64 or float32)")
    return dtype


def matmul(a, b):
    """``a @ b`` through the hand-written CUDA matmul, in the operands'
    promoted float dtype (float64 on the compiler path)."""
    _chaos()
    dev = _target()
    dtype = _float_dtype("matmul", a, b)
    _count(dev)
    # contiguous base-class copies: a ChunkSlice's rebasing indexer must
    # not leak into torch, and the kernel reads row-major operands
    a = np.ascontiguousarray(a, dtype=dtype)
    b = np.ascontiguousarray(b, dtype=dtype)
    out = _matmul_ops.matmul(accel.device_tensor(a, dev),
                             accel.device_tensor(b, dev))
    return out.cpu().numpy()


def attention_rows(q, k, v):
    """Unscaled-softmax attention for a block of query rows.

    ``out[r, j] = sum_t exp(q[r]·k[t]) v[t, j] / sum_t exp(q[r]·k[t])``
    with q ``(R, D)``, k ``(T, D)``, v ``(T, D)``.
    """
    _chaos()
    dev = _target()
    dtype = _float_dtype("attention_rows", q, k, v)
    _count(dev)
    q = np.ascontiguousarray(q, dtype=dtype)
    k = np.ascontiguousarray(k, dtype=dtype)
    v = np.ascontiguousarray(v, dtype=dtype)
    # cancel the kernel's baked-in 1/sqrt(d) score scale
    qs = accel.device_tensor(q, dev) * math.sqrt(q.shape[1])
    out = _flash_ops.flash_attention_bhsd(
        qs[None], accel.device_tensor(k, dev)[None],
        accel.device_tensor(v, dev)[None], causal=False, window=0,
        softcap=0.0)
    return out[0].cpu().numpy()


def scan_rows(x_rows, c):
    """First-order recurrence ``h_t = c*h_{t-1} + x[r, t]`` per row,
    ``h_{-1} = 0``, through the selective-scan kernel."""
    _chaos()
    c = float(c)
    if not 0.0 < c < 1.0:
        raise ValueError(
            f"cuda-lowering-infeasible: scan decay coefficient {c!r} "
            f"outside (0, 1) (a = log(-log(c)) undefined)")
    dev = _target()
    dtype = _float_dtype("scan_rows", x_rows)
    _count(dev)
    x_rows = np.ascontiguousarray(x_rows, dtype=dtype)
    rows, length = x_rows.shape
    # identity mapping: B=1 batch, I=rows channels, N=1 state; with
    # dt=1 and B=C=1 the recurrence collapses to h = exp(-exp(a))*h + x
    # and a = log(-log(c)) makes exp(-exp(a)) == c
    x = accel.device_tensor(x_rows, dev).t().contiguous()[None]  # (1, L, R)
    ones_l = torch.ones((1, length, rows), dtype=x.dtype, device=dev)
    ones_n = torch.ones((1, length, 1), dtype=x.dtype, device=dev)
    a = torch.full((rows, 1), math.log(-math.log(c)), dtype=x.dtype,
                   device=dev)
    d_skip = torch.zeros((rows,), dtype=x.dtype, device=dev)
    y = _scan_ops.mamba_scan(x, ones_l, ones_n, ones_n, a, d_skip)
    return y[0].t().cpu().numpy()                                # (R, L)
