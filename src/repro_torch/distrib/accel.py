"""Worker-side device residency and accelerator counters.

The hand-kernel runtime (:mod:`repro_torch.kernels.api`) takes numpy
blocks and moves them to the worker's device for every call. Most
operands are fresh per chunk, but the broadcast cells of a pfor body
(the ``B`` of ``rows @ B``) and the cached chunk rows are identical
from one chunk task to the next. This module keeps their device copies:

  * :func:`remember` registers a host array whose content is
    identity-stable between chunk tasks (worker blob cells and cached
    chunk rows, which the worker's snapshot/rollback keeps pristine);
  * :func:`device_tensor` returns the device copy of a host array,
    staging it once per registered buffer and reusing it afterwards;
  * :func:`take_stats` drains the residency counters plus the kernel
    runtime's call counters the worker piggybacks on chunk ``done``
    messages (:data:`WIRE_STAT_KEYS` names every one of them).

The batched torch-twin runtime (the reference's ``pfor_jit``) arrives
with the torch twin in a later slice.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Dict, List

import numpy as np

__all__ = ["remember", "device_tensor", "take_stats", "stats", "reset",
           "WIRE_STAT_KEYS"]

# Every counter key a worker may piggyback on a chunk "done" message —
# this module's residency counters plus the kernel runtime's call
# counters (repro_torch.kernels.api, drained the same way). The
# cluster's head-side aggregation derives its key set from this tuple,
# so adding a worker-side counter is a one-place change.
WIRE_STAT_KEYS = ("resident_hits", "resident_stages", "resident_cells",
                  "cuda_calls", "cuda_plain_calls", "matmul_launches",
                  "flash_attention_launches", "mamba_scan_launches")

# (data ptr, shape, strides, dtype) → [host array (strong ref),
# {device: tensor}]. Keyed by buffer layout, not object id, because
# chunk bodies see a *fresh* re-based view of the cached rows array
# every task — same buffer, new Python object. The strong ref pins the
# buffer so the pointer cannot be recycled by a different array while
# the entry lives; the LRU byte budget bounds how much host memory
# residency can pin.
_RESIDENT: "OrderedDict[tuple, List[Any]]" = OrderedDict()
_RESIDENT_BYTES = 0

_STATS: Dict[str, float] = {}


def _budget_bytes() -> int:
    try:
        mb = float(os.environ.get("REPRO_DISTRIB_RESIDENT_MB", "256"))
    except ValueError:
        mb = 256.0
    return int(mb * (1 << 20))


def _bump(key: str, val: float = 1) -> None:
    _STATS[key] = _STATS.get(key, 0) + val


def stats() -> Dict[str, float]:
    """Counters accumulated since the last :func:`take_stats`."""
    return dict(_STATS)


def take_stats() -> Dict[str, float]:
    """Drain and return the counter deltas ({} when nothing happened)."""
    out = dict(_STATS)
    _STATS.clear()
    return out


def reset() -> None:
    """Forget device residents and counters (test isolation)."""
    global _RESIDENT_BYTES
    _RESIDENT.clear()
    _RESIDENT_BYTES = 0
    _STATS.clear()


def _reskey(arr: np.ndarray) -> tuple:
    return (arr.__array_interface__["data"][0], arr.shape,
            arr.strides, str(arr.dtype))


def remember(arr) -> None:
    """Register a host array as residency-eligible.

    Only arrays whose content is identity-stable between chunk tasks
    qualify: worker blob cells (replaced wholesale by ``update_blob``
    when they change) and cached chunk-row arrays (replaced when the
    head re-ships rows). The worker's snapshot/rollback in
    ``_chunk_updates`` guarantees the host copy is pristine again after
    every task, so a device copy staged once stays valid until the
    object itself is swapped out.
    """
    global _RESIDENT_BYTES
    if not isinstance(arr, np.ndarray) or arr.nbytes > _budget_bytes():
        return
    key = _reskey(arr)
    ent = _RESIDENT.get(key)
    if ent is not None:
        if ent[0] is arr:
            _RESIDENT.move_to_end(key)
            return
        # same layout, different object (pointer recycled after the old
        # entry's array died elsewhere): staged copies may be stale
        _RESIDENT_BYTES -= ent[0].nbytes
        del _RESIDENT[key]
    _RESIDENT[key] = [arr, {}]
    _RESIDENT_BYTES += arr.nbytes
    while _RESIDENT_BYTES > _budget_bytes() and len(_RESIDENT) > 1:
        _, old = _RESIDENT.popitem(last=False)
        _RESIDENT_BYTES -= old[0].nbytes


def device_tensor(host: np.ndarray, device):
    """Device copy of a C-contiguous host array, through the residency
    cache when its buffer was :func:`remember`-ed. The caller must not
    write to the result: a resident copy is shared across calls."""
    import torch

    key = _reskey(host)
    ent = _RESIDENT.get(key)
    if ent is None:
        _bump("resident_stages")
        return torch.from_numpy(host).to(device)
    _RESIDENT.move_to_end(key)
    cache = ent[1]
    dev = cache.get(str(device))
    if dev is not None:
        _bump("resident_hits")
        return dev
    dev = torch.from_numpy(host).to(device)
    if not cache:
        _bump("resident_cells")
    cache[str(device)] = dev
    _bump("resident_stages")
    return dev
