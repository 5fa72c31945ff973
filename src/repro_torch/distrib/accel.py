"""Worker-side accelerator runtime: the batched torch-twin path, device
residency and accelerator counters.

:func:`pfor_batch` is the fast path stamped into every row-parallel torch
twin (the counterpart of the reference's ``pfor_jit``): instead of one
eager op stream per pfor iteration, the twin hands its per-iteration
function here and we

  * run it under ``torch.func.vmap`` over a pow2-bucketed iteration index
    (:func:`repro_torch.core.cost.pow2_bucket`), so a serving loop whose
    capability-proportional chunking jitters the chunk size still maps
    to the same entry;
  * keep the vmapped callable per (iteration code, baked scalars,
    bucket, array signature) with hit / build / fallback counters, and
    mark a combination that failed as one that cannot be batched (a
    negative entry), so it is probed once, not every round;
  * take the operands through the residency cache below;
  * scatter only the real rows ``[lo, hi)`` back into the captured
    numpy arrays, so the worker's sparse-diff gather sees exactly the
    writes the eager twin would have made.

``pfor_batch`` returns False when the batched path cannot run (an
unbakeable closure cell, a vmap or run failure, a negative entry); the
twin then runs its eager per-iteration loop on the same device. Every
such run counts one ``batch_fallbacks``.

The hand-kernel runtime (:mod:`repro_torch.kernels.api`) also takes numpy
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
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Dict, List, Sequence

import numpy as np

__all__ = ["pfor_batch", "remember", "device_tensor", "take_stats",
           "stats", "reset", "WIRE_STAT_KEYS"]

# Every counter key a worker may piggyback on a chunk "done" message —
# this module's batch and residency counters plus the kernel runtime's
# call counters (repro_torch.kernels.api, drained the same way). The
# cluster's head-side aggregation derives its key set from this tuple,
# so adding a worker-side counter is a one-place change.
WIRE_STAT_KEYS = ("batch_hits", "batch_builds", "batch_fallbacks",
                  "resident_hits", "resident_stages", "resident_cells",
                  "cuda_calls", "cuda_plain_calls", "matmul_launches",
                  "flash_attention_launches", "mamba_scan_launches")

# scalar types a closure cell may hold and still be baked into the
# batch-cache key (anything else → eager twin)
_BAKEABLE = (int, float, complex, bool, str, bytes, type(None), np.generic)

_UNSET = object()

# (iter code, baked consts, bucket, array sig) → vmapped callable, or
# None marking a combination that failed to run (negative entry)
_BATCHED: Dict[tuple, Any] = {}

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
    """Forget batched entries, device residents and counters (test
    isolation)."""
    global _RESIDENT_BYTES
    _BATCHED.clear()
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


def pfor_batch(iter_fn, lo: int, hi: int, arrays: Sequence[Any],
               write_pos: Sequence[int]) -> bool:
    """Run ``iter_fn(g, offs, *arrays)`` for every g in [lo, hi) as one
    ``torch.func.vmap`` call on the torch backend's device
    (:mod:`repro_torch.core.txp`), scattering the returned rows back
    into ``arrays[p]`` for each p in ``write_pos``.

    Returns True when the batched path ran (the caller's eager loop must
    be skipped), False when the caller must run its eager loop."""
    n = int(hi) - int(lo)
    if n <= 0:
        return True
    # closure cells (the kernel's scalars) are part of the key, so they
    # must be hashable scalars
    consts: List[Any] = []
    for cell in (iter_fn.__closure__ or ()):
        try:
            v = cell.cell_contents
        except ValueError:
            _bump("batch_fallbacks")
            return False
        if not isinstance(v, _BAKEABLE):
            _bump("batch_fallbacks")
            return False
        # by type too: 1.1 == np.float64(1.1), but a float32 body
        # computes at float32 with the one and float64 with the other
        consts.append((type(v), v))

    import torch

    from repro_torch.core.cost import pow2_bucket
    from repro_torch.core import txp

    bucket = int(pow2_bucket(n)[1])
    dev = txp.device()
    sig: List[tuple] = []
    offs: List[int] = []
    devs: List[Any] = []
    for a in arrays:
        sliced = hasattr(a, "_chunk_base")
        raw = np.ascontiguousarray(np.asarray(a))
        # a chunk's rows enter the key without their count, so chunks
        # of one bucket share it
        shape = raw.shape[1:] if (sliced and raw.ndim) else raw.shape
        sig.append((str(raw.dtype), tuple(shape), sliced))
        offs.append(int(getattr(a, "_chunk_base", 0) or 0))
        devs.append(device_tensor(raw, dev))
    key = (iter_fn.__code__, tuple(consts), bucket, tuple(sig))
    fn = _BATCHED.get(key, _UNSET)
    if fn is None:   # known not to batch
        _bump("batch_fallbacks")
        return False

    # padded lanes re-run the last real iteration (clamp): their rows
    # are computed and discarded by the scatter below
    idx = torch.clamp(torch.arange(lo, lo + bucket, device=dev), lo, hi - 1)
    offs_t = torch.tensor(offs, dtype=torch.int64, device=dev)
    build = fn is _UNSET
    if build:
        # later hits reuse this closure, which is semantically the same
        # (same code, same baked cells)
        fn = torch.func.vmap(
            iter_fn, in_dims=(0,) + (None,) * (1 + len(devs)))
    try:
        out = fn(idx, offs_t, *devs)
        outs = out if isinstance(out, tuple) else (out,)
        rows = [r[:n].detach().cpu().numpy() for r in outs]
    except Exception:
        if build:
            _BATCHED[key] = None
        _bump("batch_fallbacks")
        return False
    if build:
        _BATCHED[key] = fn
        _bump("batch_builds")
    else:
        _bump("batch_hits")
    for pos, r in zip(write_pos, rows):
        a = arrays[pos]
        off = int(getattr(a, "_chunk_base", 0) or 0)
        np.asarray(a)[lo - off:hi - off] = r
    return True
