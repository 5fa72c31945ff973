"""Wrappers of the hand-written CUDA flash attention
(``csrc/flash_attention.cu``) and of its gradient
(``csrc/flash_attention_bwd.cu``).

The forward replaces the TPU kernel
``repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd``;
the backward computes the gradient of that function, which the TPU
package took from JAX's autodiff of its plain attention.
:func:`flash_attention_bhsd` checks its operands, allocates the output
(and, asked for, the logsumexp per query row that the backward needs),
launches the kernel on PyTorch's current stream and counts the launch in
:data:`launches`; :func:`flash_attention_gqa` does the same for bf16 on
the grouped-query layout (B, S, H, D) with K/V (B, S, KVH, D) read in
place through their strides, allocating the split-KV decode's workspace
where the kernel asks for one; :func:`flash_attention_bhsd_bwd` launches the
backward's three kernels (the preamble Δ = rowsum(dO ⊙ O), dK/dV, dQ)
and counts the call in :data:`bwd_launches`. They take CUDA tensors
only: a kernel that does not build or launch raises, it never falls
back to the plain versions (:mod:`.ref`), which :mod:`.ops` runs for
CPU tensors.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .. import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")

# launches of the kernel in this process; a plain integer the worker
# drains into its chunk counters (repro_torch.kernels.api.take_stats)
launches = 0
# backward calls in this process, each one launch of the preamble, the
# dK/dV and the dQ kernels
bwd_launches = 0

_ENTRY = {torch.float64: "flash_attention_f64",
          torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_BWD_ENTRY = {dt: name.replace("attention_", "attention_bwd_")
              for dt, name in _ENTRY.items()}

# the kernel's limits: head dims up to gemma2_2b's 288; the grid holds
# one block row per (batch x head)
MAX_D = 288
_MAX_BH = 65535

_lib = None
_bwd_lib = None


def _library() -> ctypes.CDLL:
    """The kernel library (built first if needed), with the ctypes
    signature of every entry point declared: q, k, v, o, lse (null: not
    asked), q_offset, the sizes, the options and the stream; the
    grouped-query entry takes the workspace after q_offset, B, Sq, Skv,
    H, KVH, D and the 12 element strides before the options, and
    ``flash_attention_gqa_workspace`` its size."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 4 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        fn = lib.flash_attention_gqa_bf16
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 6 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_gqa_workspace.argtypes = [ctypes.c_int64] * 6
        lib.flash_attention_gqa_workspace.restype = ctypes.c_int64
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _bwd_library() -> ctypes.CDLL:
    """The backward's library: q, k, v, o, dO, lse, q_offset, the Δ
    scratch, dq, dk, dv, the sizes, the options and the stream."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load(BWD_SOURCE)
        for name in _BWD_ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 4 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def build() -> None:
    """Compile (or find) and load both libraries without launching."""
    _library()
    _bwd_library()


def _check(q, k, v, what: str) -> None:
    """Raise for operands the kernels do not take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda) \
            or not q.device == k.device == v.device:
        raise ValueError(f"{what} needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _ENTRY:
        raise TypeError(f"{what} takes float64, float32 or bfloat16 "
                        f"operands of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{what} needs q (BH, Sq, D) and k, v (BH, Skv, "
                         f"D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what} needs contiguous operands")
    bh, _, d = q.shape
    if not 1 <= d <= MAX_D or bh > _MAX_BH or k.shape[1] == 0:
        raise ValueError(f"{what} takes 1 <= D <= {MAX_D}, BH <= {_MAX_BH} "
                         f"and Skv >= 1, got D={d}, BH={bh}, "
                         f"Skv={k.shape[1]}")


def _check_offset(q, q_offset, what: str) -> None:
    """Raise for a q_offset the kernels do not take."""
    if q_offset is not None and (
            q_offset.dtype != torch.int32 or q_offset.device != q.device
            or tuple(q_offset.shape) != (q.shape[0],)
            or not q_offset.is_contiguous()):
        raise ValueError(f"{what} needs q_offset as a contiguous int32 "
                         f"({q.shape[0]},) tensor on {q.device}, got "
                         f"{q_offset.dtype} {tuple(q_offset.shape)} on "
                         f"{q_offset.device}")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0,
                         q_offset: Optional[torch.Tensor] = None,
                         return_lse: bool = False):
    """Attention of q ``(BH, Sq, D)`` over k/v ``(BH, Skv, D)`` on the
    card, in the operands' dtype (float64, float32 or bfloat16; float64
    accumulates in float64, the others in float32). Query row ``i`` of
    batch-head ``r`` sits at position ``q_offset[r] + i`` (``q_offset``:
    int32 ``(BH,)`` on q's device; None: every row at ``i``). With
    ``return_lse``, (out, lse): lse ``(BH, Sq)`` in the accumulation
    type, the log of each row's softmax denominator."""
    global launches
    _check_offset(q, q_offset, "flash attention kernel")
    _check(q, k, v, "flash attention kernel")
    bh, sq, d = q.shape
    skv = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.promote_types(
        q.dtype, torch.float32), device=q.device) if return_lse else None
    if bh == 0 or sq == 0:
        return (out, lse) if return_lse else out    # nothing to compute
    lib = _library()
    fn = getattr(lib, _ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 None if q_offset is None else q_offset.data_ptr(),
                 bh, sq, skv, d, int(bool(causal)), int(window or 0),
                 float(softcap or 0.0), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash attention kernel launch failed: {msg} "
                           f"({err})")
    launches += 1
    return (out, lse) if return_lse else out


def _check_gqa(q, k, v, q_offset, what: str) -> None:
    """Raise for grouped-query operands the bf16 kernels do not take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda) \
            or not q.device == k.device == v.device:
        raise ValueError(f"{what} needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"{what} takes bfloat16 operands, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"{what} needs q (B, Sq, H, D) and k, v (B, Skv, "
                         f"KVH, D) with H a multiple of KVH, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"{what} needs unit stride in D, got strides "
                         f"{q.stride()}, {k.stride()}, {v.stride()}")
    d = q.shape[3]
    if not 1 <= d <= MAX_D or k.shape[1] == 0:
        raise ValueError(f"{what} takes 1 <= D <= {MAX_D} and Skv >= 1, got "
                         f"D={d}, Skv={k.shape[1]}")
    if q_offset is not None and (
            q_offset.dtype != torch.int32 or q_offset.device != q.device
            or tuple(q_offset.shape) != (q.shape[0],)
            or not q_offset.is_contiguous()):
        raise ValueError(f"{what} needs q_offset as a contiguous int32 "
                         f"({q.shape[0]},) tensor on {q.device}, got "
                         f"{q_offset.dtype} {tuple(q_offset.shape)} on "
                         f"{q_offset.device}")


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0,
                        q_offset: Optional[torch.Tensor] = None,
                        return_lse: bool = False):
    """bf16 attention of q ``(B, Sq, H, D)`` over k/v ``(B, Skv, KVH, D)``
    on the card, query head ``h`` on KV head ``h // (H // KVH)``, each
    operand read through its strides (unit stride in D: a slice of a KV
    cache is read where it lies). Query row ``i`` of batch row ``b`` sits
    at position ``q_offset[b] + i`` (``q_offset``: int32 ``(B,)`` on q's
    device; None: every row at ``i``). Returns O ``(B, Sq, H, D)``
    contiguous and, with ``return_lse``, the logsumexp ``(B, H, Sq)`` in
    float32. The kernel (split-KV decode or tensor cores) is the C
    entry's choice."""
    global launches
    what = "flash attention GQA kernel"
    _check_gqa(q, k, v, q_offset, what)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if b == 0 or sq == 0 or h == 0:
        return (out, lse) if return_lse else out    # nothing to compute
    lib = _library()
    with torch.cuda.device(q.device):
        n = lib.flash_attention_gqa_workspace(b, sq, skv, h, kvh, d)
        ws = torch.empty(n, dtype=torch.float32, device=q.device) if n \
            else None
        strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                        *v.stride()[:3], *out.stride()[:3])
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_gqa_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if q_offset is None else q_offset.data_ptr(),
            None if ws is None else ws.data_ptr(), b, sq, skv, h, kvh, d,
            strides, int(bool(causal)), int(window or 0),
            float(softcap or 0.0), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash attention GQA kernel launch failed: "
                           f"{msg} ({err})")
    launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bhsd_bwd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             softcap: float = 0.0,
                             q_offset: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of :func:`flash_attention_bhsd` on the card, in the
    operands' dtype: from its output ``o`` and logsumexp ``lse`` and the
    output's gradient ``do`` (each contiguous, ``o`` and ``do`` as q,
    ``lse`` (BH, Sq) in the accumulation type), with the forward's
    ``q_offset``. A row with no valid key gets dq = 0 and adds dO / Skv
    to dv of every key (the forward's uniform P)."""
    global bwd_launches
    what = "flash attention backward kernel"
    _check_offset(q, q_offset, what)
    _check(q, k, v, what)
    acc = torch.promote_types(q.dtype, torch.float32)
    bh, sq, d = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype or lse.shape != (bh, sq) \
            or lse.dtype != acc or not all(
                t.is_contiguous() and t.device == q.device
                for t in (o, do, lse)):
        raise ValueError(f"{what} needs contiguous o and do as q "
                         f"{tuple(q.shape)} {q.dtype} and lse ({bh}, {sq}) "
                         f"{acc} on {q.device}, got o {tuple(o.shape)} "
                         f"{o.dtype}, do {tuple(do.shape)} {do.dtype}, lse "
                         f"{tuple(lse.shape)} {lse.dtype}")
    skv = k.shape[1]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if bh == 0 or sq == 0:
        return dq, dk.zero_(), dv.zero_()           # no query sees a key
    lib = _bwd_library()
    fn = getattr(lib, _BWD_ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        # Δ of each row, then each batch-head's dO summed over its rows
        # with no valid key
        delta = torch.empty((bh, sq + d), dtype=acc, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (q, k, v, o, do, lse)),
                 None if q_offset is None else q_offset.data_ptr(),
                 *(t.data_ptr() for t in (delta, dq, dk, dv)),
                 bh, sq, skv, d, int(bool(causal)), int(window or 0),
                 float(softcap or 0.0), stream)
    if err != 0:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"flash attention backward kernel launch "
                           f"failed: {msg} ({err})")
    bwd_launches += 1
    return dq, dk, dv
