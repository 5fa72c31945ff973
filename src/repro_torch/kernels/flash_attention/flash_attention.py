"""Wrapper of the hand-written CUDA flash attention
(``csrc/flash_attention.cu``).

Replaces the TPU kernel
``repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd``.
:func:`flash_attention_bhsd` checks its operands, allocates the output,
launches the kernel on PyTorch's current stream and counts the launch in
:data:`launches`. It takes CUDA tensors only: a kernel that does not
build or launch raises, it never falls back to the plain version
(:mod:`.ref`), which :mod:`.ops` runs for CPU tensors.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .. import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

# launches of the kernel in this process; a plain integer the worker
# drains into its chunk counters (repro_torch.kernels.api.take_stats)
launches = 0

_ENTRY = {torch.float64: "flash_attention_f64",
          torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}

# the kernel's limits: head dims up to gemma2_2b's 288; the grid holds
# one block row per (batch x head)
MAX_D = 288
_MAX_BH = 65535

_lib = None


def _library() -> ctypes.CDLL:
    """The kernel library (built first if needed), with the ctypes
    signature of every entry point declared."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build() -> None:
    """Compile (or find) and load the library without launching."""
    _library()


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0,
                         q_offset: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Attention of q ``(BH, Sq, D)`` over k/v ``(BH, Skv, D)`` on the
    card, in the operands' dtype (float64, float32 or bfloat16; float64
    accumulates in float64, the others in float32). Query row ``i`` of
    batch-head ``r`` sits at position ``q_offset[r] + i`` (``q_offset``:
    int32 ``(BH,)`` on q's device; None: every row at ``i``)."""
    global launches
    if q_offset is not None and (
            q_offset.dtype != torch.int32 or q_offset.device != q.device
            or tuple(q_offset.shape) != (q.shape[0],)
            or not q_offset.is_contiguous()):
        raise ValueError(f"flash attention kernel needs q_offset as a "
                         f"contiguous int32 ({q.shape[0]},) tensor on "
                         f"{q.device}, got {q_offset.dtype} "
                         f"{tuple(q_offset.shape)} on {q_offset.device}")
    if not (q.is_cuda and k.is_cuda and v.is_cuda) \
            or not q.device == k.device == v.device:
        raise ValueError(f"flash attention kernel needs q, k, v on one "
                         f"CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _ENTRY:
        raise TypeError(f"flash attention kernel takes float64, float32 "
                        f"or bfloat16 operands of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash attention kernel needs q (BH, Sq, D) and "
                         f"k, v (BH, Skv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention kernel needs contiguous operands")
    bh, sq, d = q.shape
    skv = k.shape[1]
    if not 1 <= d <= MAX_D or bh > _MAX_BH or skv == 0:
        raise ValueError(f"flash attention kernel takes 1 <= D <= {MAX_D}, "
                         f"BH <= {_MAX_BH} and Skv >= 1, got D={d}, "
                         f"BH={bh}, Skv={skv}")
    out = torch.empty_like(q)
    if bh == 0 or sq == 0:
        return out                                  # nothing to compute
    lib = _library()
    fn = getattr(lib, _ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if q_offset is None else q_offset.data_ptr(),
                 bh, sq, skv, d, int(bool(causal)), int(window or 0),
                 float(softcap or 0.0), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash attention kernel launch failed: {msg} "
                           f"({err})")
    launches += 1
    return out
