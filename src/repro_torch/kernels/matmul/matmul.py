"""Wrapper of the hand-written CUDA matmul (``csrc/matmul.cu``).

Replaces the TPU kernel ``repro/kernels/matmul/matmul.py::matmul``.
:func:`matmul` checks its operands, allocates the output, launches the
kernel on PyTorch's current stream and counts the launch in
:data:`launches`. It takes CUDA tensors only: a kernel that does not
build or launch raises, it never falls back to the plain version
(:mod:`.ref`), which :mod:`.ops` runs for CPU tensors.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "matmul.cu"

# launches of the kernel in this process; a plain integer the worker
# drains into its chunk counters (repro_torch.kernels.api.take_stats)
launches = 0

_ENTRY = {torch.float64: "matmul_f64", torch.float32: "matmul_f32",
          torch.bfloat16: "matmul_bf16"}

# the kernel's grid has one block row per 64 output rows
_MAX_ROWS = 65535 * 64

_lib = None


def _library() -> ctypes.CDLL:
    """The kernel library (built first if needed), with the ctypes
    signature of every entry point declared."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.matmul_error_string.argtypes = [ctypes.c_int]
        lib.matmul_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build() -> None:
    """Compile (or find) and load the library without launching."""
    _library()


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x (M, K) @ y (K, N)`` on the card, in the operands' dtype
    (float64, float32 or bfloat16; f64 accumulates in f64, the others in
    f32)."""
    global launches
    if not (x.is_cuda and y.is_cuda) or x.device != y.device:
        raise ValueError(f"matmul kernel needs both operands on one CUDA "
                         f"device, got {x.device} and {y.device}")
    if x.dtype != y.dtype or x.dtype not in _ENTRY:
        raise TypeError(f"matmul kernel takes float64, float32 or "
                        f"bfloat16 operands of one dtype, got {x.dtype} "
                        f"and {y.dtype}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul kernel needs (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul kernel needs row-major contiguous operands")
    m, k = x.shape
    n = y.shape[1]
    if m > _MAX_ROWS:
        raise ValueError(f"matmul kernel takes at most {_MAX_ROWS} rows, "
                         f"got {m}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out                                  # nothing to compute
    lib = _library()
    fn = getattr(lib, _ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
                 stream)
    if err != 0:
        msg = lib.matmul_error_string(err).decode()
        raise RuntimeError(f"matmul kernel launch failed: {msg} ({err})")
    launches += 1
    return out
