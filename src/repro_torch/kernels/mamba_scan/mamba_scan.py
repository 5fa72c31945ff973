"""Wrapper of the hand-written CUDA selective scan (``csrc/mamba_scan.cu``).

Replaces the TPU kernel ``repro/kernels/mamba_scan/mamba_scan.py::
mamba_scan``, without its chunking (any L is taken). :func:`mamba_scan`
checks its operands, allocates the output, launches the kernel on
PyTorch's current stream and counts the launch in :data:`launches`. It
takes CUDA tensors only: a kernel that does not build or launch raises,
it never falls back to the plain version (:mod:`.ref`), which
:mod:`.ops` runs for CPU tensors.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"

# launches of the kernel in this process; a plain integer the worker
# drains into its chunk counters (repro_torch.kernels.api.take_stats)
launches = 0

_ENTRY = {torch.float64: "mamba_scan_f64", torch.float32: "mamba_scan_f32",
          torch.bfloat16: "mamba_scan_bf16"}

# the kernel keeps N state values per thread in registers; the grid
# holds one block row per batch entry
MAX_N = 32
_MAX_BATCH = 65535

_lib = None


def _library() -> ctypes.CDLL:
    """The kernel library (built first if needed), with the ctypes
    signature of every entry point declared."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 4 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.mamba_scan_error_string.argtypes = [ctypes.c_int]
        lib.mamba_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build() -> None:
    """Compile (or find) and load the library without launching."""
    _library()


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, a: torch.Tensor,
               d_skip: torch.Tensor) -> torch.Tensor:
    """x/dt (B, L, I); Bm/Cm (B, L, N); a (I, N); d_skip (I,) on the card,
    all of one dtype (float64, float32 or bfloat16); y (B, L, I) in that
    dtype, the state carried in ``promote(dtype, float32)``."""
    global launches
    ops = (x, dt, Bm, Cm, a, d_skip)
    if not all(t.is_cuda and t.device == x.device for t in ops):
        raise ValueError(f"mamba scan kernel needs every operand on one "
                         f"CUDA device, got {[str(t.device) for t in ops]}")
    if x.dtype not in _ENTRY or any(t.dtype != x.dtype for t in ops):
        raise TypeError(f"mamba scan kernel takes float64, float32 or "
                        f"bfloat16 operands of one dtype, got "
                        f"{[t.dtype for t in ops]}")
    if x.dim() != 3:
        raise ValueError(f"mamba scan kernel needs x (B, L, I), got "
                         f"{tuple(x.shape)}")
    batch, length, inner = x.shape
    n = Bm.shape[-1] if Bm.dim() == 3 else -1
    if dt.shape != x.shape or Bm.shape != (batch, length, n) \
            or Cm.shape != Bm.shape or a.shape != (inner, n) \
            or d_skip.shape != (inner,):
        raise ValueError(
            f"mamba scan kernel needs x, dt (B, L, I), Bm, Cm (B, L, N), "
            f"a (I, N), d_skip (I,), got {[tuple(t.shape) for t in ops]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("mamba scan kernel needs contiguous operands")
    if not 1 <= n <= MAX_N or batch > _MAX_BATCH:
        raise ValueError(f"mamba scan kernel takes 1 <= N <= {MAX_N} and "
                         f"B <= {_MAX_BATCH}, got N={n}, B={batch}")
    y = torch.empty_like(x)
    if batch == 0 or length == 0 or inner == 0:
        return y                                    # nothing to compute
    lib = _library()
    fn = getattr(lib, _ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in ops), y.data_ptr(), batch, length,
                 inner, n, stream)
    if err != 0:
        msg = lib.mamba_scan_error_string(err).decode()
        raise RuntimeError(f"mamba scan kernel launch failed: {msg} ({err})")
    launches += 1
    return y
