"""Wrappers of the hand-written CUDA selective scan (``csrc/mamba_scan.cu``)
and of its gradient (``csrc/mamba_scan_bwd.cu``).

The forward replaces the TPU kernel ``repro/kernels/mamba_scan/mamba_scan.py::
mamba_scan``: a chunked scan, parallel in L, in one grid (decoupled
look-back between chunks of 64 steps; any L is taken). The backward
computes the gradient of that function, which the TPU package took from
JAX's autodiff of its jnp scan. :func:`mamba_scan` checks its operands,
allocates the output (and, when asked, the final state h_L, and for a
gradient each segment's entry state) and the kernel's scratch (the flags
and counter, which the launcher zeroes on the stream, and the chunks'
records), launches the kernel on PyTorch's current stream and counts the
call in :data:`launches`; :func:`mamba_scan_bwd` launches the backward
(its scan, then the sums of its partial reductions) and counts the call
in :data:`bwd_launches`. They take CUDA tensors only: a kernel that does
not build or launch raises, it never falls back to the plain versions
(:mod:`.ref`), which :mod:`.ops` runs for CPU tensors.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .. import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
BWD_SOURCE = SOURCE.with_name("mamba_scan_bwd.cu")

# launches of the kernel in this process; a plain integer the worker
# drains into its chunk counters (repro_torch.kernels.api.take_stats)
launches = 0
# backward calls in this process, each one launch of the backward scan
# and of its sums
bwd_launches = 0

_ENTRY = {torch.float64: "mamba_scan_f64", torch.float32: "mamba_scan_f32",
          torch.bfloat16: "mamba_scan_bf16"}
_BWD_ENTRY = {dt: name.replace("scan_", "scan_bwd_")
              for dt, name in _ENTRY.items()}

# the kernel keeps N state values per thread in registers
MAX_N = 32

_lib = None
_bwd_lib = None


def _library() -> ctypes.CDLL:
    """The kernel library (built first if needed), with the ctypes
    signature of every entry point declared."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            # x, dt, Bm, Cm, a, d_skip, y, h_last (null: not asked),
            # h_seg (null: no gradient), scratch; the sizes; the stream
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 4 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.mamba_scan_scratch_bytes.argtypes = [ctypes.c_int64] * 5
        lib.mamba_scan_scratch_bytes.restype = ctypes.c_int64
        lib.mamba_scan_error_string.argtypes = [ctypes.c_int]
        lib.mamba_scan_error_string.restype = ctypes.c_char_p
        lib.mamba_scan_segments.argtypes = [ctypes.c_int64]
        lib.mamba_scan_segments.restype = ctypes.c_int64
        _lib = lib
    return _lib


def _bwd_library() -> ctypes.CDLL:
    """The backward's library: x, dt, Bm, Cm, a, d_skip, dy, h_seg,
    dh_last (null: none), dx, ddt, dBm, dCm, da, dd_skip, the workspace;
    the sizes; the stream."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load(BWD_SOURCE)
        for name in _BWD_ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int64] * 4 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.mamba_scan_bwd_work_bytes.argtypes = [ctypes.c_int64] * 5
        lib.mamba_scan_bwd_work_bytes.restype = ctypes.c_int64
        lib.mamba_scan_bwd_error_string.argtypes = [ctypes.c_int]
        lib.mamba_scan_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def build() -> None:
    """Compile (or find) and load both libraries without launching."""
    _library()
    _bwd_library()


def _check(ops, what: str):
    """(batch, length, inner, n) of the operands x, dt, Bm, Cm, a,
    d_skip (and any more of x's shape and dtype); raises for operands the
    kernels do not take."""
    x, dt, Bm, Cm, a, d_skip = ops[:6]
    if not all(t.is_cuda and t.device == x.device for t in ops):
        raise ValueError(f"{what} needs every operand on one CUDA device, "
                         f"got {[str(t.device) for t in ops]}")
    if x.dtype not in _ENTRY or any(t.dtype != x.dtype for t in ops):
        raise TypeError(f"{what} takes float64, float32 or bfloat16 "
                        f"operands of one dtype, got "
                        f"{[t.dtype for t in ops]}")
    if x.dim() != 3:
        raise ValueError(f"{what} needs x (B, L, I), got {tuple(x.shape)}")
    batch, length, inner = x.shape
    n = Bm.shape[-1] if Bm.dim() == 3 else -1
    if dt.shape != x.shape or Bm.shape != (batch, length, n) \
            or Cm.shape != Bm.shape or a.shape != (inner, n) \
            or d_skip.shape != (inner,) \
            or any(t.shape != x.shape for t in ops[6:]):
        raise ValueError(
            f"{what} needs x, dt (B, L, I), Bm, Cm (B, L, N), a (I, N), "
            f"d_skip (I,), got {[tuple(t.shape) for t in ops]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError(f"{what} needs contiguous operands")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{what} takes 1 <= N <= {MAX_N}, got N={n}")
    return batch, length, inner, n


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
               return_state: bool = False, save_states: bool = False):
    """x/dt (B, L, I); Bm/Cm (B, L, N); a (I, N); d_skip (I,) on the card,
    all of one dtype (float64, float32 or bfloat16); y (B, L, I) in that
    dtype, the state carried in ``promote(dtype, float32)``. With
    ``return_state``, (y, h_L): the state after the last step, (B, I, N)
    in ``promote(dtype, float32)``. With ``save_states``, (y, h_L or
    None, states): each segment's entry state, which
    :func:`mamba_scan_bwd` takes."""
    global launches
    batch, length, inner, n = _check((x, dt, Bm, Cm, a, d_skip),
                                     "mamba scan kernel")
    y = torch.empty_like(x)
    acc = torch.promote_types(x.dtype, torch.float32)
    # a scan of no step leaves the state at 0
    h_last = (torch.zeros if length == 0 else torch.empty)(
        (batch, inner, n), dtype=acc, device=x.device) \
        if return_state else None
    states = None
    if batch == 0 or length == 0 or inner == 0:
        return _result(y, h_last, save_states, return_state, states)
    lib = _library()
    if save_states:
        states = torch.empty((batch, lib.mamba_scan_segments(length), n,
                              inner), dtype=acc, device=x.device)
    fn = getattr(lib, _ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        # the flags, the block counter and the chunks' records; the C
        # launcher zeroes the flags and counter on the stream
        scratch = torch.empty(
            lib.mamba_scan_scratch_bytes(batch, length, inner, n,
                                         acc.itemsize),
            dtype=torch.uint8, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 a.data_ptr(), d_skip.data_ptr(), y.data_ptr(),
                 None if h_last is None else h_last.data_ptr(),
                 None if states is None else states.data_ptr(),
                 scratch.data_ptr(), batch, length, inner, n, stream)
    if err != 0:
        msg = lib.mamba_scan_error_string(err).decode()
        raise RuntimeError(f"mamba scan kernel launch failed: {msg} ({err})")
    launches += 1
    return _result(y, h_last, save_states, return_state, states)


def _result(y, h_last, save_states, return_state, states):
    if save_states:
        return y, h_last, states
    return (y, h_last) if return_state else y


def mamba_scan_bwd(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                   dy: torch.Tensor, states: torch.Tensor,
                   dh_last: Optional[torch.Tensor] = None):
    """(dx, ddt, dBm, dCm, da, dd_skip) of :func:`mamba_scan` on the card,
    each in the operands' dtype, from the output's gradient ``dy`` (as
    x), the forward's ``states`` (``save_states``) and, where given, the
    final state's gradient ``dh_last`` ((B, I, N) in the accumulation
    type)."""
    global bwd_launches
    what = "mamba scan backward kernel"
    batch, length, inner, n = _check((x, dt, Bm, Cm, a, d_skip, dy), what)
    acc = torch.promote_types(x.dtype, torch.float32)
    grads = tuple(torch.empty_like(t) for t in (x, dt, Bm, Cm, a, d_skip))
    if batch == 0 or length == 0 or inner == 0:
        return tuple(g.zero_() for g in grads)     # nothing flows back
    if states is None:
        raise ValueError(f"{what} needs the forward's states")
    lib = _bwd_library()
    want = (batch, _library().mamba_scan_segments(length), n, inner)
    for name, t, shape in (("states", states, want),
                           ("dh_last", dh_last, (batch, inner, n))):
        if t is not None and (t.dtype != acc or t.device != x.device
                              or tuple(t.shape) != shape
                              or not t.is_contiguous()):
            raise ValueError(f"{what} needs {name} as a contiguous {shape} "
                             f"{acc} tensor on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    fn = getattr(lib, _BWD_ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        work = torch.empty(
            lib.mamba_scan_bwd_work_bytes(batch, length, inner, n,
                                          acc.itemsize),
            dtype=torch.uint8, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (x, dt, Bm, Cm, a, d_skip, dy,
                                          states)),
                 None if dh_last is None else dh_last.data_ptr(),
                 *(g.data_ptr() for g in grads), work.data_ptr(), batch,
                 length, inner, n, stream)
    if err != 0:
        msg = lib.mamba_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"mamba scan backward kernel launch failed: "
                           f"{msg} ({err})")
    bwd_launches += 1
    return grads
