"""The numpy-compatible torch namespace of the ``torch`` backend.

Generated torch code computes through this module: torch twins of pfor
bodies bind it as ``__txp``, the whole-kernel torch variant as ``xp``.
It plays the part ``jax.numpy`` plays for the reference package's jnp
twin: every function the code generator can emit for an accelerator
body (the knowledge base's elementwise functions, ``dot``, ``einsum``,
``transpose``, ``where``, ``arange``, ``tri``, ``fft.*``, allocations and
the array constructors) is a plain function on tensors here, with numpy's
semantics where torch's differ:

* python floats, ``arange`` bounds and allocations without a dtype are
  float64/int64 (numpy's defaults), not torch's float32;
* results take numpy's dtype (:func:`result_type`): integer operands of
  ``sqrt``/``exp``/``log``/``sin``/``cos``/``mean`` and of a true
  division give float64 (torch gives its default, float32), an integer
  with a float takes numpy's wider type, and python scalars are weak
  (NEP 50: a float32 tensor and ``0.0`` stay float32) while numpy
  scalars and 0-d arrays are strong (``np.float64`` widens float32). The
  code generator writes every arithmetic operator of torch code as one
  of :func:`add` … :func:`power` for this reason;
* ``dot`` follows ``np.dot`` for every rank (``torch.dot`` is 1-D only)
  and promotes mixed operand dtypes, as do ``einsum`` and ``where``;
* ``maximum``/``minimum``/``power`` take python scalars;
* ``imag`` of a real tensor is zeros;
* ``asarray`` of a numpy array always copies (on the CPU
  ``torch.from_numpy`` would alias the caller's buffer, and generated
  code writes its locals in place); ``array`` always copies.

Operands may be tensors, numpy arrays or python scalars; numpy operands
(a captured array's slice in an eager twin) are copied to the bound
device. :func:`host` brings a result home as numpy for a store into a
captured array — an explicit device→host copy.

The device is the process's, bound by :func:`set_device` (a cluster
worker binds its own, as :mod:`repro_torch.kernels.api` does). It is
``"cuda"`` unless bound otherwise: on a host without CUDA the first
computation raises :class:`DeviceUnavailable`, which says how to bind
the CPU (``set_device("cpu")``). Nothing here falls back from the card
to the CPU.
"""

from __future__ import annotations

import operator as _operator
import types
from typing import Any

import numpy as np
import torch

__all__ = [
    "DeviceUnavailable", "set_device", "device", "result_type", "add",
    "subtract", "multiply", "true_divide", "floor_divide", "remainder",
    "asarray", "array", "host", "dot", "einsum",
    "transpose", "where", "arange", "tri", "tril", "triu",
    "zeros", "empty", "ones", "sqrt", "abs", "exp", "log", "sin", "cos",
    "conj", "real", "imag", "square", "reciprocal", "maximum", "minimum",
    "power", "sum", "mean", "fft",
]

_DEVICE = "cuda"

# numpy dtype → torch dtype for arrays numpy hands us
_NP_TO_TORCH = {
    np.dtype(np.float64): torch.float64, np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16, np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32, np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool, np.dtype(np.complex128): torch.complex128,
    np.dtype(np.complex64): torch.complex64,
}
_TORCH_TO_NP = {t: n for n, t in _NP_TO_TORCH.items()}
_WEAK = (bool, int, float, complex)


class DeviceUnavailable(RuntimeError):
    """The bound device does not exist on this host."""


def set_device(dev: str) -> None:
    """Bind this process's torch-backend device: ``"cuda"`` (or
    ``"cuda:N"``) or ``"cpu"``. A CUDA device on a host without one
    raises here, at binding."""
    global _DEVICE
    if dev != "cpu" and not str(dev).startswith("cuda"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev!r}")
    if dev != "cpu":
        _check_cuda(dev)
    _DEVICE = dev


def device() -> torch.device:
    """The bound device (raises when it is CUDA and torch sees none)."""
    if _DEVICE != "cpu":
        _check_cuda(_DEVICE)
    return torch.device(_DEVICE)


def _check_cuda(dev: str) -> None:
    if not torch.cuda.is_available():
        raise DeviceUnavailable(
            f"the torch backend is bound to {dev!r}, but torch sees no "
            f"CUDA device on this host; to compute on the CPU instead, "
            f"call repro_torch.core.txp.set_device(\"cpu\") first")


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is bool:
        return torch.bool
    if dtype is float:
        return torch.float64
    if dtype is int:
        return torch.int64
    if dtype is complex:
        return torch.complex128
    return _NP_TO_TORCH[np.dtype(dtype)]


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """Copy of a numpy array on the bound device (never aliasing it)."""
    a = np.asarray(a)   # a ChunkSlice view becomes a plain ndarray
    if a.dtype.byteorder not in ("=", "|"):
        a = a.astype(a.dtype.newbyteorder("="))
    if a.ndim and not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    return torch.from_numpy(a).to(device(), copy=True)


def _t(x: Any) -> torch.Tensor:
    """Operand → tensor on the bound device (tensors pass through)."""
    if isinstance(x, torch.Tensor):
        return x
    return _from_numpy(np.asarray(x))   # python scalars: numpy's dtype


_RESULT: dict = {}


def _np_key(x: Any):
    """What numpy's promotion sees of an operand: the dtype of a tensor,
    array or numpy scalar (strong), the type of a python scalar (weak)."""
    if isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
        return x.dtype
    return type(x)


def result_type(*xs: Any) -> torch.dtype:
    """numpy's result dtype of ``xs`` as a torch dtype: tensors, arrays
    and numpy scalars by their dtype, python scalars weak (NEP 50)."""
    key = tuple(_np_key(x) for x in xs)
    dt = _RESULT.get(key)
    if dt is None:
        args = [_TORCH_TO_NP[k] if isinstance(k, torch.dtype)
                else k if isinstance(k, np.dtype) else k(0) for k in key]
        dt = _RESULT[key] = _NP_TO_TORCH[np.result_type(*args)]
    return dt


def _to(x: Any, dt: torch.dtype):
    """``x`` at dtype ``dt``: tensors cast, numpy operands copied to the
    device, python scalars as they are (torch applies them at the other
    operand's dtype, as numpy does a weak scalar)."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == dt else x.to(dt)
    if isinstance(x, np.generic):
        return x.item()    # strong: ``dt`` already holds its dtype
    if isinstance(x, _WEAK):
        return x
    return _t(x).to(dt)


def _common(*xs: Any):
    """Operands as tensors at numpy's result dtype (torch's products and
    ``maximum`` need tensors of one dtype); a python scalar becomes a
    0-d tensor at that dtype, weak as numpy takes it."""
    dt = result_type(*xs)
    out = []
    for x in xs:
        x = _to(x, dt)
        if not isinstance(x, torch.Tensor):
            x = torch.full((), x, dtype=dt, device=device())
        out.append(x)
    return out


# -- arithmetic (the operators of generated torch code) -----------------------

def _binary(op, a: Any, b: Any, floating: bool = False):
    """``op(a, b)`` at numpy's result dtype (``floating``: at least
    float64 for integer operands, as numpy's true division)."""
    ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
    if not (ta or tb or isinstance(a, np.ndarray)
            or isinstance(b, np.ndarray)):
        return op(a, b)                  # scalars: python's/numpy's own
    if ta and tb and a.dtype == b.dtype and (
            not floating or a.is_floating_point() or a.is_complex()):
        return op(a, b)
    dt = result_type(a, b)
    if floating and not (dt.is_floating_point or dt.is_complex):
        dt = torch.float64
    return op(_to(a, dt), _to(b, dt))


def add(a, b): return _binary(_operator.add, a, b)
def subtract(a, b): return _binary(_operator.sub, a, b)
def multiply(a, b): return _binary(_operator.mul, a, b)
def floor_divide(a, b): return _binary(_operator.floordiv, a, b)
def remainder(a, b): return _binary(_operator.mod, a, b)


def true_divide(a, b):
    """``a / b`` as numpy: integer operands divide in float64."""
    return _binary(_operator.truediv, a, b, floating=True)


# -- constructors and the host boundary ------------------------------------

def asarray(x: Any, dtype=None) -> torch.Tensor:
    """A tensor of ``x`` on the bound device: tensors as they are (cast
    to ``dtype`` when given), numpy arrays and scalars copied."""
    t = _t(x)
    return t if dtype is None else t.to(_torch_dtype(dtype))


def array(x: Any, dtype=None) -> torch.Tensor:
    """Like :func:`asarray`, but always a fresh copy."""
    t = _t(x)
    if t is x:
        t = t.clone()
    return t if dtype is None else t.to(_torch_dtype(dtype))


def host(x: Any):
    """Bring a value home for a store into a captured numpy array:
    tensors are copied device→host, everything else passes through."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def arange(*args, dtype=None) -> torch.Tensor:
    """``np.arange``: integer bounds give int64, floats float64."""
    if dtype is None:
        dtype = (torch.float64 if any(isinstance(a, float) for a in args)
                 else torch.int64)
    return torch.arange(*args, dtype=_torch_dtype(dtype), device=device())


def tri(n: int, m: int = None, k: int = 0, dtype=float) -> torch.Tensor:
    """``np.tri``: ones at and below the k-th diagonal."""
    m = n if m is None else m
    mask = torch.ones((int(n), int(m)), dtype=torch.bool,
                      device=device()).tril(int(k))
    return mask.to(_torch_dtype(dtype))


def tril(x: Any, k: int = 0) -> torch.Tensor:
    return torch.tril(_t(x), int(k))


def triu(x: Any, k: int = 0) -> torch.Tensor:
    return torch.triu(_t(x), int(k))


def _shape(shape):
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(s) for s in shape)


def zeros(shape, dtype=float) -> torch.Tensor:
    return torch.zeros(_shape(shape), dtype=_torch_dtype(dtype),
                       device=device())


def empty(shape, dtype=float) -> torch.Tensor:
    return torch.empty(_shape(shape), dtype=_torch_dtype(dtype),
                       device=device())


def ones(shape, dtype=float) -> torch.Tensor:
    return torch.ones(_shape(shape), dtype=_torch_dtype(dtype),
                      device=device())


# -- products ---------------------------------------------------------------

def dot(a: Any, b: Any) -> torch.Tensor:
    """``np.dot``: scalar product for a 0-d operand, a product with a
    vector as multiply-and-sum, ``matmul`` for two matrices, else the
    sum over a's last and b's second-to-last axis.

    Both forms give a twin's batched path (``torch.func.vmap``, where a
    product becomes a batched gemm) and its eager loop the same bits on
    the CPU: a product with a vector is not a gemv, which rounds unlike
    the batched gemm, but a multiply-and-sum, which reduces in the same
    order either way; two matrices go through the batched gemm as a
    batch of one, not through the plain gemm, which takes another code
    path at small sizes."""
    a, b = _common(_t(a), _t(b))
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if b.ndim == 1 and a.ndim <= 2:
        return (a * b).sum(-1)
    if a.ndim == 1 and b.ndim == 2:
        return (a[:, None] * b).sum(-2)
    if a.ndim == 2 and b.ndim == 2:
        return torch.matmul(a[None], b[None])[0]
    return torch.tensordot(a, b, dims=([a.ndim - 1],
                                       [b.ndim - 2 if b.ndim > 1 else 0]))


def einsum(spec: str, *ops: Any, **_numpy_only) -> torch.Tensor:
    """``np.einsum`` over operands promoted to one dtype (numpy's
    ``optimize=`` is accepted and ignored)."""
    return torch.einsum(spec, *_common(*[_t(o) for o in ops]))


# -- structure ---------------------------------------------------------------

def transpose(x: Any, axes=None) -> torch.Tensor:
    x = _t(x)
    if axes is None:
        axes = tuple(reversed(range(x.ndim)))
    return x.permute(tuple(axes))


def where(cond: Any, a: Any, b: Any) -> torch.Tensor:
    c = _t(cond)
    if c.dtype != torch.bool:
        c = c != 0
    a, b = _common(a, b)
    return torch.where(c, a, b)


# -- elementwise (the knowledge base's np.<fn> entries) -----------------------

_FLOAT_OF: dict = {}


def _floating(x: Any, ufunc) -> torch.Tensor:
    """``x`` as a tensor, integer and bool dtypes cast to the dtype numpy
    gives ``ufunc`` of them (float64 for int32/int64)."""
    x = _t(x)
    if x.is_floating_point() or x.is_complex():
        return x
    key = (x.dtype, ufunc)
    dt = _FLOAT_OF.get(key)
    if dt is None:
        npd = ufunc(np.ones((), _TORCH_TO_NP[x.dtype])).dtype
        dt = _FLOAT_OF[key] = _NP_TO_TORCH[npd]
    return x.to(dt)


def sqrt(x): return torch.sqrt(_floating(x, np.sqrt))
def abs(x): return torch.abs(_t(x))                      # noqa: A001
def exp(x): return torch.exp(_floating(x, np.exp))
def log(x): return torch.log(_floating(x, np.log))
def sin(x): return torch.sin(_floating(x, np.sin))
def cos(x): return torch.cos(_floating(x, np.cos))
def conj(x): return torch.conj(_t(x))
def real(x): return torch.real(_t(x))
def square(x):
    x = _t(x)
    return x * x


def imag(x):
    x = _t(x)
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def reciprocal(x):
    x = _t(x)
    return 1 / x if x.is_floating_point() or x.is_complex() \
        else torch.floor_divide(torch.ones_like(x), x)


def maximum(a, b):
    return torch.maximum(*_common(a, b))


def minimum(a, b):
    return torch.minimum(*_common(a, b))


def power(a, b):
    return _binary(_operator.pow, a, b)


# -- reductions ---------------------------------------------------------

def sum(x, axis=None):                                   # noqa: A001
    x = _t(x)
    return x.sum() if axis is None else x.sum(dim=axis)


def mean(x, axis=None):
    x = _floating(x, np.mean)
    return x.mean() if axis is None else x.mean(dim=axis)


# -- spectral -----------------------------------------------------------

def _fft(x, n=None, axis=-1):
    return torch.fft.fft(_t(x), n=n, dim=axis)


def _ifft(x, n=None, axis=-1):
    return torch.fft.ifft(_t(x), n=n, dim=axis)


fft = types.SimpleNamespace(fft=_fft, ifft=_ifft)
