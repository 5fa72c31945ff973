"""Time this checkout's kernels against another checkout's on one GPU,
interleaved: other, this, this, other.

    PYTHONPATH=src python3 -m repro_torch.kernels.ab OTHER_CHECKOUT

Each checkout builds its own ``matmul.cu``, ``flash_attention.cu`` and
``mamba_scan.cu`` with its own ``kernels/build.py`` (``ab_common.py``). This process
loads both sets of libraries and calls their C entries on the same
inputs (the flash entry by each library's own signature: the query
offset, which the other checkout's must take too, and where
``flash_attention_abi() >= 2`` a null logsumexp pointer after o; the
scan entry by each library's own): the matmul main path's chunk (4096 x 2048
@ 2048 x 2048), a ragged matmul (odd K), the attention path's chunk (Sq =
Skv = 4096, D = 128) and gemma2_2b's widest head (8 heads, S = 2048, D =
288, causal, window 4096, softcap 50), all float64; and the selective
scan at the scan path's chunk (B = 1, L = 2048, I = 2048, N = 1, float64,
through ``api.scan_rows``'s mapping), a Jamba-1.5-Large Mamba layer (L =
2048, I = 16384, N = 16, float32), the same layer at a 16k prompt (L =
16384) and a ragged case (B = 2, L = 1000, I = 77, N = 4, float64). A
scan library whose entries take scratch (the chunked scan) gets a
scratch allocated per call, as its wrapper does, and one whose entries
take the final state's pointer (``mamba_scan_abi() >= 2``) and the
segments' states' (``>= 3``) gets null there. It prints one line per
case and round (mean of CUDA-event times over 20 launches), the
largest difference between the two checkouts' outputs, for the scan
each checkout's largest difference from the recurrence in float64 on
the same inputs, and the card's name and power limit.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import json
import math
import sys
from pathlib import Path

from .ab_common import build, build_all, card, time_ms

_SOURCES = ("src/repro_torch/kernels/matmul/csrc/matmul.cu",
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu")
_SCAN_ENTRY = {"float64": "mamba_scan_f64", "float32": "mamba_scan_f32"}


def _libraries(root: Path):
    """(matmul, flash attention, scan) libraries of the checkout at
    ``root``, built by that checkout's own build module."""
    mm, fa, sc = (ctypes.CDLL(str(p)) for p in build(root, _SOURCES))
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    mm.matmul_f64.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr]
    # q, k, v, o, [lse,] q_offset (passed null: every row at its own
    # index; no logsumexp)
    fa.flash_attention_f64.argtypes = [ptr] * (5 + _with_lse(fa)) + [
        i64] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_double, ptr]
    # the serial kernel's signature (no scratch, no plan) is here only to
    # time the chunked scan against the tree before it, commit d9c8578
    chunked = hasattr(sc, "mamba_scan_scratch_bytes")
    # entries of ABI 2 take h_last (passed null) after y, of ABI 3 h_seg
    # (null) after it
    pointers = 7 + chunked + _state_pointers(sc)
    for name in _SCAN_ENTRY.values():
        getattr(sc, name).argtypes = [ptr] * pointers + [i64] * 4 + [ptr]
    if chunked:
        sc.mamba_scan_scratch_bytes.argtypes = [i64] * 5
        sc.mamba_scan_scratch_bytes.restype = i64
    return mm, fa, sc


def _with_lse(fa) -> bool:
    """Whether ``fa``'s entries take the logsumexp pointer after o."""
    return hasattr(fa, "flash_attention_abi") and fa.flash_attention_abi() >= 2


def _state_pointers(sc) -> int:
    """How many state pointers ``sc``'s entries take after y: h_last
    (ABI 2) and h_seg (ABI 3)."""
    abi = sc.mamba_scan_abi() if hasattr(sc, "mamba_scan_abi") else 1
    return min(abi, 3) - 1


def _scan_call(torch, sc, args, y):
    """A launch of ``sc``'s scan entry on ``args`` (x, dt, Bm, Cm, a,
    d_skip), by the library's own signature."""
    batch, length, inner = args[0].shape
    n = args[2].shape[-1]
    fn = getattr(sc, _SCAN_ENTRY[str(args[0].dtype).split(".")[-1]])
    # the closures hold the tensors, not only their addresses, so that
    # the operands outlive the cases built after them
    ops = (*args, y)
    state = (None,) * _state_pointers(sc)
    if not hasattr(sc, "mamba_scan_scratch_bytes"):
        return lambda: _check(fn(*(t.data_ptr() for t in ops), batch,
                                 length, inner, n,
                                 torch.cuda.current_stream().cuda_stream))
    nbytes = sc.mamba_scan_scratch_bytes(
        batch, length, inner, n,
        torch.promote_types(args[0].dtype, torch.float32).itemsize)

    def call():
        scratch = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
        _check(fn(*(t.data_ptr() for t in ops), *state, scratch.data_ptr(),
                  batch, length, inner, n,
                  torch.cuda.current_stream().cuda_stream))
    return call


def _check(err):
    if err != 0:
        raise RuntimeError(f"launch failed ({err})")


def _cases(torch, mm, fa, sc):
    """{case: (launch, output, the scan's operands or None)} calling
    this library set's entries."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape, std=1.0, dtype=torch.float64):
        return std * torch.randn(*shape, generator=gen, device="cuda",
                                 dtype=dtype)

    cases = {}
    for label, (m, k, n) in (("matmul chunk", (4096, 2048, 2048)),
                             ("matmul ragged", (1000, 777, 1001))):
        x, y = normal(m, k), normal(k, n)
        o = torch.empty(m, n, dtype=torch.float64, device="cuda")
        cases[label] = (
            lambda mm=mm, x=x, y=y, o=o, m=m, n=n, k=k: _check(mm.matmul_f64(
                x.data_ptr(), y.data_ptr(), o.data_ptr(), m, n, k,
                torch.cuda.current_stream().cuda_stream)), o, None)
    for label, (bh, s, d, causal, window, cap) in (
            ("flash chunk", (1, 4096, 128, 0, 0, 0.0)),
            ("flash gemma2 D=288", (8, 2048, 288, 1, 4096, 50.0))):
        q, kk, v = (normal(bh, s, d, std=d ** -0.25) for _ in range(3))
        o = torch.empty_like(q)
        cases[label] = (
            lambda fa=fa, q=q, kk=kk, v=v, o=o, bh=bh, s=s, d=d, c=causal,
            w=window, cap=cap: _check(fa.flash_attention_f64(
                q.data_ptr(), kk.data_ptr(), v.data_ptr(), o.data_ptr(),
                *(None,) * (1 + _with_lse(fa)), bh, s, s, d, c, w, cap,
                torch.cuda.current_stream().cuda_stream)),
            o, None)
    for label, (b, length, inner, n), dtype in (
            ("scan chunk", (1, 2048, 2048, 1), torch.float64),
            ("scan jamba f32", (1, 2048, 16384, 16), torch.float32),
            ("scan jamba_long f32", (1, 16384, 16384, 16), torch.float32),
            ("scan ragged", (2, 1000, 77, 4), torch.float64)):
        x = normal(b, length, inner, dtype=dtype)
        if label == "scan chunk":          # api.scan_rows's mapping, c = 0.9
            dt = torch.ones_like(x)
            bm = cm = torch.ones(b, length, 1, dtype=dtype, device="cuda")
            a = torch.full((inner, 1), math.log(-math.log(0.9)),
                           dtype=dtype, device="cuda")
            d_skip = torch.zeros(inner, dtype=dtype, device="cuda")
        else:
            dt = 0.1 * normal(b, length, inner, dtype=dtype).abs()
            bm, cm = (normal(b, length, n, dtype=dtype) for _ in range(2))
            a = (normal(inner, n, dtype=dtype).abs() + 0.5).log()
            d_skip = normal(inner, dtype=dtype)
        args = (x, dt, bm, cm, a, d_skip)
        y = torch.empty_like(x)
        cases[label] = (_scan_call(torch, sc, args, y), y, args)
    return cases


def main(argv) -> int:
    import torch

    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    this = Path(__file__).resolve().parents[3]
    other = Path(argv[0]).resolve()
    built = build_all([this, other], _libraries)
    libs = {"this": built[str(this)], "other": built[str(other)]}
    runs = {name: _cases(torch, *pair) for name, pair in libs.items()}
    times = {label: {"this": [], "other": []} for label in runs["this"]}
    for name in ("other", "this", "this", "other"):
        for label, (fn, _, _) in runs[name].items():
            times[label][name].append(time_ms(torch, fn))
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

    errors = {}
    for label in times:
        line = f"{label}: this {times[label]['this']} ms"
        if label in runs["other"]:
            diff = float((runs["this"][label][1]
                          - runs["other"][label][1]).abs().max())
            line += (f", other {times[label]['other']} ms, max |this - "
                     f"other| {diff:.3e}")
        args = runs["this"][label][2]
        if args is not None:             # the scan: both against float64
            truth = mamba_scan_ref(*(t.double() for t in args))
            errors[label] = {
                name: float((run[label][1].double() - truth).abs().max())
                for name, run in runs.items() if label in run}
            del truth
            line += ", max |y - float64 recurrence| " + ", ".join(
                f"{name} {err:.3e}" for name, err in errors[label].items())
        print(line, flush=True)
    print(json.dumps({"times_ms": times, "max_err_vs_float64": errors,
                      "card": card()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
