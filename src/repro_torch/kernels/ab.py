"""Time this checkout's float64 kernels against another checkout's on one
GPU, interleaved: other, this, this, other.

    PYTHONPATH=src python3 -m repro_torch.kernels.ab OTHER_CHECKOUT

Each checkout builds its own ``matmul.cu`` and ``flash_attention.cu``
with its own ``kernels/build.py`` (in a subprocess, so its headers are
its own) into its own ``build/kernels/``. This process loads both
libraries and calls their C entries on the same inputs: the matmul main
path's chunk (4096 x 2048 @ 2048 x 2048), a ragged matmul (odd K), the
attention path's chunk (Sq = Skv = 4096, D = 128) and gemma2_2b's widest
head (8 heads, S = 2048, D = 288, causal, window 4096, softcap 50), all
float64. It prints one line per case and round (mean of CUDA-event
times over 20 launches), the largest difference between the two
checkouts' outputs, and the card's name and power limit. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

_BUILD = ("import json, sys; from pathlib import Path; "
          "from repro_torch.kernels import build; "
          "print(json.dumps([str(build.build(Path(s))[0]) "
          "for s in sys.argv[1:]]))")
_SOURCES = ("src/repro_torch/kernels/matmul/csrc/matmul.cu",
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu")


def _libraries(root: Path):
    """(matmul, flash attention) libraries of the checkout at ``root``,
    built by that checkout's own build module."""
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    out = subprocess.run([sys.executable, "-c", _BUILD,
                          *(str(root / s) for s in _SOURCES)],
                         cwd=root, env=env, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"build in {root} failed:\n{out.stderr}")
    mm, fa = (ctypes.CDLL(p) for p in json.loads(out.stdout.splitlines()[-1]))
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    mm.matmul_f64.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr]
    fa.flash_attention_f64.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64,
                                       i64, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_double, ptr]
    return mm, fa


def _cases(torch, mm, fa):
    """{case: (launch, output)} calling this library pair's entries."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape, std=1.0):
        return std * torch.randn(*shape, generator=gen, device="cuda",
                                 dtype=torch.float64)

    def check(err):
        if err != 0:
            raise RuntimeError(f"launch failed ({err})")

    cases = {}
    for label, (m, k, n) in (("matmul chunk", (4096, 2048, 2048)),
                             ("matmul ragged", (1000, 777, 1001))):
        x, y = normal(m, k), normal(k, n)
        o = torch.empty(m, n, dtype=torch.float64, device="cuda")
        cases[label] = (
            lambda mm=mm, x=x, y=y, o=o, m=m, n=n, k=k: check(mm.matmul_f64(
                x.data_ptr(), y.data_ptr(), o.data_ptr(), m, n, k,
                torch.cuda.current_stream().cuda_stream)), o)
    for label, (bh, s, d, causal, window, cap) in (
            ("flash chunk", (1, 4096, 128, 0, 0, 0.0)),
            ("flash gemma2 D=288", (8, 2048, 288, 1, 4096, 50.0))):
        q, kk, v = (normal(bh, s, d, std=d ** -0.25) for _ in range(3))
        o = torch.empty_like(q)
        cases[label] = (
            lambda fa=fa, q=q, kk=kk, v=v, o=o, bh=bh, s=s, d=d, c=causal,
            w=window, cap=cap: check(fa.flash_attention_f64(
                q.data_ptr(), kk.data_ptr(), v.data_ptr(), o.data_ptr(), bh,
                s, s, d, c, w, cap, torch.cuda.current_stream().cuda_stream)),
            o)
    return cases


def _time_ms(torch, fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv) -> int:
    import torch

    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    this = Path(__file__).resolve().parents[3]
    other = Path(argv[0]).resolve()
    libs = {"this": _libraries(this), "other": _libraries(other)}
    runs = {name: _cases(torch, *pair) for name, pair in libs.items()}
    times = {label: {"this": [], "other": []} for label in runs["this"]}
    for name in ("other", "this", "this", "other"):
        for label, (fn, _) in runs[name].items():
            times[label][name].append(_time_ms(torch, fn))
    for label in times:
        diff = float((runs["this"][label][1]
                      - runs["other"][label][1]).abs().max())
        print(f"{label}: this {times[label]['this']} ms, other "
              f"{times[label]['other']} ms, max |this - other| {diff:.3e}",
              flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"times_ms": times, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
