#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a non-zero
exit:

1. Environment: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions; TF32 off for float32 products.
2. Build: every hand-written kernel from the sources in this checkout
   (one ``nvcc`` per source, started together), into ``build/kernels/``.
3. Each kernel against its plain torch version on the card, at the main
   path's chunk shape, an aligned square and a ragged shape, in every
   dtype the kernel takes, with the time of the kernel, of the plain
   version and of the one PyTorch call that computes the same function
   (``torch.matmul``, a yardstick the port never calls).
4. The main path at full size: ``gemm_rowscale`` compiled by
   ``repro_torch.core.compiler.compile_kernel`` and run on
   ``ClusterRuntime(workers=2, device="cuda")`` at n=16384, k=m=2048 in
   float64, twice (cold, then with everything cached on the workers).
   Its matmul-shaped pfor must execute on the ``cuda`` twin (the
   hand-written kernel in the workers) with no fallback, count no fault
   (no respawn, no expired heartbeat), and match numpy's ``2*A @ B``
   within 1e-8.
5. Summary: one JSON line with every kernel's numbers, the card's line,
   and as the last line ``{"ok": true, "device": {...}}``.

It needs a CUDA device and the checkout's ``src/``; without either it
exits non-zero before printing any result. It imports nothing of JAX
and nothing of the JAX package ``repro``.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0

# main path size (float64): ~0.55 GB of operands, 137 GFLOP
N_ROWS, K_DIM, M_DIM = 16384, 2048, 2048
WORKERS = 2

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet,
# dense): float64 on the tensor cores (DMMA) 67 TFLOP/s, float32 outside
# the tensor cores 67 TFLOP/s, bf16 989 TFLOP/s; HBM3 3.35 TB/s
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_S = 3.35e12

# max |kernel - plain| allowed, scaled like tests/test_kernels.py: the
# f32/bf16 tolerance applies both absolutely and relative to |plain|
TOL = {"float64": 1e-8, "float32": 2e-4, "bfloat16": 2e-2}


def gemm_rowscale(A: "ndarray[f64,2]", B: "ndarray[f64,2]",
                  C: "ndarray[f64,2]", n: int, k: int, m: int):
    """The repo's matmul-shaped pfor (benchmarks/stap.py): the scaled row
    keeps the dot inside a pfor body, and the pattern matcher fuses the
    scale into the ``__cuk.matmul`` operand."""
    for i in range(0, n):
        r = 2.0 * A[i, 0:k]
        C[i, 0:m] = np.dot(r, B[0:k, 0:m])


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events,
    after a warm-up)."""
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


def _bound(m: int, k: int, n: int, dtype: str, itemsize: int):
    """(least ms, what bounds it) for one (m,k)@(k,n) product: each input
    read once, the output written once, 2·m·k·n operations."""
    ops_s = 2.0 * m * k * n / PEAK_FLOPS[dtype]
    bytes_s = (m * k + k * n + m * n) * itemsize / PEAK_BYTES_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def check_matmul(torch, mm_kernel, matmul_ref):
    """Phase 3: the matmul kernel against its plain version."""
    dtypes = {"float64": torch.float64, "float32": torch.float32,
              "bfloat16": torch.bfloat16}
    chunk = (N_ROWS // (2 * WORKERS), K_DIM, M_DIM)   # main-path chunk
    cases = [("chunk", chunk, "float64"),
             ("square", (2048, 2048, 2048), "float64"),
             ("square", (2048, 2048, 2048), "float32"),
             ("square", (2048, 2048, 2048), "bfloat16"),
             ("ragged", (1000, 777, 1001), "float64"),
             ("ragged", (1000, 777, 1001), "float32"),
             ("ragged", (1000, 777, 1001), "bfloat16")]
    rng = np.random.default_rng(SEED)
    out = []
    for label, (m, k, n), dname in cases:
        dt = dtypes[dname]
        x = torch.from_numpy(rng.normal(size=(m, k))).to("cuda", dt)
        y = torch.from_numpy(rng.normal(size=(k, n))).to("cuda", dt)
        before = mm_kernel.launches
        got = mm_kernel.matmul(x, y)
        torch.cuda.synchronize()
        if mm_kernel.launches != before + 1:
            raise AssertionError("matmul wrapper did not count its launch")
        ref = matmul_ref(x, y)
        diff = (got.double() - ref.double()).abs()
        err = float(diff.max())
        tol = TOL[dname]
        allowed = tol if dname == "float64" else \
            tol + tol * ref.double().abs()
        if bool((diff > allowed).any()):
            raise AssertionError(
                f"matmul {label} {dname} {(m, k, n)}: max err {err:.3e} "
                f"over tolerance {tol:g}")
        ms = _time_ms(torch, lambda: mm_kernel.matmul(x, y))
        plain_ms = _time_ms(torch, lambda: matmul_ref(x, y))
        lib_ms = _time_ms(torch, lambda: torch.matmul(x, y))
        bound_ms, bound_by = _bound(m, k, n, dname, x.element_size())
        row = {"case": label, "shape": [m, k, n], "dtype": dname,
               "max_abs_err": err, "tol": tol, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops": 2.0 * m * k * n / (ms * 1e-3) / 1e12}
        out.append(row)
        print(f"matmul {label:6s} {dname:8s} {m}x{k}@{k}x{n}: "
              f"err {err:.3e} (tol {tol:g})  kernel {ms:.3f} ms "
              f"({row['tflops']:.2f} TFLOP/s)  plain {plain_ms:.3f} ms  "
              f"torch.matmul {lib_ms:.3f} ms  bound {bound_ms:.3f} ms "
              f"({bound_by})", flush=True)
    return out


def main_path(torch, compile_kernel, ClusterRuntime, mm_kernel, obs):
    """Phase 4: the compiler + cluster path at full size."""
    rng = np.random.default_rng(SEED + 1)
    A = rng.normal(size=(N_ROWS, K_DIM))
    B = rng.normal(size=(K_DIM, M_DIM))
    t0 = time.perf_counter()
    # trace=True: worker run spans give the compute and idle phases.
    # Liveness is the runtime's default (1 s beats, 15 missed): a chunk
    # result here is ~134 MB and takes seconds to cross its pipe, and no
    # run may count a fault (a respawn, an expired heartbeat) for it.
    rt = ClusterRuntime(workers=WORKERS, device="cuda", trace=True)
    print(f"fleet: {WORKERS} workers up in "
          f"{time.perf_counter() - t0:.2f} s "
          f"(start method {rt.start_method})", flush=True)

    def run(label):
        before = rt.phase_breakdown()
        st0 = rt.stats()
        obs.recorder().clear()
        C = np.zeros((N_ROWS, M_DIM))
        t0 = time.perf_counter()
        ck.call_variant("np", A, B, C, N_ROWS, K_DIM, M_DIM)
        wall = time.perf_counter() - t0
        phases = {k: round(v - before.get(k, 0.0), 4)
                  for k, v in sorted(rt.phase_breakdown().items())}
        # seconds per span name, head and worker tracks together (the
        # worker spans: deserialize, restore, run = the chunk body, diff)
        spans = {}
        for ev in obs.recorder().events():
            spans[ev.name] = round(spans.get(ev.name, 0.0) + ev.dur, 4)
        st1 = rt.stats()
        faults = {k: v - st0["faults"].get(k, 0)
                  for k, v in st1["faults"].items()
                  if v != st0["faults"].get(k, 0)}
        print(f"main path {label}: {wall:.3f} s "
              f"({N_ROWS / wall:.1f} rows/s); bytes shipped "
              f"{st1['bytes_shipped'] - st0['bytes_shipped']}; faults "
              f"{json.dumps(faults)}; phases (s) {json.dumps(phases)}; "
              f"spans (s) {json.dumps(dict(sorted(spans.items())))}",
              flush=True)
        if faults:
            raise AssertionError(f"main path {label} counted faults: "
                                 f"{json.dumps(faults)}")
        return C, wall

    try:
        for p in rt.profiles():
            print(f"worker {p.wid}: gpu {p.gpu_kind} f64 GEMM probe "
                  f"{p.gpu_gflops:.1f} GFLOP/s, h2d {p.h2d_gbs:.1f} GB/s, "
                  f"d2h {p.d2h_gbs:.1f} GB/s, host {p.gflops:.1f} GFLOP/s",
                  flush=True)
        ck = compile_kernel(gemm_rowscale, runtime=rt, workers=WORKERS)
        if "__cuk.matmul(" not in ck.source("np"):
            raise AssertionError("compiler emitted no cuda twin")
        ck.pfor_config.distribute_threshold = 0
        # every count to 0 just before the counted run
        mm_kernel.launches = 0
        for key in ("matmul_launches", "cuda_calls", "cuda_plain_calls",
                    "cuda_chunks", "cuda_fallbacks"):
            setattr(rt, key, 0)
        rt.chunks_executed.clear()
        C, wall = run("cold")
        st = rt.stats()
        launches = int(st["matmul_launches"]) + mm_kernel.launches
        # a second run: bodies and broadcast cells already cached
        C2, warm = run("warm")
    finally:
        rt.shutdown()
    ref = (2.0 * A) @ B
    err = float(np.abs(C - ref).max())
    err2 = float(np.abs(C2 - ref).max())
    executed = dict(st["chunks_executed"])
    print(f"main path: n={N_ROWS} k={K_DIM} m={M_DIM} float64; counted "
          f"run: chunks executed {executed}, cuda_fallbacks "
          f"{st['cuda_fallbacks']}, cuda_calls {st['cuda_calls']}, matmul "
          f"launches {launches}; max err {err:.3e} / {err2:.3e}",
          flush=True)
    if not executed.get("cuda", 0) > 0:
        raise AssertionError(f"no chunk executed on cuda: {executed}")
    if st["cuda_fallbacks"] != 0:
        raise AssertionError(f"{st['cuda_fallbacks']} cuda fallbacks")
    if not st["cuda_calls"] > 0 or st["cuda_plain_calls"] != 0:
        raise AssertionError(f"cuda_calls {st['cuda_calls']}, plain "
                             f"{st['cuda_plain_calls']}")
    if launches <= 0:
        raise AssertionError("the main path launched no matmul kernel")
    if not (np.isfinite(C).all() and err <= 1e-8 and err2 <= 1e-8):
        raise AssertionError(f"main path max err {err:.3e} / {err2:.3e}")
    return {"launches": launches, "wall_s": wall, "warm_s": warm,
            "max_abs_err": max(err, err2), "chunks_executed": executed}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    # 1. environment
    card = _nvidia_smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import obs
    from repro_torch.core.compiler import compile_kernel
    from repro_torch.distrib import ClusterRuntime
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.matmul import matmul as mm_kernel
    from repro_torch.kernels.matmul.ref import matmul_ref

    if any(m == "jax" or m.startswith("jax.") or m == "repro"
           or m.startswith("repro.") for m in sys.modules):
        raise AssertionError("the port loaded jax or the JAX package")

    # 2. build, one nvcc per source, all started together
    sources = [mm_kernel.SOURCE]
    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(kbuild.build, sources))
    for src, (lib, log, secs) in zip(sources, built):
        print(f"built {src.relative_to(ROOT)} -> "
              f"{lib.relative_to(ROOT)} in {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels against their plain versions
    cases = check_matmul(torch, mm_kernel, matmul_ref)

    # 4. the main path
    res = main_path(torch, compile_kernel, ClusterRuntime, mm_kernel, obs)

    # 5. summary
    chunk = cases[0]
    kernels = [{
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/matmul/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul/matmul.py:37",
        "launches": res["launches"],
        "max_abs_err": chunk["max_abs_err"],
        "ms": chunk["ms"], "plain_ms": chunk["plain_ms"],
        "bound_ms": chunk["bound_ms"], "bound_by": chunk["bound_by"],
        "library_ms": chunk["library_ms"],
        "shape": chunk["shape"], "dtype": chunk["dtype"],
        "dtypes": {c["dtype"]: max(d["max_abs_err"] for d in cases
                                   if d["dtype"] == c["dtype"])
                   for c in cases},
        "cases": cases,
        "main_path": res,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
