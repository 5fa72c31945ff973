"""Demo: the hint→compile→dispatch loop with zero hand-written hints.

1. An *unhinted* PolyBench-style kernel runs a few times under the
   dynamic tracer (``optimize(profile=True)``).
2. The profiler folds the observed signatures into the same
   ``'ndarray[f64,2]'`` hints a programmer would have written, compiles
   through the full paper pipeline, and swaps dispatch over to the
   multi-version decision tree (original function stays the fallback).
3. The compiled variants persist in an on-disk cache: a *fresh compiler
   instance* (simulating a process restart) rebuilds the dispatcher from
   stored source and skips parse → SCoP → schedule → codegen entirely.
4. A background specializer watches dispatch stats and pins the hot call
   signature to a precomputed decision.

The reference's ``examples/profile_then_compile.py`` with its imports
taken from ``repro_torch``; ``--device`` binds the whole-kernel torch
variant's device (the card by default; ``--device cpu`` for the CPU).

Run:  PYTHONPATH=src python examples/torch_profile_then_compile.py \
          [--device cpu]
"""

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.core import txp  # noqa: E402
from repro_torch.core.compiler import compile_kernel, optimize  # noqa: E402
from repro_torch.profiler import (Specializer, VariantCache,  # noqa: E402
                                  synthesize_hints)


# -- an unhinted kernel: note, no annotations anywhere ----------------------

def correlation(data, corr, mean, stddev, M, N):
    for j in range(0, M):
        mean[j] = 0.0
        for i in range(0, N):
            mean[j] = mean[j] + data[i, j]
        mean[j] = mean[j] / N
    for j in range(0, M):
        stddev[j] = 0.0
        for i in range(0, N):
            stddev[j] = stddev[j] + (data[i, j] - mean[j]) \
                * (data[i, j] - mean[j])
        stddev[j] = np.sqrt(stddev[j] / N)
    for i in range(0, N):
        for j in range(0, M):
            data[i, j] = (data[i, j] - mean[j]) / (np.sqrt(N) * stddev[j])
    for i in range(0, M):
        corr[i, i] = 1.0
        for j in range(i + 1, M):
            corr[i, j] = 0.0
            for k in range(0, N):
                corr[i, j] = corr[i, j] + data[k, i] * data[k, j]
            corr[j, i] = corr[i, j]


def make_args(M=40, N=50, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(N, M)), np.zeros((M, M)), np.zeros(M),
            np.zeros(M), M, N]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    txp.set_device(ap.parse_args(argv).device)
    # ---- 1+2: profile, synthesize, compile, dispatch ----------------------
    profiled = optimize(correlation, profile=True, warmup=3)
    ref_args = make_args()
    correlation(*ref_args)                       # ground truth

    for it in range(5):                          # 3 traced, then compiled
        args = make_args()
        profiled(*args)
        np.testing.assert_allclose(args[1], ref_args[1], atol=1e-8)
        phase = "traced" if it < 3 and profiled.compiled is None else \
            "compiled" if it >= 3 else "traced"
        print(f"call {it}: {phase}; results match original ✓")

    hints = synthesize_hints(profiled.trace)
    print("\nsynthesized hints (no hand-written annotations!):")
    for k, v in hints.items():
        print(f"  {k}: {v!r}")
    print("\ndispatch stats:", profiled.stats()["dispatch"]["variants"])

    # ---- 3: persistent cache across a simulated restart -------------------
    cache_dir = os.path.join(tempfile.gettempdir(), "automphc-torch-demo-cache")
    cold_cache = VariantCache(cache_dir)
    cold_cache.clear()

    t0 = time.perf_counter()
    compile_kernel(correlation, hints=hints, cache=cold_cache)
    cold_s = time.perf_counter() - t0

    warm_cache = VariantCache(cache_dir)         # fresh instance = restart
    t0 = time.perf_counter()
    ck = compile_kernel(correlation, hints=hints, cache=warm_cache)
    warm_s = time.perf_counter() - t0

    print(f"\ncold compile: {cold_s*1e3:7.1f} ms "
          f"(telemetry: {cold_cache.stats.as_dict()})")
    print(f"warm compile: {warm_s*1e3:7.1f} ms "
          f"(telemetry: {warm_cache.stats.as_dict()})")
    assert warm_cache.stats.codegen_skipped == 1, "warm start must skip codegen"
    print(f"speedup: {cold_s/warm_s:.1f}x — codegen skipped ✓")

    args = make_args()
    ck(*args)
    np.testing.assert_allclose(args[1], ref_args[1], atol=1e-8)
    print("warm-started kernel matches original ✓")

    # ---- 4: background specializer ----------------------------------------
    with Specializer(hot_threshold=4, interval_s=0.01) as sp:
        sp.register(ck)
        for _ in range(8):
            ck(*make_args())
            time.sleep(0.02)
    print(f"\nspecializer promotions: {sp.telemetry()['promotions']}, "
          f"pinned fast-path hits: {ck.spec_hits}")
    args = make_args()
    ck(*args)                                    # pinned path
    np.testing.assert_allclose(args[1], ref_args[1], atol=1e-8)
    print("specialized dispatch matches original ✓")


if __name__ == "__main__":
    main()
