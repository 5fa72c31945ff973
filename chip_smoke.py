#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a non-zero
exit:

1. Environment: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions; TF32 off for float32 products.
2. Build: every hand-written kernel from the sources in this checkout
   (one ``nvcc`` per source, started together), into ``build/kernels/``;
   fails if ptxas reports spill bytes for a float64 (DMMA) kernel.
3. Each kernel against its plain torch version on the card, in every
   dtype it takes, at its main path's chunk shape, at a language model's
   widths where the repo has one that runs it, and at a ragged shape;
   with the time of the kernel, of the plain version and, where one
   PyTorch call computes the same function, of that call (a yardstick
   the port never calls), beside the least time the card could take.
   The float64 matmul and flash attention, redesigned on the tensor
   cores, are printed beside their times before the redesign.
4. The main paths at full size, each compiled by
   ``repro_torch.core.compiler.compile_kernel`` and run twice (cold, then
   with everything cached on the workers) on one
   ``ClusterRuntime(workers=2, device="cuda")``, in float64:

   * matmul: ``gemm_rowscale`` at n=16384, k=m=2048;
   * attention: ``attn_kernel`` at n=16384 query rows, t=4096 keys,
     d=128;
   * scan: ``scan_kernel`` (c = 0.9) at 8192 rows x L=2048, a size at
     which the router prices the scan's chunks to ``cuda`` with a
     margin for a host with a fast copy (PERF.md, section 6).

   Each path's pfor must run every chunk on the ``cuda`` twin (the
   hand-written kernel in the workers) with no fallback and no plain
   call, launch its own kernel, count no fault (no respawn, no expired
   heartbeat), and match numpy within 1e-8 in both runs. Before each
   path every count is set to 0; the router's prices (``t_np`` and
   ``t_cuda`` per worker) are printed beside each worker's profile.
5. Summary: one JSON line with every kernel's numbers, the card's line,
   and as the last line ``{"ok": true, "device": {...}}``.

It needs a CUDA device and the checkout's ``src/``; without either it
exits non-zero before printing any result. It imports nothing of JAX
and nothing of the JAX package ``repro``.
"""

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
WORKERS = 2
# the cluster splits each worker's share in two (pipeline depth 2)
CHUNKS = 2 * WORKERS

# main-path sizes (float64)
N_ROWS, K_DIM, M_DIM = 16384, 2048, 2048       # matmul: ~0.55 GB, 137 GFLOP
ATTN_N, ATTN_T, ATTN_D = 16384, 4096, 128      # attention: ~48 MB, 34 GFLOP
SCAN_N, SCAN_L = 8192, 2048                    # scan: 2 x 134 MB
SCAN_C = 0.9                                   # scan_kernel's coefficient

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet,
# dense): float64 on the tensor cores (DMMA) 67 TFLOP/s, float32 outside
# the tensor cores 67 TFLOP/s, bf16 989 TFLOP/s; HBM3 3.35 TB/s
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_S = 3.35e12
# operations of one selective-scan step per (b, t, i, n): the exp, the
# dt*decay product, the state FMA (2) and the output FMA (2). float64
# exp is a software routine (range reduction and a polynomial) of about
# 20 double operations; float32 exp is counted as one (the SFU's ex2), a
# count that can only lower the bound
SCAN_OPS = {"float64": 20 + 5, "float32": 1 + 5, "bfloat16": 1 + 5}

# phase 3 cases of the flash-attention kernel: (label, (B, Sq, H, KVH,
# Skv, D), causal, window, softcap, dtype); H == 1 runs the kernel's own
# (BH, S, D) layout, H > 1 the GQA dispatch
FLASH_CASES = [
    ("chunk", (1, ATTN_N // CHUNKS, 1, 1, ATTN_T, ATTN_D), False, 0, 0.0,
     "float64"),
    ("gemma2", (1, 8192, 8, 4, 8192, 288), True, 4096, 50.0, "bfloat16"),
    ("gemma2", (1, 8192, 8, 4, 8192, 288), True, 4096, 50.0, "float32"),
    # the widest float64 tile (D = 288) at a shorter sequence
    ("gemma2", (1, 2048, 8, 4, 2048, 288), True, 4096, 50.0, "float64"),
    ("ragged", (1, 1000, 1, 1, 777, 72), False, 40, 30.0, "float32"),
    ("ragged", (1, 1000, 1, 1, 777, 72), False, 40, 30.0, "float64")]
# phase 3 cases of the selective-scan kernel: (label, (B, L, I, N), dtype)
SCAN_CASES = [
    ("chunk", (1, SCAN_L, SCAN_N // CHUNKS, 1), "float64"),
    ("jamba", (1, 2048, 16384, 16), "float32"),
    ("ragged", (2, 1000, 77, 4), "float64"),
    ("ragged", (2, 1000, 77, 4), "float32")]

# kernels with float64 functions on the tensor cores (DMMA): ptxas must
# report no spill byte for them
F64_DMMA = ("matmul", "flash_attention")
# their f64 main-path chunk times before the redesign (PERF.md section
# 6), printed beside this run's
EARLIER = "PR 12 run 4, H100 80GB HBM3, 700 W"
EARLIER_MS = {"matmul": 2.271, "flash_attention": 1.347}

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


def attn_kernel(Q: "ndarray[f64,2]", K: "ndarray[f64,2]",
                V: "ndarray[f64,2]", O: "ndarray[f64,2]",
                n: int, t: int, d: int):
    """The repo's attention-shaped pfor (tests/test_pallas_backend.py)."""
    for i in range(0, n):
        s = np.dot(K[0:t, 0:d], Q[i, 0:d])
        p = np.exp(s)
        o = np.dot(p, V[0:t, 0:d])
        O[i, 0:d] = o / np.sum(p)


def scan_kernel(X: "ndarray[f64,2]", Y: "ndarray[f64,2]",
                n: int, L: int):
    """The repo's scan-shaped pfor (tests/test_pallas_backend.py)."""
    for i in range(0, n):
        h = 0.0
        for t in range(0, L):
            h = 0.9 * h + X[i, t]
            Y[i, t] = h


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events,
    after a warm-up)."""
    for _ in range(min(3, reps)):
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


def _bound(ops: float, nbytes: float, dtype: str):
    """(least ms, what bounds it): ``ops`` at the dtype's peak against
    ``nbytes`` (each input read once, each output written once) at the
    memory's."""
    ops_s = ops / PEAK_FLOPS[dtype]
    bytes_s = nbytes / PEAK_BYTES_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def f64_spills(log: str) -> dict:
    """{kernel: (spill store bytes, spill load bytes)} from ``ptxas -v``
    for every function of the float64 (DMMA) kernels, whose mangled
    names hold their namespace ``f64``."""
    spills, fn = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif "spill stores" in line and fn is not None \
                and re.search(r"3f64\d+\w*_kernel", fn):
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spills[fn] = (nums[1], nums[2])   # stack, stores, loads
    return spills


def _launch_once(kernel, fn):
    """Run ``fn`` once; it must launch ``kernel`` exactly once."""
    before = kernel.launches
    out = fn()
    if kernel.launches != before + 1:
        raise AssertionError(f"{kernel.__name__} did not count its launch")
    return out


def _compare(torch, name, label, got, ref, dname):
    """Max |got - ref|; raises past the tolerance."""
    torch.cuda.synchronize()
    diff = (got.double() - ref.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    tol = TOL[dname]
    allowed = tol if dname == "float64" else tol + tol * ref.double().abs()
    if not bool(torch.isfinite(got.double()).all()) \
            or bool((diff > allowed).any()):
        raise AssertionError(f"{name} {label} {dname}: max err {err:.3e} "
                             f"over tolerance {tol:g}")
    return err


def _row(torch, name, label, shape, dname, err, kernel_fn, plain_fn,
         library_fn, ops, nbytes, reps=20, **extra):
    ms = _time_ms(torch, kernel_fn, reps)
    plain_ms = _time_ms(torch, plain_fn, max(2, reps // 4))
    lib_ms = _time_ms(torch, library_fn, reps) if library_fn else None
    bound_ms, bound_by = _bound(ops, nbytes, dname)
    row = {"case": label, "shape": shape, "dtype": dname,
           "max_abs_err": err, "tol": TOL[dname], "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "gops": ops / (ms * 1e-3) / 1e9, **extra}
    lib = f"{lib_ms:.3f} ms" if lib_ms is not None else "none"
    print(f"{name} {label:9s} {dname:8s} {shape}: err {err:.3e} "
          f"(tol {TOL[dname]:g})  kernel {ms:.3f} ms "
          f"({row['gops']:.1f} GOP/s)  plain {plain_ms:.3f} ms  "
          f"library {lib}  bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    return row


def _dtypes(torch):
    return {"float64": torch.float64, "float32": torch.float32,
            "bfloat16": torch.bfloat16}


def check_matmul(torch, mm_kernel, matmul_ref):
    """Phase 3: the matmul kernel against its plain version."""
    chunk = (N_ROWS // CHUNKS, K_DIM, M_DIM)   # main-path chunk
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
        dt = _dtypes(torch)[dname]
        x = torch.from_numpy(rng.normal(size=(m, k))).to("cuda", dt)
        y = torch.from_numpy(rng.normal(size=(k, n))).to("cuda", dt)
        got = _launch_once(mm_kernel, lambda: mm_kernel.matmul(x, y))
        err = _compare(torch, "matmul", label, got, matmul_ref(x, y), dname)
        out.append(_row(
            torch, "matmul", label, [m, k, n], dname, err,
            lambda: mm_kernel.matmul(x, y), lambda: matmul_ref(x, y),
            lambda: torch.matmul(x, y), 2.0 * m * k * n,
            (m * k + k * n + m * n) * x.element_size()))
    return out


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the attention of one head computes: the valid
    keys of each row, or every key for a row with none (it averages
    all of v, as the kernel and the reference do)."""
    q = np.arange(sq)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros_like(q)
    hi = np.minimum(skv - 1, q) if causal else np.full_like(q, skv - 1)
    n = np.maximum(0, hi - lo + 1)
    return int(np.where(n > 0, n, skv).sum())


def check_flash(torch, fa_kernel, fa_ops, fa_ref):
    """Phase 3: the flash-attention kernel against its plain version:
    (a) the attention path's chunk, (b) one gemma2_2b attention layer
    (B=1, S=8192, H=8, KVH=4, D=288, causal, window 4096, softcap 50;
    src/repro/configs/gemma2_2b.py) through the GQA dispatch, (c) a
    ragged case."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(SEED + 2)
    out = []
    for label, (b, sq, h, kvh, skv, d), causal, window, cap, dname \
            in FLASH_CASES:
        dt = _dtypes(torch)[dname]
        std = d ** -0.25          # unscaled scores q.k / sqrt(d) are O(1)
        q = torch.from_numpy(std * rng.normal(size=(b, sq, h, d)))
        k = torch.from_numpy(std * rng.normal(size=(b, skv, kvh, d)))
        v = torch.from_numpy(rng.normal(size=(b, skv, kvh, d)))
        opts = dict(causal=causal, window=window, softcap=cap)
        if h == 1:                # one head: the kernel's own layout
            q, k, v = (t[:, :, 0].to("cuda", dt).contiguous()
                       for t in (q, k, v))
            kernel_fn = lambda: fa_kernel.flash_attention_bhsd(  # noqa: E731
                q, k, v, **opts)
            plain_fn = lambda: fa_ref.flash_attention_bhsd_ref(  # noqa: E731
                q, k, v, **opts)
            library_fn = None if (causal or window or cap) else \
                (lambda: sdpa(q, k, v))
        else:                     # a GQA layer through the dispatch
            q, k, v = (t.to("cuda", dt) for t in (q, k, v))
            kernel_fn = lambda: fa_ops.flash_attention(q, k, v,  # noqa: E731
                                                       **opts)
            plain_fn = lambda: fa_ref.attention_ref(q, k, v,  # noqa: E731
                                                    **opts)
            library_fn = None     # softcap and window: no single call
        got = _launch_once(fa_kernel, kernel_fn)
        err = _compare(torch, "flash_attention", label, got, plain_fn(),
                       dname)
        pairs = b * h * attention_pairs(sq, skv, causal, window)
        nbytes = (2 * b * sq * h * d + 2 * b * skv * kvh * d) \
            * q.element_size()
        out.append(_row(
            torch, "flash_attention", label, [b, sq, h, kvh, skv, d], dname,
            err, kernel_fn, plain_fn, library_fn, 4.0 * pairs * d, nbytes,
            reps=10, causal=causal, window=window, softcap=cap))
        del q, k, v, got
        torch.cuda.empty_cache()
    return out


def check_scan(torch, sc_kernel, plain):
    """Phase 3: the selective-scan kernel against its plain version:
    (a) the scan path's chunk through api.scan_rows's mapping (B=1,
    I=rows, N=1, dt=1, B=C=1, a=log(-log c)), (b) one Jamba-1.5-Large
    Mamba layer (d_model 8192, ssm_expand 2 -> I=16384, ssm_state 16;
    src/repro/configs/jamba_1_5_large_398b.py) at L=2048 in float32, as
    the reference's models/ssm.py scans, (c) a ragged case."""
    rng = np.random.default_rng(SEED + 3)
    out = []
    for label, (b, length, inner, n), dname in SCAN_CASES:
        dt_ = _dtypes(torch)[dname]
        x = torch.from_numpy(rng.normal(size=(b, length, inner)))
        if label == "chunk":
            dt = torch.ones((b, length, inner), dtype=torch.float64)
            bm = cm = torch.ones((b, length, 1), dtype=torch.float64)
            a = torch.full((inner, 1), float(np.log(-np.log(SCAN_C))),
                           dtype=torch.float64)
            d_skip = torch.zeros((inner,), dtype=torch.float64)
        else:
            dt = torch.from_numpy(
                0.1 * np.abs(rng.normal(size=(b, length, inner))))
            bm = torch.from_numpy(rng.normal(size=(b, length, n)))
            cm = torch.from_numpy(rng.normal(size=(b, length, n)))
            a = torch.from_numpy(
                np.log(np.abs(rng.normal(size=(inner, n))) + 0.5))
            d_skip = torch.from_numpy(rng.normal(size=(inner,)))
        args = [t.to("cuda", dt_).contiguous()
                for t in (x, dt, bm, cm, a, d_skip)]
        kernel_fn = lambda: sc_kernel.mamba_scan(*args)  # noqa: E731
        plain_fn = lambda: plain(*args)  # noqa: E731
        got = _launch_once(sc_kernel, kernel_fn)
        err = _compare(torch, "mamba_scan", label, got, plain_fn(), dname)
        nbytes = sum(t.numel() for t in args) * args[0].element_size() \
            + got.numel() * got.element_size()
        out.append(_row(
            torch, "mamba_scan", label, [b, length, inner, n], dname, err,
            kernel_fn, plain_fn, None,
            float(b * length * inner * n * SCAN_OPS[dname]), nbytes,
            reps=10))
    return out


def _record_pricing(cost):
    """Wrap the router's pricing table so each pfor round's per-worker
    prices (t_np, t_cuda and the pick) can be printed."""
    seen = []
    table = cost.unit_backend_table

    def recording(flops, nbytes, profiles, allow_jnp=True, candidates=None):
        profiles = list(profiles)
        picks = table(flops, nbytes, profiles, allow_jnp, candidates)
        seen.append([{
            "wid": p.wid, "flops": flops, "bytes": nbytes,
            "t_np": cost.chunk_backend_seconds(flops, nbytes, p, "np"),
            "t_cuda": cost.chunk_backend_seconds(flops, nbytes, p, "cuda"),
            "pick": pick} for p, pick in zip(profiles, picks)])
        return picks

    cost.unit_backend_table = recording
    return seen


def run_path(rt, compile_kernel, obs, kernel, pricing, *, name, fn, twin,
             inputs, out_index, want, rows):
    """Phase 4, one path: compile ``fn``, zero every count, run it cold
    and warm on the fleet, check the counts and the results."""
    ck = compile_kernel(fn, runtime=rt, workers=WORKERS)
    if twin not in ck.source("np"):
        raise AssertionError(f"{name}: compiler emitted no {twin} twin")
    ck.pfor_config.distribute_threshold = 0
    key = f"{name}_launches"

    def run(label):
        before = rt.phase_breakdown()
        st0 = rt.stats()
        obs.recorder().clear()
        args = list(inputs)
        args[out_index] = np.zeros_like(inputs[out_index])
        del pricing[:]
        t0 = time.perf_counter()
        ck.call_variant("np", *args)
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
        print(f"{name} path {label}: {wall:.3f} s ({rows / wall:.1f} "
              f"rows/s); bytes shipped "
              f"{st1['bytes_shipped'] - st0['bytes_shipped']}; faults "
              f"{json.dumps(faults)}; router {json.dumps(pricing)}; "
              f"phases (s) {json.dumps(phases)}; spans (s) "
              f"{json.dumps(dict(sorted(spans.items())))}", flush=True)
        if faults:
            raise AssertionError(f"{name} path {label} counted faults: "
                                 f"{json.dumps(faults)}")
        return args[out_index], wall

    # every count to 0 just before the path's runs
    kernel.launches = 0
    for k in (key, "cuda_calls", "cuda_plain_calls", "cuda_chunks",
              "cuda_fallbacks"):
        setattr(rt, k, 0)
    rt.chunks_executed.clear()
    out, wall = run("cold")
    out2, warm = run("warm")
    st = rt.stats()
    launches = int(st[key]) + kernel.launches
    err = float(np.abs(out - want).max())
    err2 = float(np.abs(out2 - want).max())
    executed = dict(st["chunks_executed"])
    print(f"{name} path: cold + warm: chunks executed {executed}, "
          f"cuda_fallbacks {st['cuda_fallbacks']}, cuda_calls "
          f"{st['cuda_calls']}, plain calls {st['cuda_plain_calls']}, "
          f"{key} {launches}; max err {err:.3e} / {err2:.3e}", flush=True)
    if set(executed) != {"cuda"}:
        raise AssertionError(f"{name}: not every chunk ran on cuda: "
                             f"{executed}")
    if st["cuda_fallbacks"] != 0:
        raise AssertionError(f"{name}: {st['cuda_fallbacks']} cuda "
                             f"fallbacks")
    if not st["cuda_calls"] > 0 or st["cuda_plain_calls"] != 0:
        raise AssertionError(f"{name}: cuda_calls {st['cuda_calls']}, "
                             f"plain {st['cuda_plain_calls']}")
    if launches <= 0:
        raise AssertionError(f"the {name} path launched no {name} kernel")
    if not (np.isfinite(out).all() and err <= 1e-8 and err2 <= 1e-8):
        raise AssertionError(f"{name} path max err {err:.3e} / {err2:.3e}")
    return {"launches": launches, "wall_s": wall, "warm_s": warm,
            "max_abs_err": max(err, err2), "chunks_executed": executed}


def _attention_reference(Q, K, V):
    O = np.empty_like(Q)
    for i in range(0, len(Q), 2048):
        p = np.exp(Q[i:i + 2048] @ K.T)
        O[i:i + 2048] = (p @ V) / p.sum(axis=1, keepdims=True)
    return O


def _scan_reference(X):
    Y = np.empty_like(X)
    h = np.zeros(len(X))
    for t in range(X.shape[1]):
        h = SCAN_C * h + X[:, t]
        Y[:, t] = h
    return Y


def main_paths(rt, compile_kernel, obs, cost, kernels):
    """Phase 4: the three paths on one fleet."""
    for p in rt.profiles():
        print(f"worker {p.wid}: gpu {p.gpu_kind} f64 GEMM probe "
              f"{p.gpu_gflops:.1f} GFLOP/s, h2d {p.h2d_gbs:.2f} GB/s, "
              f"d2h {p.d2h_gbs:.2f} GB/s, host {p.gflops:.1f} GFLOP/s, "
              f"host copy {p.membw_gbs:.2f} GB/s", flush=True)
    pricing = _record_pricing(cost)
    rng = np.random.default_rng(SEED + 1)
    out = {}

    A = rng.normal(size=(N_ROWS, K_DIM))
    B = rng.normal(size=(K_DIM, M_DIM))
    out["matmul"] = run_path(
        rt, compile_kernel, obs, kernels["matmul"], pricing, name="matmul",
        fn=gemm_rowscale, twin="__cuk.matmul(",
        inputs=(A, B, np.zeros((N_ROWS, M_DIM)), N_ROWS, K_DIM, M_DIM),
        out_index=2, want=(2.0 * A) @ B, rows=N_ROWS)
    del A, B

    std = ATTN_D ** -0.25
    Q = std * rng.normal(size=(ATTN_N, ATTN_D))
    K = std * rng.normal(size=(ATTN_T, ATTN_D))
    V = rng.normal(size=(ATTN_T, ATTN_D))
    out["flash_attention"] = run_path(
        rt, compile_kernel, obs, kernels["flash_attention"], pricing,
        name="flash_attention", fn=attn_kernel,
        twin="__cuk.attention_rows(",
        inputs=(Q, K, V, np.zeros((ATTN_N, ATTN_D)), ATTN_N, ATTN_T,
                ATTN_D),
        out_index=3, want=_attention_reference(Q, K, V), rows=ATTN_N)
    del Q, K, V

    X = rng.normal(size=(SCAN_N, SCAN_L))
    out["mamba_scan"] = run_path(
        rt, compile_kernel, obs, kernels["mamba_scan"], pricing,
        name="mamba_scan", fn=scan_kernel, twin="__cuk.scan_rows(",
        inputs=(X, np.zeros((SCAN_N, SCAN_L)), SCAN_N, SCAN_L),
        out_index=1, want=_scan_reference(X), rows=SCAN_N)
    return out


def _summary(name, source, replaces, cases, path):
    """The kernel's entry of the ``{"kernels": [...]}`` line: the
    numbers of its main path's chunk case (the first), the worst error
    per dtype, every case, and its path's run."""
    chunk = cases[0]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": path["launches"],
        "max_abs_err": chunk["max_abs_err"], "ms": chunk["ms"],
        "plain_ms": chunk["plain_ms"], "bound_ms": chunk["bound_ms"],
        "bound_by": chunk["bound_by"], "library_ms": chunk["library_ms"],
        "shape": chunk["shape"], "dtype": chunk["dtype"],
        "dtypes": {c["dtype"]: max(d["max_abs_err"] for d in cases
                                   if d["dtype"] == c["dtype"])
                   for c in cases},
        "cases": cases, "main_path": path,
    }


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
    t_start = time.perf_counter()

    # 1. environment
    card = _nvidia_smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}; {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import obs
    from repro_torch.core import cost
    from repro_torch.core.compiler import compile_kernel
    from repro_torch.distrib import ClusterRuntime
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.mamba_scan import mamba_scan as sc
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_promoted_ref
    from repro_torch.kernels.matmul import matmul as mm
    from repro_torch.kernels.matmul.ref import matmul_ref

    if any(m == "jax" or m.startswith("jax.") or m == "repro"
           or m.startswith("repro.") for m in sys.modules):
        raise AssertionError("the port loaded jax or the JAX package")

    # 2. build, one nvcc per source, all started together
    kernels = {"matmul": mm, "flash_attention": fa, "mamba_scan": sc}
    sources = [k.SOURCE for k in kernels.values()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(kbuild.build, sources))
    for name, src, (lib, log, secs) in zip(kernels, sources, built):
        print(f"built {src.relative_to(ROOT)} -> "
              f"{lib.relative_to(ROOT)} in {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line \
                    or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
        if name in F64_DMMA:
            spills = f64_spills(log)
            print(f"  f64 kernels of {name}: {len(spills)}, spill bytes "
                  f"(stores, loads) {sorted(set(spills.values()))}",
                  flush=True)
            if not spills or any(v != (0, 0) for v in spills.values()):
                raise AssertionError(f"{name}: ptxas reports spills (or "
                                     f"no f64 kernel): {spills}")
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels against their plain versions
    cases = {"matmul": check_matmul(torch, mm, matmul_ref),
             "flash_attention": check_flash(torch, fa, fa_ops, fa_ref),
             "mamba_scan": check_scan(torch, sc,
                                            mamba_scan_promoted_ref)}
    for name, before in EARLIER_MS.items():
        chunk = cases[name][0]
        print(f"{name} chunk {chunk['dtype']} {chunk['shape']}: "
              f"{chunk['ms']:.3f} ms on the f64 tensor cores, "
              f"{before:.3f} ms before ({EARLIER})", flush=True)
    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # 4. the main paths
    t0 = time.perf_counter()
    # trace=True: worker run spans give the compute and idle phases.
    # Liveness is the runtime's default (1 s beats, 15 missed): no run
    # may count a fault (a respawn, an expired heartbeat).
    rt = ClusterRuntime(workers=WORKERS, device="cuda", trace=True)
    print(f"fleet: {WORKERS} workers up in "
          f"{time.perf_counter() - t0:.2f} s "
          f"(start method {rt.start_method})", flush=True)
    try:
        paths = main_paths(rt, compile_kernel, obs, cost, kernels)
    finally:
        rt.shutdown()

    # 5. summary
    base = "src/repro_torch/kernels"
    summary = [
        _summary("matmul", f"{base}/matmul/csrc/matmul.cu",
                 "src/repro/kernels/matmul/matmul.py:37", cases["matmul"],
                 paths["matmul"]),
        _summary("flash_attention",
                 f"{base}/flash_attention/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention/flash_attention.py:75",
                 cases["flash_attention"], paths["flash_attention"]),
        _summary("mamba_scan", f"{base}/mamba_scan/csrc/mamba_scan.cu",
                 "src/repro/kernels/mamba_scan/mamba_scan.py:55",
                 cases["mamba_scan"], paths["mamba_scan"]),
    ]
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
