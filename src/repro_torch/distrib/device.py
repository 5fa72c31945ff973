"""Per-worker device profiles: measured capability, not configured.

Every worker process measures its own hardware at startup — a small
matmul for FLOP rate, a copy sweep for memory bandwidth, ``os`` probes
for core count and memory — and reports the profile in its hello
message. The head adds a measured transport bandwidth (payload ping over
the worker's pipe). The placement scheduler and the local-vs-distributed
profitability test in :mod:`repro_torch.core.cost` consume these numbers; on a
heterogeneous fleet the pfor sharder sizes chunks proportional to
``gflops``.

The GPU probe runs when the worker's device is ``cuda`` (the cluster's
default): it measures a float64 GEMM rate and pinned host↔device
bandwidth with ``torch.cuda``. A worker on ``device="cpu"`` reports no
GPU.

For laptops/CI, ``REPRO_DISTRIB_SIM_GPU`` makes CPU workers *pose* as
GPU workers so heterogeneous routing is exercisable anywhere:
``all``/``*`` marks every worker, a comma-separated wid list (e.g.
``1`` or ``0,2``) marks just those. A simulated GPU reports
``has_gpu=True``, ``gpu_kind="sim"`` and ``gpu_gflops = gflops ×
REPRO_DISTRIB_SIM_GPU_FACTOR`` (default 4) — routing and chunk sizing
behave exactly as with real hardware, the cuda twins just run the
kernels' plain torch versions on the CPU.
"""

from __future__ import annotations

import os
import socket
import time
from dataclasses import asdict, dataclass
from typing import Any, Dict

import numpy as np


@dataclass
class DeviceProfile:
    wid: int
    host: str = ""
    pid: int = 0
    cpus: int = 1
    mem_bytes: int = 0
    gflops: float = 1.0            # measured matmul rate
    membw_gbs: float = 1.0         # measured copy bandwidth
    has_gpu: bool = False
    gpu_kind: str = ""             # "cuda" / "tpu" / "sim" / ""
    gpu_gflops: float = 0.0        # measured (or simulated) device rate
    transport_mbs: float = 0.0     # filled by the head's payload ping
    h2d_gbs: float = 0.0           # measured host→device staging bandwidth
    d2h_gbs: float = 0.0           # measured device→host gather bandwidth
    gpu_probe_error: str = ""      # why the GPU probe failed (if it did)

    def as_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "DeviceProfile":
        return DeviceProfile(**d)


def _probe_mem_bytes() -> int:
    try:
        return (os.sysconf("SC_PAGE_SIZE")
                * os.sysconf("SC_PHYS_PAGES"))
    except (ValueError, OSError, AttributeError):
        return 0


def _probe_gpu(device: str) -> tuple:
    """(has_gpu, kind, gpu_gflops, h2d_gbs, d2h_gbs, error) — measured
    on the worker's CUDA device; a CPU worker reports no GPU.

    The timing product is float64, like the chunk bodies this rate
    prices (PolyBench semantics): an f32 probe would read far too
    optimistic against them. ``torch.matmul`` is the probe's yardstick
    only, never the kernel a chunk runs. Probe failures are returned as
    a reason string — the head counts it in the faults scope, and on a
    CUDA fleet fails the worker's hello instead of using it as a CPU."""
    if device == "cpu":
        return False, "", 0.0, 0.0, 0.0, ""
    try:
        import torch

        dev = torch.device(device)
        n = 2048
        a = torch.ones((n, n), dtype=torch.float64, device=dev)
        torch.matmul(a, a)                      # warm the library
        torch.cuda.synchronize(dev)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            torch.matmul(a, a)
            torch.cuda.synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        gflops = 2.0 * n ** 3 / max(1e-9, best) / 1e9

        # staging bandwidth, both directions, from pinned host memory —
        # what the chunk pricing in core.cost spends per chunk (64 MB,
        # a bulk transfer like a chunk's operands)
        host = torch.ones(1 << 23, dtype=torch.float64).pin_memory()
        on_dev = host.to(dev)
        back = torch.empty_like(host).pin_memory()
        torch.cuda.synchronize(dev)
        h2d = d2h = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            on_dev.copy_(host, non_blocking=True)
            torch.cuda.synchronize(dev)
            h2d = min(h2d, time.perf_counter() - t0)
            t0 = time.perf_counter()
            back.copy_(on_dev, non_blocking=True)
            torch.cuda.synchronize(dev)
            d2h = min(d2h, time.perf_counter() - t0)
        nbytes = host.numel() * host.element_size()
        return (True, "cuda", round(gflops, 3),
                round(nbytes / max(1e-9, h2d) / 1e9, 3),
                round(nbytes / max(1e-9, d2h) / 1e9, 3), "")
    except Exception as exc:
        return False, "", 0.0, 0.0, 0.0, f"{type(exc).__name__}: {exc}"


def sim_gpu_for(wid: int) -> bool:
    """Does ``REPRO_DISTRIB_SIM_GPU`` mark this wid as a posing GPU?"""
    env = os.environ.get("REPRO_DISTRIB_SIM_GPU", "").strip()
    if not env:
        return False
    if env in ("all", "*"):
        return wid >= 0
    try:
        return wid in {int(x) for x in env.split(",") if x.strip()}
    except ValueError:
        return False


def measure_profile(wid: int, n: int = 128,
                    sim_gpu: bool = None, *,
                    device: str) -> DeviceProfile:
    """Micro-benchmark this process. ``n`` keeps the host probe
    ~milliseconds. ``sim_gpu`` forces the simulated-GPU pose (None =
    consult the ``REPRO_DISTRIB_SIM_GPU`` env var); ``device`` is the
    caller's device (no default), probed when it is a CUDA device."""
    rng = np.random.default_rng(wid + 1)
    a = rng.normal(size=(n, n))
    b = rng.normal(size=(n, n))
    a @ b  # warm the BLAS path
    reps = 5
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        a @ b
        best = min(best, time.perf_counter() - t0)
    # best-of-N: scheduler noise only ever *slows* a rep, so the fastest
    # one is the honest capability number on a shared host
    gflops = 2.0 * n ** 3 / max(1e-9, best) / 1e9

    buf = rng.normal(size=1 << 20)          # 8 MB
    buf.copy()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        buf.copy()
        best = min(best, time.perf_counter() - t0)
    membw_gbs = 2.0 * buf.nbytes / max(1e-9, best) / 1e9  # read + write

    (has_gpu, gpu_kind, gpu_gflops,
     h2d_gbs, d2h_gbs, gpu_probe_error) = _probe_gpu(device)
    if sim_gpu is None:
        sim_gpu = sim_gpu_for(wid)
    if sim_gpu and not has_gpu:
        # a CPU worker posing as a GPU (laptops/CI): capability tags
        # and the pricing table see a device ``factor``× faster than the
        # host np rate; execution stays on the CPU
        factor = float(os.environ.get("REPRO_DISTRIB_SIM_GPU_FACTOR",
                                      "4"))
        has_gpu, gpu_kind = True, "sim"
        gpu_gflops = round(gflops * max(0.1, factor), 3)
    return DeviceProfile(
        wid=wid,
        host=socket.gethostname(),
        pid=os.getpid(),
        cpus=os.cpu_count() or 1,
        mem_bytes=_probe_mem_bytes(),
        gflops=round(gflops, 3),
        membw_gbs=round(membw_gbs, 3),
        has_gpu=has_gpu,
        gpu_kind=gpu_kind,
        gpu_gflops=gpu_gflops,
        h2d_gbs=h2d_gbs,
        d2h_gbs=d2h_gbs,
        gpu_probe_error=gpu_probe_error,
    )
