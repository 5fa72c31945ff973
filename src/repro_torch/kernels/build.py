"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with :mod:`ctypes` — no PyTorch headers, so a build
takes seconds. Libraries land in ``build/kernels/`` at the root of the
checkout, named by a hash of the source and the flags, so an edited
source never loads a stale library. A build runs under a file lock:
the cluster head builds before any worker starts, and a process that
finds the library already built only loads it.

Nothing here runs at import time; the CPU tests import every module on
a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Tuple

# src/repro_torch/kernels/build.py → the checkout's root
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{h}.so"


def build(src: Path) -> Tuple[Path, str, float]:
    """Compile ``src`` unless its library exists. Returns (library path,
    nvcc's output, seconds spent compiling — 0 when it was built
    already). Raises with nvcc's output when the compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _target(src)
    log = lib.with_suffix(".log")
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib, log.read_text() if log.exists() else "", 0.0
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)],
                              capture_output=True, text=True)
        secs = time.perf_counter() - t0
        out = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        log.write_text(out)
        os.replace(tmp, lib)
        return lib, out, secs


def load(src: Path) -> ctypes.CDLL:
    """Load the library of ``src``, building it first if needed (each
    kernel's wrapper keeps the handle)."""
    return ctypes.CDLL(str(build(src)[0]))
