"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with :mod:`ctypes` — no PyTorch headers, so a build
takes seconds. A source may include the headers of the shared
``kernels/csrc/`` (the float64 tensor-core and ``cp.async`` helpers) and
of its own ``csrc/``; both are on the include path. Libraries land in
``build/kernels/`` at the root of the checkout, named by a hash of the
source, every header it may include and the flags, so an edited source
or header never loads a stale library. A build runs under a file lock
of its own library: the cluster head builds before any worker starts,
a process that finds the library already built only loads it, and
different sources compile at once.

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
# headers (``*.cuh``) shared by every kernel's source
SHARED_INCLUDE = Path(__file__).resolve().parent / "csrc"

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


def _include_dirs(src: Path) -> Tuple[Path, ...]:
    return (src.parent, SHARED_INCLUDE)


def _target(src: Path) -> Path:
    """The library's path, named by a hash of the source, of every header
    in its include directories (by name and content) and of the flags."""
    h = hashlib.sha256(src.read_bytes())
    for inc in _include_dirs(src):
        for hdr in sorted(inc.iterdir()) if inc.is_dir() else ():
            if hdr.suffix == ".cuh":
                h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(src: Path) -> Tuple[Path, str, float]:
    """Compile ``src`` unless its library exists. Returns (library path,
    nvcc's output, seconds spent compiling — 0 when it was built
    already). Raises with nvcc's output when the compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _target(src)
    log = lib.with_suffix(".log")
    with open(lib.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib, log.read_text() if log.exists() else "", 0.0
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        t0 = time.perf_counter()
        includes = [f"-I{inc}" for inc in _include_dirs(src)]
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *includes, "-o",
                               str(tmp), str(src)],
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
