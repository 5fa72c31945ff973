"""Time the selective scan's backward of this checkout against other
checkouts' on one GPU, interleaved (the others, this, this, the others in
reverse).

    PYTHONPATH=src python3 -m repro_torch.kernels.mamba_scan.bwd_ab \\
        [--cases LABEL,...] [OTHER_CHECKOUT ...]

Each checkout builds its own ``mamba_scan.cu`` and ``mamba_scan_bwd.cu``
with its own ``kernels/build.py`` (``kernels/ab_common.py``); this
process loads every library, runs each checkout's forward entry
(``mamba_scan_f32`` with its segments' entry states) and calls its
``mamba_scan_bwd_f32`` entry on the same inputs with those states.
Cases: the float32 cases of this checkout's ``chip_smoke.py``
(``SCAN_BWD_CASES``: a Jamba-1.5-Large Mamba layer as phase 11 trains it,
B = 1, L = 4096, I = 16384, N = 16; the same layer at phase 10's
shortest and longest served prompts; a ragged case, B = 2, L = 1000, I =
77, N = 4), inputs drawn as phase 3 draws them. It prints each
checkout's ptxas registers and spill bytes of ``scan_bwd_kernel``, one
JSON line per case and round (mean CUDA-event time over 10 launches
after a warm-up), each checkout's device time by kernel over one call
(``torch.profiler``: the scan kernel and its sums apart), each
checkout's largest difference from this checkout's gradients, this
checkout's norm error against the float64 plain backward (``ref.
mamba_scan_bwd_ref``), the bound (one exp per (b, t, i, n) on the SFU
against x, dt, dy, dx and ddt once in memory) and the card's name and
power limit. Nothing here runs at import time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

from ..ab_common import build, build_all, by_kernel, card, time_ms

_SOURCES = ["src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
            "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan_bwd.cu"]
SFU_EXP_S = 16 * 132 * 1.98e9
PEAK_BYTES_S = 3.35e12
REPS = 10


def _library(root: Path):
    """((forward library, backward library), ptxas lines of its float32
    scan_bwd_kernel) of the checkout at ``root``."""
    fwd_path, path = build(root, _SOURCES)
    fwd, lib = ctypes.CDLL(str(fwd_path)), ctypes.CDLL(str(path))
    fwd.mamba_scan_f32.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_int64] * 4 + [ctypes.c_void_p]
    fwd.mamba_scan_f32.restype = ctypes.c_int
    fwd.mamba_scan_scratch_bytes.argtypes = [ctypes.c_int64] * 5
    fwd.mamba_scan_scratch_bytes.restype = ctypes.c_int64
    fwd.mamba_scan_segments.argtypes = [ctypes.c_int64]
    fwd.mamba_scan_segments.restype = ctypes.c_int64
    lib.mamba_scan_bwd_f32.argtypes = [ctypes.c_void_p] * 16 + [
        ctypes.c_int64] * 4 + [ctypes.c_void_p]
    lib.mamba_scan_bwd_f32.restype = ctypes.c_int
    lib.mamba_scan_bwd_work_bytes.argtypes = [ctypes.c_int64] * 5
    lib.mamba_scan_bwd_work_bytes.restype = ctypes.c_int64
    log = path.with_suffix(".log")
    lines, fn = [], None
    for line in (log.read_text() if log.exists() else "").splitlines():
        if "Function properties for" in line:
            fn = line.split("for", 1)[1].strip()
        elif fn and "scan_bwd_kernelIf" in fn and (
                "spill" in line or "registers" in line):
            n = re.search(r"Li(\d+)E", fn).group(1)
            lines.append(f"N<={n}: {line.split(':', 1)[-1].strip()}")
    return (fwd, lib), lines


def _smoke(here: Path):
    """This checkout's ``chip_smoke.py`` as a module (its cases)."""
    sys.path.insert(0, str(here))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(here))
    return chip_smoke


def main(argv) -> int:
    import numpy as np
    import torch

    from .ref import mamba_scan_bwd_ref

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default=None,
                    help="comma-separated labels of the cases to run")
    ap.add_argument("others", nargs="*")
    args_ = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parents[4]
    cases = [(label, shape) for label, shape, dname, state
             in _smoke(here).SCAN_BWD_CASES if dname == "float32"
             and not state and (args_.cases is None
                                or label in args_.cases.split(","))]
    roots = [Path(a).resolve() for a in args_.others] + [here]
    libs = build_all(roots, _library)
    name = card()
    print(f"card: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    for r, (_, lines) in libs.items():
        print(json.dumps({"checkout": r, "ptxas": lines}), flush=True)
    rng = np.random.default_rng(9)
    for label, (b, length, inner, n) in cases:
        host = [rng.normal(size=(b, length, inner)),
                0.1 * np.abs(rng.normal(size=(b, length, inner))),
                rng.normal(size=(b, length, n)),
                rng.normal(size=(b, length, n)),
                np.log(np.abs(rng.normal(size=(inner, n))) + 0.5),
                rng.normal(size=(inner,)),
                rng.normal(size=(b, length, inner))]
        args = [torch.from_numpy(a).to("cuda", torch.float32).contiguous()
                for a in host]
        del host
        stream = torch.cuda.current_stream().cuda_stream
        states, work, grads = {}, {}, {}
        for r, ((fwd, lib), _) in libs.items():
            states[r] = torch.empty((b, fwd.mamba_scan_segments(length), n,
                                     inner), dtype=torch.float32,
                                    device="cuda")
            scratch = torch.empty(fwd.mamba_scan_scratch_bytes(
                b, length, inner, n, 4), dtype=torch.uint8, device="cuda")
            y = torch.empty_like(args[0])
            err = fwd.mamba_scan_f32(
                *(t.data_ptr() for t in args[:6]), y.data_ptr(), None,
                states[r].data_ptr(), scratch.data_ptr(), b, length, inner,
                n, stream)
            if err:
                raise RuntimeError(f"{r}: forward launch failed ({err})")
            work[r] = torch.empty(lib.mamba_scan_bwd_work_bytes(
                b, length, inner, n, 4), dtype=torch.uint8, device="cuda")
            grads[r] = tuple(torch.empty_like(t) for t in args[:6])
            del scratch, y

        def call(r):
            err = libs[r][0][1].mamba_scan_bwd_f32(
                *(t.data_ptr() for t in (*args, states[r])), None,
                *(g.data_ptr() for g in grads[r]), work[r].data_ptr(), b,
                length, inner, n, stream)
            if err:
                raise RuntimeError(f"launch failed ({err})")

        for r in libs:
            call(r)
        torch.cuda.synchronize()
        mine = grads[str(here)]
        diffs = {r: max(float((x.double() - y.double()).abs().max())
                        for x, y in zip(g, mine))
                 for r, g in grads.items()}
        want = mamba_scan_bwd_ref(*(t.double() for t in args))
        plain = [float((g.double() - w).norm() / w.norm())
                 for g, w in zip(mine, want)]
        del want
        steps = b * length * inner * n
        bound_ms = max(steps / SFU_EXP_S,
                       5 * b * length * inner * 4 / PEAK_BYTES_S) * 1e3
        order = list(libs) + list(reversed(libs))
        for rnd, r in enumerate(order):
            ms = time_ms(torch, lambda: call(r), REPS)
            print(json.dumps({"case": label, "shape": [b, length, inner, n],
                              "round": rnd, "checkout": r, "ms": ms}),
                  flush=True)
        for r in libs:
            print(json.dumps({"case": label, "checkout": r,
                              "kernels_ms": by_kernel(
                                  torch, lambda: call(r), 3)}), flush=True)
        print(json.dumps({"case": label, "bound_ms": bound_ms,
                          "max_diff_from_this": diffs,
                          "this_norm_err_vs_float64_plain": plain,
                          "card": name}), flush=True)
        del args, states, work, grads, mine
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
