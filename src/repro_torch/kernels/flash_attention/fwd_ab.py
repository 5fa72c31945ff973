"""Time the bf16 flash-attention forward of this checkout against other
checkouts' on one GPU, interleaved (the others, this, this, the others in
reverse), beside ``scaled_dot_product_attention`` where it computes the
same function (no softcap; the port never calls it).

    PYTHONPATH=src python3 -m repro_torch.kernels.flash_attention.fwd_ab \\
        [--cases NAME,NAME] [OTHER_CHECKOUT ...]

Each checkout builds its own ``flash_attention.cu`` with its own
``kernels/build.py`` (``kernels/ab_common.py``); this process loads every
library and calls its C entries on the same inputs: a library with the
grouped-query entry (``flash_attention_gqa_bf16``) gets the (B, S, H, D)
operands as they are and the workspace it asks for; one without it (a
checkout before the entry) the regroup ``ops.regroup`` makes (K/V
repeated over the groups, timed with the call, as that checkout's
dispatch ran it) and its bhsd entry (a bhsd-layout case, H = 1, takes
every checkout's bhsd entry). The cases are this checkout's
``chip_smoke.py`` phase 3 bf16 forward cases (``FLASH_CASES``), drawn as
it draws them (``_flash_inputs``). It prints one JSON line per case and
round (mean CUDA-event time over the launches after a warm-up), each
checkout's device time by kernel a call (``torch.profiler``), each
checkout's largest difference from this checkout's output and this
checkout's against the plain version (``ref.attention_ref`` on the first
batch row), the library time, the bound (``chip_smoke.py``'s: 4 D
operations a valid (query, key) pair at the bf16 peak, or the bytes of q,
o and the keys walked at the memory rate) and the card's name and power
limit. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

from ..ab_common import build, build_all, by_kernel, card, time_ms

_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"


def _library(root: Path) -> ctypes.CDLL:
    """The forward's library of the checkout at ``root``, its bf16
    entries declared."""
    lib = ctypes.CDLL(str(build(root, [_SOURCE])[0]))
    lib.flash_attention_bf16.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_double,
                               ctypes.c_void_p]
    lib.flash_attention_bf16.restype = ctypes.c_int
    if hasattr(lib, "flash_attention_gqa_bf16"):
        fn = lib.flash_attention_gqa_bf16
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 6 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_gqa_workspace.argtypes = [ctypes.c_int64] * 6
        lib.flash_attention_gqa_workspace.restype = ctypes.c_int64
    return lib


def _smoke(here: Path):
    """This checkout's ``chip_smoke.py`` as a module (its cases, inputs
    and bounds)."""
    sys.path.insert(0, str(here))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(here))
    return chip_smoke


def main(argv) -> int:
    import numpy as np
    import torch

    from .ops import regroup
    from .ref import attention_ref

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    only = None
    if argv[:1] == ["--cases"]:
        only, argv = set(argv[1].split(",")), argv[2:]
    here = Path(__file__).resolve().parents[4]
    smoke = _smoke(here)
    roots = [Path(a).resolve() for a in argv] + [here]
    libs = build_all(roots, _library)
    name = card()
    print(f"card: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(2)
    for label, (b, sq, h, kvh, skv, d), causal, window, cap, dname, offs \
            in smoke.FLASH_CASES:
        if dname != "bfloat16" or (only is not None and label not in only):
            continue
        q, k, v = (torch.from_numpy(t).to("cuda", torch.bfloat16)
                   for t in smoke._flash_inputs(rng, b, sq, h, kvh, skv, d))
        off = None if offs is None else torch.tensor(
            offs, dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        opts = (int(causal), int(window), float(cap))

        def call(lib, out):
            if h == 1:          # the bhsd layout: each checkout's bhsd entry
                err = lib.flash_attention_bf16(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None, None, b, sq, skv, d, *opts, stream)
            elif hasattr(lib, "flash_attention_gqa_bf16"):
                n = lib.flash_attention_gqa_workspace(b, sq, skv, h, kvh, d)
                ws = torch.empty(n, dtype=torch.float32, device="cuda") \
                    if n else None
                st = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                           *v.stride()[:3],
                                           *out.stride()[:3])
                err = lib.flash_attention_gqa_bf16(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None, None if off is None else off.data_ptr(),
                    None if ws is None else ws.data_ptr(), b, sq, skv, h,
                    kvh, d, st, *opts, stream)
            else:
                qf, kf, vf, of = regroup(q, k, v, 0 if off is None else off)
                o = torch.empty_like(qf)
                err = lib.flash_attention_bf16(
                    qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), o.data_ptr(),
                    None, None if of is None else of.data_ptr(), b * h, sq,
                    skv, d, *opts, stream)
                out.copy_(o.reshape(b, h, sq, d).transpose(1, 2))
            if err:
                raise RuntimeError(f"launch failed ({err})")

        outs = {r: torch.empty_like(q) for r in libs}
        for r, lib in libs.items():
            call(lib, outs[r])
        torch.cuda.synchronize()
        mine = outs[str(here)]
        diffs = {r: float((o.double() - mine.double()).abs().max())
                 for r, o in outs.items()}
        rows = min(sq, 1024)
        want = attention_ref(q[:1, :rows], k[:1], v[:1], causal=causal,
                             window=window, softcap=cap,
                             q_offset=0 if off is None else off[:1])
        plain = float((mine[:1, :rows].double() - want.double()).abs().max())
        work = [smoke.attention_work(sq, skv, causal, window,
                                     0 if offs is None else offs[i])
                for i in range(b)]
        ops_ = 4.0 * h * sum(p for p, _ in work) * d
        nbytes = (2 * b * sq * h * d + 2 * sum(n for _, n in work) * kvh
                  * d) * 2
        bound_ms = max(ops_ / smoke.PEAK_FLOPS[dname],
                       nbytes / smoke.PEAK_BYTES_S) * 1e3
        reps = max(3, min(200, int(200 / max(1, sq // 64))))
        order = list(libs) + list(reversed(libs))
        for rnd, r in enumerate(order):
            ms = time_ms(torch, lambda: call(libs[r], outs[r]), reps)
            print(json.dumps({"case": label, "shape": [b, sq, h, kvh, skv, d],
                              "round": rnd, "checkout": r, "ms": ms}),
                  flush=True)
        for r in libs:
            print(json.dumps({"case": label, "checkout": r,
                              "kernels_ms": by_kernel(
                                  torch, lambda: call(libs[r], outs[r]),
                                  3)}), flush=True)
        lib_ms = None
        if not cap and h == 1:
            lib_ms = time_ms(torch, lambda: sdpa(
                q[None, :, :, 0], k[None, :, :, 0], v[None, :, :, 0],
                is_causal=causal), reps)
        elif not cap:
            lib_ms = time_ms(torch, smoke._sdpa_gqa_library(
                torch, sdpa, q, k, v, causal, window,
                torch.zeros(b, dtype=torch.int32, device="cuda")
                if off is None else off), reps)
        print(json.dumps({"case": label, "library_ms": lib_ms,
                          "bound_ms": bound_ms,
                          "max_diff_from_this": diffs,
                          "this_vs_plain_first_rows": plain,
                          "card": name}), flush=True)
        del q, k, v, outs, mine, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
