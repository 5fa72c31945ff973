"""Time the bf16 flash-attention backward of this checkout against other
checkouts' on one GPU, interleaved (the others, this, this, the others in
reverse), beside ``torch.autograd.grad`` through
``scaled_dot_product_attention`` (the library call; the port never calls
it).

    PYTHONPATH=src python3 -m repro_torch.kernels.flash_attention.bwd_ab \\
        [--cases NAME,NAME] [OTHER_CHECKOUT ...]

Each checkout builds its own ``flash_attention.cu`` and
``flash_attention_bwd.cu`` with its own ``kernels/build.py``
(``kernels/ab_common.py``);
this process loads every library and calls its C entries on the same
inputs: this checkout's forward gives o and lse once, then each
checkout's ``flash_attention_bwd_bf16`` computes (dq, dk, dv). Cases
(``--cases`` picks some by label): a stablelm_3b layer as training runs
it (64 batch-heads, S = 4096, D = 80, causal), seamless_m4t_medium's
encoder and cross attention (32, S = 4096, D = 64, not causal) and
gemma2_2b's layer (D = 288, window 4096, softcap 50) as training runs it
(8 batch-heads, S = 4096) and at S = 8192, inputs drawn as
``chip_smoke.py`` phase 3 draws them (q at standard deviation 3, every
4th row at 40; k, v, dO N(0, 1)). It prints one JSON line per case and
round (mean CUDA-event time over 10 launches after a warm-up), each
checkout's device time by kernel over one call (``torch.profiler``),
each checkout's largest difference from this checkout's gradients and,
on the first 4 batch-heads, this checkout's largest difference and norm
error against the plain backward (``ref.flash_attention_bhsd_bwd_ref``),
the library's time where SDPA computes the case (no window, no
softcap), the bound (five products of 2 D operations a valid pair at
989 TFLOP/s) and the card's name and power limit. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

from ..ab_common import build, build_all, by_kernel, card, time_ms

_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu"
# (label, (BH, Sq, Skv, D), causal, window, softcap)
CASES = [("stablelm", (64, 4096, 4096, 80), True, 0, 0.0),
         ("seamless_enc_cross", (32, 4096, 4096, 64), False, 0, 0.0),
         ("gemma2_train", (8, 4096, 4096, 288), True, 4096, 50.0),
         ("gemma2_local", (8, 8192, 8192, 288), True, 4096, 50.0)]
PEAK_BF16 = 989e12
REPS = 10


def _library(root: Path) -> ctypes.CDLL:
    """The backward's library of the checkout at ``root``."""
    lib = ctypes.CDLL(str(build(root, [_SOURCE])[0]))
    fn = lib.flash_attention_bwd_bf16
    # entries of ABI 2 take q_offset (passed null) after lse
    fn.argtypes = [ctypes.c_void_p] * (10 + _with_offset(lib)) + [
        ctypes.c_int64] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _inputs(torch, rng, bh, sq, skv, d):
    import numpy as np
    pushed = np.arange(sq) % 4 == 0
    std = np.where(pushed, 40.0, 3.0)[None, :, None]
    q = std * rng.normal(size=(bh, sq, d))
    k, v = (rng.normal(size=(bh, skv, d)) for _ in range(2))
    do = rng.normal(size=(bh, sq, d))
    return tuple(torch.from_numpy(t).to("cuda", torch.bfloat16).contiguous()
                 for t in (q, k, v, do))


def _pairs(sq, skv, causal, window) -> int:
    """Valid (query, key) pairs of one batch-head."""
    import numpy as np
    i = np.arange(sq)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    hi = np.minimum(skv - 1, i) if causal else np.full_like(i, skv - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def _with_offset(lib) -> bool:
    """Whether ``lib``'s entries take q_offset (and a Δ scratch of BH x
    (Sq + D))."""
    return hasattr(lib, "flash_attention_bwd_abi") \
        and lib.flash_attention_bwd_abi() >= 2


def main(argv) -> int:
    import numpy as np
    import torch

    from . import flash_attention as fa
    from .ref import flash_attention_bhsd_bwd_ref

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    only = None
    if argv[:1] == ["--cases"]:
        only, argv = set(argv[1].split(",")), argv[2:]
    here = Path(__file__).resolve().parents[4]
    roots = [Path(a).resolve() for a in argv] + [here]
    libs = build_all(roots, _library)
    name = card()
    print(f"card: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(5)
    for label, (bh, sq, skv, d), causal, window, cap in CASES:
        if only is not None and label not in only:
            continue
        q, k, v, do = _inputs(torch, rng, bh, sq, skv, d)
        opts = dict(causal=causal, window=window, softcap=cap)
        o, lse = fa.flash_attention_bhsd(q, k, v, return_lse=True, **opts)
        delta = torch.empty((bh, sq + d), dtype=lse.dtype, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call(lib, out):
            err = lib.flash_attention_bwd_bf16(
                *(t.data_ptr() for t in (q, k, v, o, do, lse)),
                *((None,) if _with_offset(lib) else ()),
                *(t.data_ptr() for t in (delta, *out)),
                bh, sq, skv, d, int(causal), window, cap, stream)
            if err:
                raise RuntimeError(f"launch failed ({err})")

        grads = {r: tuple(torch.empty_like(t) for t in (q, k, v))
                 for r in libs}
        for r, lib in libs.items():
            call(lib, grads[r])
        torch.cuda.synchronize()
        mine = grads[str(here)]
        diffs = {r: max(float((a.double() - b.double()).abs().max())
                        for a, b in zip(g, mine))
                 for r, g in grads.items()}
        n = min(4, bh)
        want = flash_attention_bhsd_bwd_ref(q[:n], k[:n], v[:n], o[:n],
                                            do[:n], lse[:n], **opts)
        plain = {name: [float((g[:n].double() - w.double()).abs().max()),
                        float((g[:n].double() - w.double()).norm()
                              / w.double().norm())]
                 for name, g, w in zip(("dq", "dk", "dv"), mine, want)}
        # one head per batch row of the (BH, S, D) layout, as chip_smoke.py;
        # SDPA has no window and no softcap
        library = None
        if not window and not cap:
            qs, ks, vs = (t.detach()[None].requires_grad_(True)
                          for t in (q, k, v))
            out = sdpa(qs, ks, vs, is_causal=causal)

            def library():
                torch.autograd.grad(out, (qs, ks, vs), do[None],
                                    retain_graph=True)

        pairs = bh * _pairs(sq, skv, causal, window)
        bound_ms = 10.0 * pairs * d / PEAK_BF16 * 1e3
        order = list(libs) + list(reversed(libs))
        for rnd, r in enumerate(order):
            ms = time_ms(torch, lambda: call(libs[r], grads[r]), REPS)
            print(json.dumps({"case": label, "shape": [bh, sq, skv, d],
                              "causal": causal, "window": window,
                              "softcap": cap, "round": rnd,
                              "checkout": r, "ms": ms}), flush=True)
        for r in libs:
            print(json.dumps({"case": label, "checkout": r,
                              "kernels_ms": by_kernel(
                                  torch, lambda: call(libs[r], grads[r]))}),
                  flush=True)
        lib_ms = time_ms(torch, library, REPS) if library else None
        print(json.dumps({"case": label, "library_ms": lib_ms,
                          "bound_ms": bound_ms,
                          "max_diff_from_this": diffs,
                          "this_vs_plain_first_heads": plain,
                          "card": name}), flush=True)
        del q, k, v, do, o, lse, delta, grads, mine, want, library
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
