"""Serving driver: batched continuous-batching engine over a model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_2b \
        [--smoke] [--requests 8] [--max-tokens 12] [--device cuda]

The reference's ``repro/launch/serve.py`` on the port: initializes a
model from seed 0 (a ``torch.Generator`` on the device; nothing is
downloaded), spins up the ServeEngine (fixed-slot KV cache, per-slot
positions, greedy decode), feeds a synthetic request stream with
staggered arrivals, and reports latency/throughput stats. It serves on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine, serving_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--max-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    # checked before a weight is drawn: no card raises DeviceUnavailable
    eng_device = serving_device(args.device)
    gen = torch.Generator(device=eng_device).manual_seed(0)
    params, _ = T.init_params(cfg, gen)
    eng = ServeEngine(params, cfg, n_slots=args.slots,
                      max_seq=args.max_seq, device=eng_device)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        plen = int(rng.integers(4, 16))
        eng.add_request(Request(
            f"req-{i}", rng.integers(0, cfg.vocab, plen),
            max_tokens=args.max_tokens))
        eng.step()  # staggered arrivals exercise continuous batching
    done = eng.run_until_done()
    wall = time.perf_counter() - t0

    gen_tokens = sum(len(r.generated) for r in done)
    ttfts = [r.first_token_s - r.submitted_s for r in done]
    lats = [r.finished_s - r.submitted_s for r in done]
    stats = {
        "requests": len(done),
        "tokens_generated": gen_tokens,
        "throughput_tok_s": gen_tokens / wall,
        "ttft_p50_s": float(np.median(ttfts)),
        "latency_p50_s": float(np.median(lats)),
        "device": str(eng_device),
    }
    print(f"[serve] {cfg.name}: {stats}")
    return stats


if __name__ == "__main__":
    main()
