"""Time one large object's trip between the cluster head and a worker.

    PYTHONPATH=src python -m repro_torch.serve.transfer_rate \\
        [--gb 1,5] [--device cpu]

The object is what :class:`repro_torch.serve.ClusterLMEngine` moves at
a boot and at each anchor: a :class:`repro_torch.serve.remote_lm.Resident`
holding one bf16 tensor of the given size (decimal GB), drawn from a
seed on the head's device and shipped as its 16-bit pattern. Push is
``rt.submit(remote_lm.lm_anchor, resident)`` until the worker holds it
(the head's copy to the host, pickling, the pipe and the worker's
unpickling); pull is ``rt.get`` of that worker-resident object (the
worker's pickling, the pipe and the head's unpickling). Each trip's
seconds and MB/s are printed, with the card's name and power limit on a
2-worker CUDA fleet (the default; ``--device cpu`` runs a CPU fleet).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch.distrib import ClusterRuntime

from . import remote_lm


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


WORKERS = 2


def trips(rt, nbytes: int, device: str) -> dict:
    """One push and one pull of a Resident holding ``nbytes`` of bf16."""
    gen = torch.Generator(device=device).manual_seed(0)
    w = torch.randn(nbytes // 2, generator=gen, device=device,
                    dtype=torch.float32).to(torch.bfloat16)
    res = remote_lm.Resident({"w": w})
    if device != "cpu":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    ref = rt.submit(remote_lm.lm_anchor, res)
    ready, _ = rt.wait([ref], timeout=600.0)
    push = time.perf_counter() - t0
    if not ready:
        raise TimeoutError(f"push of {nbytes} bytes not done in 600 s")
    del res, w
    t0 = time.perf_counter()
    back = rt.get(ref, timeout=600.0)
    pull = time.perf_counter() - t0
    if back.nbytes != nbytes:
        raise AssertionError(f"pulled {back.nbytes} bytes of {nbytes}")
    rt.release(ref)
    return {"bytes": nbytes, "push_s": push, "pull_s": pull,
            "push_MB_s": nbytes / push / 1e6,
            "pull_MB_s": nbytes / pull / 1e6}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gb", default="1,5",
                    help="comma-separated object sizes in decimal GB")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    card = _card() if args.device == "cuda" else "cpu"
    t0 = time.perf_counter()
    rt = ClusterRuntime(workers=WORKERS, device=args.device,
                        start_method="spawn")
    print(f"fleet of {WORKERS} up in {time.perf_counter() - t0:.3f} s",
          flush=True)
    rows = []
    try:
        for gb in (float(g) for g in args.gb.split(",")):
            row = trips(rt, int(gb * 1e9), args.device)
            rows.append(row)
            print(f"{gb:g} GB: push {row['push_s']:.3f} s "
                  f"({row['push_MB_s']:.1f} MB/s), pull {row['pull_s']:.3f} "
                  f"s ({row['pull_MB_s']:.1f} MB/s); {WORKERS}-worker "
                  f"{args.device} fleet; {card}", flush=True)
    finally:
        rt.shutdown()
    print(json.dumps({"transfer_rate": rows, "card": card}), flush=True)
    return rows


if __name__ == "__main__":
    main()
