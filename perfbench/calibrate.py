"""Readings that a cell's limits are set from, many seeds in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds a,b,c \
        [--control a,b] [--fault a,b] [--seconds s] [--settle]

For each seed of ``--seeds`` it prints, as one JSON line, the numbers
the cell's check compares, of the program against the reference. A
training cell runs set-up and its checked steps only (no window); a
serving cell runs a window of ``--seconds`` at the cell's own load.
For each seed of ``--control`` it also prints the control's readings:
the reference in fp8 put in the program's place (served: the gap of
the token fp8 puts first at each served position). For each seed of
``--fault`` (training) it prints the readings of the reference with
half of each batch left out, the mean taken over the rest. Beside each
set of readings, under ``judged``, is the cell's own verdict on it
(``check.judge`` against ``limits/<cell>.json``): true where it passes.

With ``--settle`` a serving cell runs with no warm ticks, and each
line also holds every tick from the loop's first: its host ms and the
TTFT of each request it admitted (the readings ``prewarm_ticks`` is set
from). The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def ints(text: str):
    return [int(x) for x in text.split(",") if x]


def control_readings(readings: dict) -> dict:
    """A served run's control readings: the gaps of the tokens fp8 puts
    first (``<name>.fp8``), with the program's other numbers (the
    control decodes the program's served tokens, so its lengths are
    theirs)."""
    out = {k: v for k, v in readings.items() if "." not in k}
    out.update({k[:-4]: v for k, v in readings.items()
                if k.endswith(".fp8")})
    return out


def judged(out: dict, limits: dict) -> dict:
    """The cell's verdict on each set of readings in ``out``."""
    from perfbench.harness.check import judge

    return {k: judge(out[k], limits)[0]
            for k in ("program", "control", "fault_half_batch") if k in out}


def train_readings(r, control: bool, fault: bool) -> dict:
    from perfbench.harness import device as dev_mod
    from perfbench.kinds import train

    t0 = time.perf_counter()
    p = train.setup(r)
    losses, grad1, change = p.losses, p.grad1, p.change
    del p
    dev_mod.free(r.torch, r.device)
    t1 = time.perf_counter()
    ref = train.reference_steps(r)
    out = {"program": train.compare_steps(losses, grad1, change, ref),
           "losses": losses, "ref_losses": ref["losses"],
           "program_s": t1 - t0, "reference_s": time.perf_counter() - t1}
    if control:
        c = train.reference_steps(r, "fp8")
        out["control"] = train.compare_steps(
            c["losses"], c["grad_clipped"], c["change"], ref)
    if fault:
        h = train.reference_steps(r, rows=r.traffic["batch"] // 2)
        out["fault_half_batch"] = train.compare_steps(
            h["losses"], h["grad_clipped"], h["change"], ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=ints, required=True)
    ap.add_argument("--control", type=ints, default=[])
    ap.add_argument("--fault", type=ints, default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--settle", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import run as run_mod
    from perfbench.harness import bench, device as dev_mod

    run_mod.cache_env(ROOT)
    cat = bench.Catalog()
    import torch

    if args.device == "cuda":
        print(f"device: {dev_mod.power_limit()}", flush=True)
    for seed in args.seeds:
        control = seed in args.control
        r = bench.Run(cat, args.workload, seed, args.seconds, False,
                      args.device, time.perf_counter(),
                      {"precisions": ("float32", "fp8") if control
                       else ("float32",)})
        t0 = time.perf_counter()
        if r.traffic["kind"] == "train":
            out = train_readings(r, control, seed in args.fault)
        else:
            if args.settle:
                r.traffic = dict(r.traffic, prewarm_ticks=0)
            res = cat.module("kinds", "serve").run(r)
            rd = res["readings"]
            out = {"program": {k: v for k, v in rd.items()
                               if not k.endswith(".fp8")},
                   "served": res["requests"], "e2e": res["e2e"]}
            if control:
                out["control"] = control_readings(rd)
            if args.settle:
                out["ticks"] = res["ticks"]
        out["judged"] = judged(out, r.limits["limits"])
        out.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        dev_mod.free(torch, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
