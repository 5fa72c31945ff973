"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Earlier lines name the card and its power limit, the peak memory and
the kernels' launch and plain-call counts; the last lines of standard
error give each number the check compared beside its limit; the last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace
0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``. A run exits non-zero
and prints no result where no card is seen, where the card count is
below the cell's, or where JAX or the JAX package was loaded.

Every cache of the program lies inside the checkout: the kernels'
libraries in ``build/kernels/`` (the program's own choice) and, set
here, Triton's, the PyTorch extensions' and CUDA's JIT caches under
``build/``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def cache_env(root: Path) -> None:
    build = root / "build"
    os.environ.update({
        "TRITON_CACHE_DIR": str(build / "triton"),
        "TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
        "CUDA_CACHE_PATH": str(build / "cuda_cache"),
        # keep libraries that could load JAX by themselves from it
        "USE_FLAX": "0", "USE_JAX": "0", "USE_TF": "0",
    })


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(r, out: dict) -> dict:
    """The result's JSON object from a kind's outcome."""
    from perfbench.harness import device as dev_mod

    cat = r.catalog
    metrics = {}
    if r.trace:
        obs = dict(out["obs"], run=r)
        for m in cat.per_layer(r.name):
            value = cat.module("metrics", m["name"]).read(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cat.end_to_end(r.name):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    device = dev_mod.describe(r.torch, r.device, r.workload["chips"])
    device["memory_peak_bytes"] = out["peak"]
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if r.trace and out.get("trace"):
        tr = out["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = out["checks"]
    return line


def main(argv=None, device: str = "cuda", options: dict = None,
         root: Path = ROOT) -> int:
    args = parse(argv)
    cache_env(root)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from perfbench.harness import bench, check, device as dev_mod

    cat = bench.Catalog(root, root / "perfbench")
    w = cat.workload(args.workload)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < w["chips"]):
        print(f"no result: {w['name']} needs {w['chips']} CUDA device(s), "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    r = bench.Run(cat, args.workload, args.seed, args.seconds,
                  bool(args.trace), device, T0, options)
    if device == "cuda":
        r.log(f"device: {dev_mod.power_limit()}; torch {torch.__version__}"
              f", CUDA {torch.version.cuda}")
    out = cat.module("kinds", r.traffic["kind"]).run(r)
    loaded = bench.forbidden_modules()
    if loaded:
        print(f"no result: the run loaded {loaded}", file=sys.stderr)
        return 3
    r.log(f"memory peak: {out['peak']} B; counters: "
          f"{json.dumps(out['counters'])}")
    if "requests" in out:
        r.log(f"requests: {json.dumps(out['requests'])}")
    line = result_line(r, out)
    print(check.lines(out["checks"]), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
