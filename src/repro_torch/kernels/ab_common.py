"""What the A/B timing scripts share (``kernels/ab.py`` and the
``bwd_ab.py`` / ``fwd_ab.py`` beside the kernels): each checkout's own
build of its kernel sources, CUDA-event timing, device time by kernel
from ``torch.profiler`` and the card's name and power limit. Nothing here
runs at import time.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_BUILD = ("import json, sys; from pathlib import Path; "
          "from repro_torch.kernels import build; "
          "print(json.dumps([str(build.build(Path(s))[0]) "
          "for s in sys.argv[1:]]))")


def build(root: Path, sources) -> list:
    """Paths of the libraries of ``sources`` (relative to ``root``),
    built by the checkout at ``root`` with its own ``kernels/build.py``
    into its own ``build/kernels/``, in a subprocess so that its headers
    are its own."""
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    out = subprocess.run([sys.executable, "-c", _BUILD,
                          *(str(root / s) for s in sources)],
                         cwd=root, env=env, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"build in {root} failed:\n{out.stderr}")
    return [Path(p) for p in json.loads(out.stdout.splitlines()[-1])]


def build_all(roots, load) -> dict:
    """{str(root): load(root)} for every checkout, their builds run at
    once (one nvcc each)."""
    with ThreadPoolExecutor(len(roots)) as pool:
        return dict(zip(map(str, roots), pool.map(load, roots)))


def time_ms(torch, fn, reps: int = 20) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` launches, after 3
    calls of warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def by_kernel(torch, fn, calls: int = 1) -> dict:
    """{kernel name: device ms a call} over ``calls`` calls of ``fn``
    (torch.profiler)."""
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            found = re.search(r"(\w+_kernel)\b", e.name)
            name = found.group(1) if found else e.name[:60]
            times[name] = times.get(name, 0.0) \
                + e.device_time_total / 1e3 / calls
    return times


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
