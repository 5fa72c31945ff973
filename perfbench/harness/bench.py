"""A cell's files, found by the names in ``BENCHMARK.json``.

Nothing here knows a cell: a workload names its configuration and its
traffic mix; the mix's ``kind`` names the runner ``kinds/<kind>.py``; a
per-layer metric's name is its reader ``metrics/<name>.py``; a count is
``counts/<name>.py``, a reference ``reference/<family>.py`` and a
cell's limits ``limits/<cell>.json``. A later cell, mix or metric is a
new file and edits none.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

#: top-level module names that no run may load: JAX, its libraries and
#: the JAX package (``repro``; the port, ``repro_torch``, only begins
#: with that name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    """The forbidden top-level names in ``sys.modules``, each compared
    whole (the part before the first dot)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


class Catalog:
    """``BENCHMARK.json`` at ``root`` and the files of the benchmark's
    folder ``bench_dir``."""

    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.spec = load_json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return load_json(self.dir / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> Dict:
        return load_json(self.dir / "limits" / f"{workload}.json")

    def _metrics(self, group: str, workload: str) -> List[Dict]:
        return [m for m in self.spec[group]
                if workload in m.get("workloads", [workload])]

    def end_to_end(self, workload: str) -> List[Dict]:
        """The end-to-end metrics this cell reports."""
        return self._metrics("end_to_end", workload)

    def per_layer(self, workload: str) -> List[Dict]:
        """The per-layer metrics this cell reports."""
        return self._metrics("per_layer", workload)

    def module(self, group: str, name: str):
        """``<group>/<name>.py`` of the benchmark's folder, loaded by its
        path (a name may hold dots)."""
        return load_file(self.dir / group / f"{name}.py",
                         f"perfbench_{group}_{name}")


def load_file(path: Path, module_name: str):
    """The module at ``path``, loaded once a path (its name carries a
    hash of the path, so that two folders never share one)."""
    tag = hashlib.sha1(str(Path(path).resolve()).encode()).hexdigest()[:8]
    module_name = (module_name.replace(".", "_").replace("-", "_")
                   + "_" + tag)
    if module_name in sys.modules:
        return sys.modules[module_name]
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = mod
    spec.loader.exec_module(mod)
    return mod


class Run:
    """One run of one cell: its files, its arguments and its device.
    ``options`` carries what a calibration or a test asks of a kind
    (the control's precision, a fault planted for a test)."""

    def __init__(self, catalog: Catalog, workload: str, seed: int,
                 seconds: float, trace: bool, device: str, t0: float,
                 options: Dict = None):
        import torch

        self.catalog, self.torch = catalog, torch
        self.workload = catalog.workload(workload)
        self.name = workload
        self.config = catalog.config(self.workload["config"])
        self.traffic = catalog.traffic(self.workload["traffic"])
        self.limits = catalog.limits(workload)
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t0 = device, t0
        self.options = options or {}

    @property
    def model(self) -> Dict:
        return self.config["model"]

    def count(self, name: str):
        return self.catalog.module("counts", name)

    def reference(self):
        return self.catalog.module("reference", self.config["family"])

    def log(self, *parts) -> None:
        print(*parts, flush=True)
