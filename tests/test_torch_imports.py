"""Import guard of the PyTorch/CUDA port: ``repro_torch`` and every one
of its modules load neither jax nor any module of the JAX package
``repro``, and no source file of the port imports them. No kernel's
wrapper or source calls a library kernel for its work (a GEMM, fused
attention, cuDNN)."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""

_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    # the slice's modules are all there
    for name in ("repro_torch.core.compiler", "repro_torch.core.patterns",
                 "repro_torch.distrib.cluster", "repro_torch.kernels.api",
                 "repro_torch.kernels.matmul.matmul",
                 "repro_torch.kernels.flash_attention.flash_attention",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.mamba_scan.mamba_scan",
                 "repro_torch.kernels.mamba_scan.ops"):
        assert name in res["modules"]


def test_no_port_source_imports_jax_or_repro():
    offenders = []
    files = sorted(PORT.rglob("*.py"))
    assert files
    for path in files:
        for no, line in enumerate(path.read_text().splitlines(), 1):
            if _FORBIDDEN.match(line):
                offenders.append(f"{path.relative_to(ROOT)}:{no}: {line}")
    assert offenders == []


def _assert_calls_no_library_kernel(name):
    kdir = PORT / "kernels" / name
    wrapper = (kdir / f"{name}.py").read_text()
    source = (kdir / "csrc" / f"{name}.cu").read_text()
    for word in ("torch.matmul", "torch.mm", "torch.bmm", "einsum",
                 "scaled_dot_product", "torch.nn", "cublas", "cudnn",
                 "cutlass"):
        assert word not in wrapper.lower()
    code = "\n".join(ln for ln in source.splitlines()
                     if not ln.lstrip().startswith("//"))
    for word in ("cublas", "cudnn", "cutlass", "#include <mma"):
        assert word not in code.lower()


def test_matmul_kernel_calls_no_library_gemm():
    _assert_calls_no_library_kernel("matmul")


@pytest.mark.parametrize("name", ["flash_attention", "mamba_scan"])
def test_kernel_calls_no_library_kernel(name):
    _assert_calls_no_library_kernel(name)
