"""Import guard of the PyTorch/CUDA port: ``repro_torch`` and every one
of its modules (``core/txp.py``, the torch backend's namespace, the
raylite runtime ``repro_torch.runtime``, the serving plane
``repro_torch.serve`` with the cluster LM's worker side
``repro_torch.serve.remote_lm``, the LM models, configs and launchers, the
training path ``repro_torch.train``, ``checkpoint`` and ``data``, the
planner ``repro_torch.core.planner`` and the launch layer's mesh, op
count and dry run included), the port's examples ``examples/torch_stap.py``,
``examples/torch_stap_pipeline.py``, ``examples/torch_serve_lm.py``,
``examples/torch_train_lm.py``, ``examples/torch_autoshard_demo.py``,
``examples/torch_quickstart.py`` and
``examples/torch_profile_then_compile.py`` and ``chip_smoke.py`` load neither jax nor
any module of the JAX package ``repro``, and no source file of the port
imports them. No kernel's wrapper or source (the flash backward's
included) calls a library kernel for its work (a GEMM, fused
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
                 "repro_torch.core.txp", "repro_torch.distrib.accel",
                 "repro_torch.distrib.cluster", "repro_torch.kernels.api",
                 "repro_torch.kernels.matmul.matmul",
                 "repro_torch.kernels.flash_attention.flash_attention",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.mamba_scan.mamba_scan",
                 "repro_torch.kernels.mamba_scan.ops",
                 "repro_torch.runtime.store", "repro_torch.runtime.executor",
                 "repro_torch.runtime.lineage", "repro_torch.runtime.tasks",
                 "repro_torch.runtime.elastic", "repro_torch.obs.summarize",
                 "repro_torch.serve.admission", "repro_torch.serve.loadgen",
                 "repro_torch.serve.cluster_engine",
                 "repro_torch.serve.remote_lm",
                 "repro_torch.serve.transfer_rate",
                 "repro_torch.serve.engine", "repro_torch.serve.request",
                 "repro_torch.serve.kvcache", "repro_torch.models.common",
                 "repro_torch.models.transformer",
                 "repro_torch.models.moe", "repro_torch.models.ssm",
                 "repro_torch.configs.registry",
                 "repro_torch.configs.gemma2_2b",
                 "repro_torch.configs.stablelm_3b",
                 "repro_torch.configs.olmoe_1b_7b",
                 "repro_torch.configs.qwen2_moe_a2_7b",
                 "repro_torch.configs.jamba_1_5_large_398b",
                 "repro_torch.configs.xlstm_125m",
                 "repro_torch.launch.serve",
                 "repro_torch.kernels.flash_attention.ref",
                 "repro_torch.configs.seamless_m4t_medium",
                 "repro_torch.configs.llava_next_mistral_7b",
                 "repro_torch.data.pipeline", "repro_torch.train",
                 "repro_torch.train.optimizer",
                 "repro_torch.train.grad_compress",
                 "repro_torch.train.train_loop", "repro_torch.train.tree",
                 "repro_torch.checkpoint.ckpt",
                 "repro_torch.launch.train",
                 "repro_torch.core.planner", "repro_torch.launch.mesh",
                 "repro_torch.launch.op_analysis",
                 "repro_torch.launch.dryrun",
                 "repro_torch.kernels.sharded"):
        assert name in res["modules"]


_PROBE_PACKAGE = """
import importlib, json, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"bad": bad}))
"""


@pytest.mark.parametrize("package", ["repro_torch.runtime",
                                     "repro_torch.serve",
                                     "repro_torch.serve.remote_lm",
                                     "repro_torch.serve.cluster_engine",
                                     "repro_torch.models.transformer",
                                     "repro_torch.serve.engine",
                                     "repro_torch.launch.serve",
                                     "repro_torch.configs",
                                     "repro_torch.launch.train",
                                     "repro_torch.train",
                                     "repro_torch.checkpoint.ckpt",
                                     "repro_torch.data.pipeline",
                                     "repro_torch.core.planner",
                                     "repro_torch.launch.dryrun"])
def test_importing_runtime_and_serve_alone_loads_no_jax_and_no_repro(
        package):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", _PROBE_PACKAGE, package],
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1])["bad"] == []


def test_no_port_source_imports_jax_or_repro():
    offenders = []
    files = sorted(PORT.rglob("*.py"))
    assert files
    for path in files:
        for no, line in enumerate(path.read_text().splitlines(), 1):
            if _FORBIDDEN.match(line):
                offenders.append(f"{path.relative_to(ROOT)}:{no}: {line}")
    assert offenders == []


_PROBE_EXAMPLE = """
import json, sys
import examples.torch_stap as ex
import examples.torch_stap_pipeline as pipe
import examples.torch_serve_lm as lm
import examples.torch_train_lm as train
import examples.torch_autoshard_demo as autoshard
import examples.torch_quickstart as quickstart
import examples.torch_profile_then_compile as profile_then_compile
assert callable(ex.stap_adaptive) and callable(ex.main)
assert callable(pipe.main) and callable(lm.main_local)
assert callable(train.main) and callable(autoshard.main)
assert callable(quickstart.main) and callable(profile_then_compile.main)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"bad": bad}))
"""


def test_importing_the_port_stap_example_loads_no_jax_and_no_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", _PROBE_EXAMPLE], env=env,
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1])["bad"] == []


@pytest.mark.parametrize("rel", ["examples/torch_stap.py",
                                 "examples/torch_stap_pipeline.py",
                                 "examples/torch_serve_lm.py",
                                 "examples/torch_train_lm.py",
                                 "examples/torch_autoshard_demo.py",
                                 "examples/torch_quickstart.py",
                                 "examples/torch_profile_then_compile.py",
                                 "chip_smoke.py"])
def test_port_entry_scripts_import_no_jax_or_repro(rel):
    lines = (ROOT / rel).read_text().splitlines()
    assert [ln for ln in lines if _FORBIDDEN.match(ln)] == []


def _assert_calls_no_library_kernel(name, source_name=None):
    kdir = PORT / "kernels" / name
    wrapper = (kdir / f"{name}.py").read_text()
    source = (kdir / "csrc" / f"{source_name or name}.cu").read_text()
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


def test_flash_backward_kernel_calls_no_library_kernel():
    _assert_calls_no_library_kernel("flash_attention",
                                    "flash_attention_bwd")


def test_scan_backward_kernel_calls_no_library_kernel():
    _assert_calls_no_library_kernel("mamba_scan", "mamba_scan_bwd")
