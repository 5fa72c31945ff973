"""Run the JAX reference side of a port parity test in a subprocess.

The port's tests hold ``repro_torch`` to the reference package ``repro``
on the same inputs. Whatever makes the reference compute with JAX (a
Pallas kernel in interpret mode, a reference cluster whose workers run
Pallas twins) runs here, in a fresh interpreter, so the test process
never initialises a JAX backend: a process that has, and later forks a
worker that uses JAX, can deadlock in the child.

``run_reference(code, inputs, tmp_dir)`` saves ``inputs`` (name → numpy
array), runs ``code`` with them bound as the dict ``inputs``, and returns
what ``code`` put into the dict ``outputs`` (name → numpy array).

Model weights travel with ``PARAMS_CODE`` (its ``flat(prefix, tree)``
saves a reference param tree, every leaf as float32, which holds bf16
exactly) and come back with :func:`reference_params`.

Compiled-kernel cases travel with :func:`encode_case`: the kernel by
``module:name`` (it must be importable in both processes), its hints
and its arguments. ``CASE_CODE`` rebuilds them in the reference process
(``case_fn``, ``case_hints``, ``case_args``) and runs a compiled
kernel's np variant with every pfor body routed to a twin
(``run_twin``).
"""

import importlib
import json

import os
import subprocess
import sys
from pathlib import Path
from typing import Dict

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

_PRELUDE = """
import sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
with np.load(sys.argv[1]) as _f:
    inputs = {k: _f[k] for k in _f.files}
outputs = {}
"""

_EPILOGUE = """
np.savez(sys.argv[2], **outputs)
"""


def run_reference(code: str, inputs: Dict[str, np.ndarray], tmp_dir,
                  timeout_s: float = 300.0) -> Dict[str, np.ndarray]:
    tmp_dir = Path(tmp_dir)
    src, dst = tmp_dir / "reference_in.npz", tmp_dir / "reference_out.npz"
    np.savez(src, **inputs)
    env = dict(os.environ)
    # tests/ too: kernels shared with the test process (torch_kernels)
    # import by their own module name
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT),
                                         str(ROOT / "tests")])
    env.setdefault("JAX_PLATFORMS", "cpu")
    # ``-c``, not a script file: a reference cluster spawns workers, and
    # spawn re-imports a script's main module in every child
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE + code + _EPILOGUE,
         str(src), str(dst)],
        env=env, cwd=str(ROOT), capture_output=True, text=True,
        timeout=timeout_s)
    assert proc.returncode == 0, (
        f"reference subprocess failed ({proc.returncode}):\n"
        f"{proc.stderr[-4000:]}")
    with np.load(dst) as f:
        return {k: f[k] for k in f.files}


def encode_case(name: str, fn, args, hints=None) -> Dict[str, np.ndarray]:
    """Inputs that carry one compiled-kernel case to the reference
    process: arrays as they are, lists, ints, floats and complexes with
    a kind code each."""
    kinds = []
    path = fn.__name__
    held = getattr(importlib.import_module(fn.__module__), path, None)
    if held is not fn and getattr(held, "original", None) is fn:
        path += ".original"        # the source of a compiled kernel
    out = {f"{name}/fn": np.asarray(f"{fn.__module__}:{path}"),
           f"{name}/hints": np.asarray(json.dumps(hints or {}))}
    for i, a in enumerate(args):
        if isinstance(a, np.ndarray):
            kinds.append("a")
        elif isinstance(a, list):
            kinds.append("l")
        elif isinstance(a, (bool, int, np.integer)):
            kinds.append("i")
        elif isinstance(a, (float, np.floating)):
            kinds.append("f")
        else:
            kinds.append("c")
        out[f"{name}/{i}"] = np.asarray(a)
    out[f"{name}/kinds"] = np.asarray("".join(kinds))
    return out


CASE_CODE = """
import importlib, json
from repro.core import backends as _B


def case_fn(name):
    mod, path = str(inputs[name + "/fn"]).split(":")
    fn = importlib.import_module(mod)
    for attr in path.split("."):
        fn = getattr(fn, attr)
    return fn


def case_hints(name):
    return json.loads(str(inputs[name + "/hints"])) or None


def case_args(name):
    conv = {"a": lambda v: v.copy(), "l": lambda v: v.tolist(),
            "i": int, "f": float, "c": complex}
    return [conv[k](inputs[f"{name}/{i}"])
            for i, k in enumerate(str(inputs[name + "/kinds"]))]


def run_twin(ck, args, attr):
    gen = ck.variants["np"].generated
    ns = {"xp": np}
    for b in (gen.meta.pfor_twin_units or {}):
        ns.update(_B.get(b).namespace(gen.meta))
    ns["__pfor_run"] = lambda body, lo, hi, tile: \
        getattr(body, attr, body)(lo, hi)
    exec(compile(gen.source, "<reference>", "exec"), ns)
    ns[gen.fn_name](*args)
"""


PARAMS_CODE = """
import jax.numpy as jnp


def flat(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(f"{prefix}/{k}", v)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat(f"{prefix}/{i}", v)
    else:
        outputs[prefix] = np.asarray(jnp.asarray(tree, jnp.float32))
"""


def reference_params(reference, arch, dtype, cfg, device="cpu"):
    """The reference's params that ``PARAMS_CODE``'s ``flat`` saved under
    ``params/<arch>/<dtype>``, in the port's layout on ``device``."""
    from repro_torch.models import transformer as T

    prefix = f"params/{arch}/{dtype}/"
    tree: dict = {}
    for key, arr in reference.items():
        if not key.startswith(prefix):
            continue
        node, parts = tree, key[len(prefix):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return T.params_from_reference(lists(tree), cfg, device)
