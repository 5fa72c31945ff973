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
"""

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
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
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
