"""Quickstart on the port: the paper in 40 lines.

The reference's ``examples/quickstart.py`` with its imports taken from
``repro_torch``: write a plain Python kernel with type hints, hand it to
``optimize``, get a multi-versioned optimized callable — explicit loops
and NumPy style both raise to the same high-performance code (paper
Figs. 1/2/6). ``--device`` binds the whole-kernel torch variant's device
(the card by default; ``--device cpu`` for the CPU).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import argparse  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.core import txp  # noqa: E402
from repro_torch.core.compiler import optimize  # noqa: E402


# The paper's Fig. 1 pattern: explicit loops over lists
@optimize
def correlation_loops(float_n: float, data: "list[f64,2]",
                      corr: "list[f64,2]", M: int, N: int):
    for i in range(0, M):
        corr[i][i] = 1.0
    for i in range(0, M - 1):
        for j in range(i + 1, M):
            corr[i][j] = 0.0
            for k in range(0, N):
                corr[i][j] += data[k][i] * data[k][j]
            corr[j][i] = corr[i][j]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    txp.set_device(ap.parse_args(argv).device)
    M, N = 64, 128
    rng = np.random.default_rng(0)
    data = rng.normal(size=(N, M))
    data -= data.mean(axis=0)
    data /= np.maximum(data.std(axis=0), 0.1) * np.sqrt(N)

    corr = [[0.0] * M for _ in range(M)]
    correlation_loops(float(N), data.tolist(), corr, M, N)

    expected = data.T @ data
    np.fill_diagonal(expected, 1.0)
    err = np.abs(np.asarray(corr) - expected).max()
    print("max error vs numpy ground truth:", err)
    assert err < 1e-7

    print("\n--- generated optimized code (np backend) ---")
    print(correlation_loops.source("np"))
    print("--- decision tree ---")
    print(correlation_loops.explain())


if __name__ == "__main__":
    main()
