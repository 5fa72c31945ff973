"""pfor-shaped kernels the port's twin tests compile with both packages.

Plain numpy and type hints only, so the test process and the reference
subprocess (``tests/torch_reference.py``) import the same function
objects by name (``torch_kernels:<name>``, with ``tests/`` on the
path). Each is a copy of a kernel of the reference's own tests, named in
its docstring.
"""

import numpy as np


def mm_kernel(A: "ndarray[f64,2]", B: "ndarray[f64,2]",
              C: "ndarray[f64,2]", n: int, k: int, m: int):
    """tests/test_pallas_backend.py: matmul-shaped (torch and cuda)."""
    for i in range(0, n):
        r = 2.0 * A[i, 0:k]
        C[i, 0:m] = np.dot(r, B[0:k, 0:m])


def attn_kernel(Q: "ndarray[f64,2]", K: "ndarray[f64,2]",
                V: "ndarray[f64,2]", O: "ndarray[f64,2]",
                n: int, t: int, d: int):
    """tests/test_pallas_backend.py: attention-shaped."""
    for i in range(0, n):
        s = np.dot(K[0:t, 0:d], Q[i, 0:d])
        p = np.exp(s)
        o = np.dot(p, V[0:t, 0:d])
        O[i, 0:d] = o / np.sum(p)


def scan_kernel(X: "ndarray[f64,2]", Y: "ndarray[f64,2]",
                n: int, L: int):
    """tests/test_pallas_backend.py: scan-shaped."""
    for i in range(0, n):
        h = 0.0
        for t in range(0, L):
            h = 0.9 * h + X[i, t]
            Y[i, t] = h


def hetero_kernel(x: "ndarray[f64,2]", y: "ndarray[f64,2]",
                  outY: "ndarray[f64,1]", n: int, m: int, iters: int):
    """tests/test_distrib_hetero.py: a convergence loop per row."""
    for i in range(0, n):
        w = 0.5 * y[i, 0:m]
        for t in range(0, iters):
            w = w + 0.1 * (x[i, 0:m] - w)
        outY[i] = np.dot(w[0:m], y[i, 0:m])


def numpy_local_kernel(A: "ndarray[f64,2]", out: "ndarray[f64,1]",
                       n: int, m: int):
    """tests/test_distrib_hetero.py: a local written in place."""
    for i in range(0, n):
        t = 1.0 * A[i, 0:m]
        t[0:m] = t[0:m] * 2.0
        out[i] = np.dot(t[0:m], A[i, 0:m])


def soak_kernel(A: "ndarray[f64,2]", s: "ndarray[f64,1]",
                out: "ndarray[f64,1]", N: int, M: int, iters: int):
    """tests/test_distrib.py (``_soak_kernel``): elementwise loop."""
    for i in range(0, N):
        w = 0.1 * s[0:M]
        for it in range(0, iters):
            w = w + 0.1 * (s[0:M] - A[i, 0:M] * w[0:M])
        out[i] = np.dot(w[0:M], A[i, 0:M])
