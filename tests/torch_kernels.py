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


def int_div_kernel(X: "ndarray[i64,2]", Y: "ndarray[f64,2]",
                   outY: "ndarray[f64,2]", n: int, m: int, iters: int):
    """An integer operand divided by 3 after a convergence loop (the
    dtype probe of the torch backend's integer operands)."""
    for i in range(0, n):
        w = 0.5 * Y[i, 0:m]
        for t in range(0, iters):
            w = w + 0.1 * (Y[i, 0:m] - w)
        outY[i, 0:m] = w + X[i, 0:m] / 3


def int_sqrt_kernel(X: "ndarray[i64,2]", Y: "ndarray[f64,2]",
                    outY: "ndarray[f64,2]", n: int, m: int, iters: int):
    """As :func:`int_div_kernel`, with ``np.sqrt`` of the integers."""
    for i in range(0, n):
        w = 0.5 * Y[i, 0:m]
        for t in range(0, iters):
            w = w + 0.1 * (Y[i, 0:m] - w)
        outY[i, 0:m] = w + np.sqrt(X[i, 0:m])


def int_sqrt_whole(X: "ndarray[i64,2]", B: "ndarray[f64,2]", n: int):
    """Pfor-free: the whole-kernel variant over integer operands."""
    for i in range(0, n):
        for j in range(0, n):
            B[i, j] = B[i, j] + np.sqrt(X[i, j])


def relu_iter_kernel(x: "ndarray[f32,2]", out: "ndarray[f32,2]",
                     n: int, m: int, iters: int):
    """A float32 body whose scalars are python floats (weak: the body
    stays float32, as numpy's does)."""
    for i in range(0, n):
        w = 0.0 * x[i, 0:m]
        for t in range(0, iters):
            w = np.maximum(w * 1.1 + 0.1 * x[i, 0:m], 0.0)
        out[i, 0:m] = w


def relu_scaled_kernel(x: "ndarray[f32,2]", out: "ndarray[f32,2]",
                       n: int, m: int, iters: int, a: float):
    """:func:`relu_iter_kernel` with its factor a parameter: a numpy
    scalar there is strong (``np.float64`` widens the body to float64)."""
    for i in range(0, n):
        w = 0.0 * x[i, 0:m]
        for t in range(0, iters):
            w = np.maximum(w * a + 0.1 * x[i, 0:m], 0.0)
        out[i, 0:m] = w


def saxpy_kernel(out: "ndarray[f64,2]", A: "ndarray[f64,2]",
                 x: "ndarray[f64,1]", N: int):
    """tests/test_serve_pfor.py (``saxpy``): fully affine, absorbed."""
    for i in range(0, N):
        out[i, :] = A[i, :] * x[i]


def rowfft_kernel(out: "ndarray[c128,2]", A: "ndarray[c128,2]", N: int,
                  F: int):
    """tests/test_serve_pfor.py (``rowfft``): a materialization point
    keeps the loop an explicit pfor."""
    for i in range(0, N):
        row = np.fft.fft(A[i, :], F)
        out[i, 0:F] = row * 2.0


def scale_kernel(out: "ndarray[f64,2]", A: "ndarray[f64,2]", N: int):
    """tests/test_serve_pfor.py (``scale``): below the threshold."""
    for i in range(0, N):
        out[i, :] = A[i, :] * 2.0


def mini_stap(A: "ndarray[f64,2]", s: "ndarray[f64,1]",
              out: "ndarray[f64,1]", N: int, M: int, iters: int):
    """tests/test_serve_cluster.py (``_mini_stap``): the served kernel."""
    for i in range(0, N):
        w = 0.1 * s[0:M]
        for it in range(0, iters):
            w = w + 0.1 * (s[0:M] - A[i, 0:M] * w[0:M])
        out[i] = np.dot(w[0:M], A[i, 0:M])


def shift_scale_kernel(x: "ndarray[f64,2]", out: "ndarray[f64,2]", n: int,
                       m: int, iters: int, a: float):
    """A factor computed from a scalar parameter and constants alone
    (python numbers: no tensor enters it) inside a row loop."""
    for i in range(0, n):
        w = 0.0 * x[i, 0:m]
        for t in range(0, iters):
            w = w * 0.5 + x[i, 0:m] * (a * 2.0 + 1.0)
        out[i, 0:m] = w
