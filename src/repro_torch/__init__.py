"""PyTorch/CUDA port of the AutoMPHC reproduction.

A second package beside the JAX reference (``repro``), with the same
subpackage layout: each module sits at the same relative path as its
reference. It imports ``torch`` and ``numpy``, never ``jax`` and nothing
of ``repro``. Every Pallas kernel of the reference on the ported path
is a hand-written Hopper kernel here (``kernels/``), reached from
compiled pfor units through the cluster's workers.

    from repro_torch.core.compiler import compile_kernel
    from repro_torch.distrib import ClusterRuntime
    rt = ClusterRuntime(workers=2)            # device="cuda" by default
    ck = compile_kernel(kernel, runtime=rt)   # matmul-shaped pfor → CUDA
"""
