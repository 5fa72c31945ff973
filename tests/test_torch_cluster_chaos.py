"""The chaos knob of the port's kernel runtime: with
``REPRO_CUDA_CHAOS=fail`` every worker-side kernel call raises, as a
failed kernel build or launch would. On a ``device="cpu"`` fleet the
matmul-shaped pfor's chunks degrade one step down the chain ``cuda →
torch → np``, to the torch twin — each fallback counted, the result
still correct. On a CUDA fleet the same failure
fails the pfor: no chunk moves to the CPU. The knob is read by the
spawned workers, so this file runs its own fleet (posing GPU workers on
``device="cpu"``; the CUDA case flips the head's device, which is all
the head's policy reads).

A lowering the kernel runtime refuses is not a kernel failure: a scan
whose coefficient is only known at run time gets a cuda twin, and a
value outside (0, 1) raises ``cuda-lowering-infeasible`` on the worker,
so the chunk steps down to its torch twin (on the same device) as a
counted fallback — on a CUDA fleet too (``tests/test_pallas_backend.py``
checks the reference the same way)."""

import numpy as np
import pytest

from benchmarks.stap import gemm_rowscale
from repro_torch.core.compiler import compile_kernel
from repro_torch.distrib import ClusterRuntime
from repro_torch.distrib.cluster import ClusterTaskError

N, K, M = 96, 24, 20


def scan_kernel_param(X: "ndarray[f64,2]", Y: "ndarray[f64,2]",
                      c: float, n: int, L: int):
    for i in range(0, n):
        h = 0.0
        for t in range(0, L):
            h = c * h + X[i, t]
            Y[i, t] = h


@pytest.fixture(scope="module")
def fleet():
    rt = ClusterRuntime(workers=2, device="cpu", sim_gpu_workers=(0, 1))
    try:
        yield rt
    finally:
        rt.shutdown()


@pytest.fixture(scope="module")
def chaos_fleet():
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_CUDA_CHAOS", "fail")
    try:
        rt = ClusterRuntime(workers=2, device="cpu", sim_gpu_workers=(0, 1))
    finally:
        mp.undo()            # spawned workers already copied the env
    try:
        yield rt
    finally:
        rt.shutdown()


def _run(rt):
    rng = np.random.default_rng(2)
    A, B = rng.normal(size=(N, K)), rng.normal(size=(K, M))
    ck = compile_kernel(gemm_rowscale, runtime=rt, workers=2)
    ck.pfor_config.distribute_threshold = 0
    C = np.zeros((N, M))
    ck.call_variant("np", A, B, C, N, K, M)
    return C, (2.0 * A) @ B


def test_chaos_degrades_counted_not_crashed(chaos_fleet):
    C, want = _run(chaos_fleet)
    st = chaos_fleet.stats()
    np.testing.assert_allclose(C, want, atol=1e-8, rtol=0)
    assert st["cuda_chunks"] > 0
    assert st["cuda_fallbacks"] > 0
    assert st["chunks_executed"].get("cuda", 0) == 0
    assert st["chunks_executed"].get("torch", 0) > 0
    assert st["torch_fallbacks"] == 0
    assert st["cuda_calls"] == 0


def test_kernel_failure_on_a_cuda_fleet_raises(chaos_fleet, monkeypatch):
    monkeypatch.setattr(chaos_fleet, "device", "cuda")
    monkeypatch.setattr(chaos_fleet, "degrade_local", False)  # its default
    executed = dict(chaos_fleet.stats()["chunks_executed"])
    fallbacks = chaos_fleet.cuda_fallbacks
    with pytest.raises(ClusterTaskError, match="no CPU fallback"):
        _run(chaos_fleet)
    st = chaos_fleet.stats()
    assert st["cuda_fallbacks"] == fallbacks
    assert st["chunks_executed"] == executed
    assert st["faults"].get("cuda_kernel_errors", 0) > 0


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_infeasible_scan_coeff_steps_down_to_np_counted(fleet, monkeypatch,
                                                        device):
    monkeypatch.setattr(fleet, "device", device)
    ck = compile_kernel(scan_kernel_param, runtime=fleet, workers=2)
    assert "__cuk.scan_rows(" in ck.source("np")
    ck.pfor_config.distribute_threshold = 0
    rng = np.random.default_rng(3)
    n, L = 24, 16
    X = rng.normal(size=(n, L))
    want = np.zeros((n, L))
    scan_kernel_param(X, want, 1.5, n, L)    # c > 1: the kernel refuses
    fallbacks = fleet.cuda_fallbacks
    executed = dict(fleet.stats()["chunks_executed"])
    Y = np.zeros((n, L))
    ck.call_variant("np", X, Y, 1.5, n, L)
    np.testing.assert_allclose(Y, want, atol=1e-8, rtol=0)
    st = fleet.stats()
    assert st["cuda_fallbacks"] > fallbacks
    assert st["chunks_executed"].get("cuda", 0) == executed.get("cuda", 0)
    assert st["chunks_executed"].get("torch", 0) \
        > executed.get("torch", 0)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_twin_errors_step_down_the_chain_only_where_the_fleet_allows(device):
    """The head's policy for an erroring twin chunk, chain ``cuda →
    torch → np``: on a ``device="cpu"`` fleet every error steps one down,
    counted per backend; on a CUDA fleet a torch twin's error and a cuda
    kernel's error fail the task, and only a refused lowering steps
    ``cuda → torch`` (on the same device)."""
    from types import SimpleNamespace

    from repro_torch.distrib.cluster import CUDA_INFEASIBLE
    from repro_torch.distrib.objects import TaskSpec

    head = SimpleNamespace(device=device, cuda_fallbacks=0,
                           torch_fallbacks=0)

    def spec(backend, chain):
        return TaskSpec(1, "chunk", None, (), None, backend=backend,
                        alt=tuple((b, i, None) for i, b in
                                  enumerate(chain)))

    def failed(s, message):
        return ClusterRuntime._kernel_failed(head, s, message)

    def down(s, message):
        ClusterRuntime._maybe_downgrade_backend(head, s, message)
        return s.backend

    err, refused = "RuntimeError('boom')", f"ValueError('{CUDA_INFEASIBLE}')"
    s = spec("cuda", ["torch", "np"])
    assert failed(s, refused) is False
    assert down(s, refused) == "torch" and head.cuda_fallbacks == 1
    assert failed(s, err) is (device == "cuda")
    if device == "cpu":
        assert down(s, err) == "np" and head.torch_fallbacks == 1
    else:
        assert failed(spec("cuda", ["torch", "np"]), err)
        assert down(s, err) == "torch" and head.torch_fallbacks == 0
