"""The chaos knob of the port's kernel runtime: with
``REPRO_CUDA_CHAOS=fail`` every worker-side kernel call raises, as a
failed kernel build or launch would. On a ``device="cpu"`` fleet the
matmul-shaped pfor's chunks degrade ``cuda → np`` — each fallback
counted, the result still correct. On a CUDA fleet the same failure
fails the pfor: no chunk moves to the CPU. The knob is read by the
spawned workers, so this file runs its own fleet (posing GPU workers on
``device="cpu"``; the CUDA case flips the head's device, which is all
the head's policy reads)."""

import numpy as np
import pytest

from benchmarks.stap import gemm_rowscale
from repro_torch.core.compiler import compile_kernel
from repro_torch.distrib import ClusterRuntime
from repro_torch.distrib.cluster import ClusterTaskError

N, K, M = 96, 24, 20


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
    assert st["chunks_executed"].get("np", 0) > 0
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
