"""The slice end to end on the CPU: ``gemm_rowscale`` compiled by the
port and run on a port ``ClusterRuntime`` whose two workers pose as GPU
workers on ``device="cpu"``. Its matmul-shaped pfor routes every chunk
to the ``cuda`` twin, which runs the kernel's plain torch version there,
with no fallback; the result equals the reference package's cluster
result (run in a subprocess, ``tests/torch_reference.py``) and an
``np_only`` control at float64 atol 1e-8.

One port fleet serves the whole file (``rt.shutdown()`` in the
fixture). The hand-written kernel on the card is exercised by
``chip_smoke.py``; what a CUDA fleet does with a worker whose GPU probe
failed is checked here on the head's own logic.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmarks.stap import gemm_rowscale
from repro_torch.core.compiler import compile_kernel
from repro_torch.distrib import ClusterRuntime
from repro_torch.distrib.cluster import ClusterTaskError
from repro_torch.kernels import api
from repro_torch.kernels.matmul import matmul as matmul_kernel
from torch_reference import run_reference

N, K, M = 192, 48, 40

_REFERENCE = """
from benchmarks.stap import gemm_rowscale
from repro.core.compiler import compile_kernel
from repro.distrib import ClusterRuntime
A, B = inputs["A"], inputs["B"]
n, k = A.shape
m = B.shape[1]
rt = ClusterRuntime(workers=2, sim_gpu_workers=(0, 1))
try:
    ck = compile_kernel(gemm_rowscale)
    ck.pfor_config.runtime = rt
    ck.pfor_config.workers = 2
    ck.pfor_config.distribute_threshold = 0
    C = np.zeros((n, m))
    ck.call_variant("np", A, B, C, n, k, m)
    outputs["C"] = C
    outputs["pallas_chunks"] = np.asarray(
        rt.stats()["chunks_executed"].get("pallas", 0))
finally:
    rt.shutdown()
"""


@pytest.fixture(scope="module")
def fleet():
    rt = ClusterRuntime(workers=2, device="cpu", sim_gpu_workers=(0, 1))
    try:
        yield rt
    finally:
        rt.shutdown()


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(42)
    return rng.normal(size=(N, K)), rng.normal(size=(K, M))


def _add(a, b):
    return a + b


def _run(ck, rt, A, B):
    ck.pfor_config.runtime = rt
    ck.pfor_config.workers = 2
    ck.pfor_config.distribute_threshold = 0
    C = np.zeros((N, M))
    ck.call_variant("np", A, B, C, N, K, M)
    return C


def _reset(rt):
    for key in ("cuda_chunks", "cuda_fallbacks", "cuda_calls",
                "cuda_plain_calls", "matmul_launches"):
        setattr(rt, key, 0)
    rt.chunks_executed.clear()


def test_matmul_pfor_routes_to_cuda_twin(fleet, operands):
    assert fleet.device == "cpu" and fleet.start_method == "spawn"
    assert fleet.degrade_local      # device="cpu" keeps the default
    assert {p.gpu_kind for p in fleet.profiles()} == {"sim"}
    A, B = operands
    _reset(fleet)
    C = _run(compile_kernel(gemm_rowscale), fleet, A, B)
    st = fleet.stats()
    assert st["chunks_executed"].get("cuda", 0) > 0
    assert st["chunks_executed"].get("np", 0) == 0
    assert st["cuda_chunks"] > 0 and st["cuda_fallbacks"] == 0
    # the workers' kernel runtime ran, through the plain version on CPU
    assert st["cuda_calls"] > 0
    assert st["cuda_plain_calls"] == st["cuda_calls"]
    assert st["matmul_launches"] == 0
    np.testing.assert_allclose(C, (2.0 * A) @ B, atol=1e-8, rtol=0)


def test_matches_reference_cluster_and_np_only_control(fleet, operands,
                                                       tmp_path):
    A, B = operands
    got = _run(compile_kernel(gemm_rowscale), fleet, A, B)

    fleet.np_only = True
    _reset(fleet)
    try:
        ctrl = _run(compile_kernel(gemm_rowscale), fleet, A, B)
        st = fleet.stats()
    finally:
        fleet.np_only = False
    assert st["chunks_executed"].get("cuda", 0) == 0
    assert st["chunks_executed"].get("np", 0) > 0

    ref = run_reference(_REFERENCE, {"A": A, "B": B}, tmp_path)
    assert int(ref["pallas_chunks"]) > 0
    np.testing.assert_allclose(got, ref["C"], atol=1e-8, rtol=0)
    np.testing.assert_allclose(got, ctrl, atol=1e-8, rtol=0)


def test_cuda_device_raises_without_a_card(monkeypatch):
    """Without CUDA and without ``device="cpu"`` the port's entry points
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        ClusterRuntime(workers=1)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        ClusterRuntime(workers=1, device="tpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.set_device("cuda")
    # the runtime's default binding is the card, and it raises at use
    monkeypatch.setattr(api, "_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.matmul(np.ones((2, 2)), np.ones((2, 2)))
    with pytest.raises(ValueError, match="CUDA device"):
        matmul_kernel.matmul(torch.ones(2, 2, dtype=torch.float64),
                             torch.ones(2, 2, dtype=torch.float64))


def test_failed_gpu_probe_takes_a_cuda_worker_out_of_service(fleet,
                                                             monkeypatch):
    """A CUDA fleet never uses a worker whose GPU probe failed as a CPU
    worker: its hello leaves it without tasks, and with no other worker
    a task fails instead of running on the CPU."""
    monkeypatch.setattr(fleet, "device", "cuda")
    handles = list(fleet._handles.values())
    try:
        for wh in handles:
            prof = dict(wh.profile.as_dict(), has_gpu=False, gpu_kind="",
                        gpu_probe_error="RuntimeError: probe failed")
            fleet._handle(wh, ("hello", prof))
            assert wh.gpu_error == "RuntimeError: probe failed"
        assert fleet._views() == []
        assert fleet._live_gpu_errors() == ["RuntimeError: probe failed"] \
            * len(handles)
        with pytest.raises(ClusterTaskError, match="no worker has a working"):
            fleet.get(fleet.submit(_add, 1, 2), timeout=30)
    finally:
        monkeypatch.undo()
        for wh in handles:
            fleet._reprofile(wh)      # a passing probe restores service
    assert all(not wh.gpu_error for wh in handles)
    assert len(fleet._views()) == len(handles)


def test_failed_gpu_probe_fails_fleet_start():
    """At start-up the same failure raises from the constructor, after
    the fleet it started is shut down."""
    wh = SimpleNamespace(wid=0, hello=threading.Event(),
                         gpu_error="RuntimeError: probe failed")
    wh.hello.set()
    stopped = []
    head = SimpleNamespace(_lock=threading.Lock(), _handles={0: wh},
                           device="cuda",
                           shutdown=lambda: stopped.append(True))
    with pytest.raises(RuntimeError, match="failed its GPU probe"):
        ClusterRuntime._await_hellos(head, 1.0)
    assert stopped == [True]
