"""The STAP flagship on the port: ``stap_adaptive`` (``examples/
torch_stap.py``, the text of ``examples/stap.py``) compiled by
``repro_torch`` emits a torch twin of the gate loop with the batched
fast path, and runs on a port ``ClusterRuntime``.

On the CPU the fleet is ``device="cpu"`` with worker 1 posing as a GPU:
its chunks run the torch twin (batched, on the CPU), worker 0's the np
body, and the result matches the sequential numpy kernel within atol
1e-8 — cold, warm (the batched entry is kept), and through the
worker-kill drill, whose replacement poses as a GPU again and runs torch
twins. The ``cuda``-marked case runs the same on a card fleet, where
every chunk must run the torch twin, and skips here.
"""

import threading

import numpy as np
import pytest
import torch

from examples.torch_stap import make_stap_data, stap_adaptive, stap_seq
from repro_torch.core.compiler import compile_kernel
from repro_torch.distrib import ClusterRuntime

GATES, K, DOF, ITERS, ALPHA, LOADING = 32, 64, 64, 200, 0.15, 2.0
SCALARS = (GATES, K, DOF, ITERS, ALPHA, LOADING)


def test_compile_emits_torch_twin_with_batched_path():
    ck = compile_kernel(stap_adaptive)
    src = ck.source("np")
    assert "def __pfor_body_0__torch(__lo, __hi):" in src
    assert "__pfor_batch(__pfor_iter_0, __lo, __hi, " in src
    assert "__pfor_body_0.__torch__ = __pfor_body_0__torch" in src
    assert ck.pfor_twin_units() == {"torch": [0]}
    assert ck.pfor_batch_units() == [0]


@pytest.fixture(scope="module")
def data():
    snap, train, steer, out = make_stap_data(gates=GATES)
    want = out.copy()
    stap_seq(snap, train, steer, want, *SCALARS)
    return snap, train, steer, want


def _run(ck, data):
    snap, train, steer, want = data
    out = np.zeros(GATES)
    ck.call_variant("np", snap, train, steer, out, *SCALARS)
    return float(np.abs(out - want).max())


def _counts(rt):
    st = rt.stats()
    return {"torch": st["chunks_executed"].get("torch", 0),
            "np": st["chunks_executed"].get("np", 0),
            "by_worker": dict(st["chunks_executed_by_worker"]),
            **{k: st[k] for k in ("batch_hits", "batch_builds",
                                  "batch_fallbacks", "torch_fallbacks",
                                  "worker_deaths")}}


def test_stap_on_a_cpu_fleet_with_a_gpu_poser(data):
    rt = ClusterRuntime(workers=2, device="cpu", sim_gpu_workers=(1,))
    try:
        ck = compile_kernel(stap_adaptive, runtime=rt, workers=2)
        ck.pfor_config.distribute_threshold = 0
        assert _run(ck, data) <= 1e-8                  # cold
        c1 = _counts(rt)
        assert c1["torch"] > 0 and c1["np"] > 0
        assert c1["batch_builds"] > 0
        assert c1["batch_fallbacks"] == 0 and c1["torch_fallbacks"] == 0
        assert _run(ck, data) <= 1e-8                  # warm
        c2 = _counts(rt)
        assert c2["batch_hits"] > c1["batch_hits"]
        assert c2["batch_builds"] == c1["batch_builds"]

        # the kill drill: the GPU poser dies mid-run
        killer = threading.Timer(0.05, rt.kill_worker, args=(1,))
        killer.start()
        try:
            assert _run(ck, data) <= 1e-8
        finally:
            killer.cancel()
        c3 = _counts(rt)
        assert c3["worker_deaths"] == 1
        new = [w for w in c3["by_worker"] if w not in (0, 1)]
        assert new, c3
        # its replacement poses as a GPU again and runs torch twins
        assert _run(ck, data) <= 1e-8
        c4 = _counts(rt)
        ran_new = c4["by_worker"][new[0]] - c3["by_worker"].get(new[0], 0)
        assert ran_new > 0
        assert c4["torch"] - c3["torch"] == ran_new
        assert c4["batch_fallbacks"] == 0
        assert any(p.has_gpu for p in rt.profiles() if p.wid == new[0])
    finally:
        rt.shutdown()


@pytest.mark.cuda
def test_cuda_stap_runs_every_chunk_on_the_torch_twin():
    """At the example's widths and 800 steps over 512 gates: at fewer
    (32 gates of 200 steps) the router prices the np body below the
    torch twin's launch overhead on the card's host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a card fleet has no CPU stand-in")
    gates, iters = 512, 800
    snap, train, steer, out = make_stap_data(gates=gates)
    scalars = (gates, K, DOF, iters, ALPHA, LOADING)
    want = out.copy()
    stap_seq(snap, train, steer, want, *scalars)
    rt = ClusterRuntime(workers=2, device="cuda")
    try:
        ck = compile_kernel(stap_adaptive, runtime=rt, workers=2)
        ck.pfor_config.distribute_threshold = 0
        for _ in range(2):
            got = np.zeros(gates)
            ck.call_variant("np", snap, train, steer, got, *scalars)
            assert np.abs(got - want).max() <= 1e-8
        c = _counts(rt)
        assert c["np"] == 0 and c["torch"] > 0
        assert c["batch_fallbacks"] == 0 and c["batch_hits"] > 0
    finally:
        rt.shutdown()
