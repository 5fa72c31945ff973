"""The port's multi-tenant serving plane (``repro_torch.serve``):
admission control, request coalescing (bitwise against per-request
dispatch), fairness under saturation, elastic wiring and a worker killed
mid-serving.

The non-LM cases of the reference's ``tests/test_serve_cluster.py`` run
against the port. The cluster-backed ones serve the compiled
``_mini_stap`` kernel on a CPU fleet whose workers pose as GPUs
(``ClusterRuntime(device="cpu", sim_gpu_workers=(0, 1))``), so every
chunk takes the path it takes on the card — the torch twin, batched —
on the CPU. One more case holds the port to the reference: the same
seeded requests, coalesced, through the reference's
``ClusterServeEngine`` (in a subprocess, ``tests/torch_reference.py``)
and the port's, each on a plain CPU fleet, give ``out`` bit for bit.
"""

import threading
import time

import numpy as np
import pytest

from repro_torch.core.compiler import compile_kernel
from repro_torch.distrib import ClusterRuntime
from repro_torch.obs.metrics import Histogram
from repro_torch.runtime.elastic import ElasticController, ElasticPolicy
from repro_torch.serve import (AdmissionController, AdmissionError,
                               BatchSpec, ClusterServeEngine, TenantQuota,
                               open_loop)
from torch_kernels import mini_stap
from torch_reference import run_reference


# ---------------------------------------------------------------------------
# admission control (pure bookkeeping, injectable clock)
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_quota_inflight_rejected_and_counted():
    ac = AdmissionController({"a": TenantQuota(max_inflight=2)})
    ac.admit("a")
    ac.admit("a")
    with pytest.raises(AdmissionError) as ei:
        ac.admit("a")
    assert ei.value.reason == "quota_inflight"
    assert ei.value.tenant == "a"
    assert ac.telemetry()["rejected"]["a"]["quota_inflight"] == 1
    # a release frees one slot; the quota is per in-flight, not total
    ac.release("a")
    ac.admit("a")
    assert ac.telemetry()["admitted"]["a"] == 3


def test_rate_budget_token_bucket():
    clk = _Clock()
    ac = AdmissionController(
        {"a": TenantQuota(max_inflight=100, rate_per_s=2.0, burst=2)},
        clock=clk)
    ac.admit("a")
    ac.admit("a")
    with pytest.raises(AdmissionError) as ei:
        ac.admit("a")
    assert ei.value.reason == "rate"
    clk.now += 0.5     # refills one token at 2/s
    ac.admit("a")
    with pytest.raises(AdmissionError):
        ac.admit("a")
    assert ac.telemetry()["rejected"]["a"]["rate"] == 2


def test_bounded_queue_rejects_when_full():
    ac = AdmissionController(max_queue=2)
    ac.admit("a")
    ac.admit("b")
    with pytest.raises(AdmissionError) as ei:
        ac.admit("c")
    assert ei.value.reason == "queue_full"
    # execution dequeues → space frees even while both stay in flight
    ac.dequeued()
    ac.admit("c")


def test_engine_backpressure_is_explicit_and_counted():
    """A slow kernel + tiny queue: overflow submissions get a counted
    AdmissionError; every accepted request still completes."""
    gate = threading.Event()

    def slow(x, out, n):
        gate.wait(5.0)
        out[:] = x * 2.0

    eng = ClusterServeEngine(
        coalesce_window_s=0.0,
        admission=AdmissionController(
            default=TenantQuota(max_inflight=100), max_queue=3))
    eng.register("slow", slow,
                 batch=BatchSpec(stacked=("x",), count="n",
                                 out=("out",)))
    accepted, rejected = [], 0
    for i in range(8):
        try:
            accepted.append(
                (i, eng.submit("t", "slow",
                               (np.full(2, float(i)), np.zeros(2), 2))))
        except AdmissionError as e:
            assert e.reason == "queue_full"
            rejected += 1
    gate.set()
    for i, tk in accepted:
        assert np.array_equal(tk.wait(10.0), np.full(2, 2.0 * i))
    assert rejected > 0
    assert eng.rejections == rejected
    assert eng.telemetry()["tenants"]["rejections"]["t"] == rejected
    eng.close()


# ---------------------------------------------------------------------------
# coalescing
# ---------------------------------------------------------------------------

def test_coalesced_results_bitwise_match_per_request_local():
    def scale(x, out, n, a):
        for i in range(n):
            out[i] = x[i] * a + np.sin(x[i])

    rng = np.random.default_rng(0)
    xs = [rng.normal(size=5) for _ in range(6)]
    spec = BatchSpec(stacked=("x",), count="n", out=("out",),
                     shared=("a",))

    def run(window):
        eng = ClusterServeEngine(coalesce_window_s=window, max_batch=8)
        eng.register("scale", scale, batch=spec)
        tks = [eng.submit("t", "scale", (x, np.zeros(5), 5, 1.5))
               for x in xs]
        outs = [tk.wait(10.0).copy() for tk in tks]
        eng.close()
        return outs, eng

    naive, _ = run(0.0)
    coal, eng = run(0.05)
    assert eng.coalesced_batches >= 1
    assert eng.coalesced_requests >= 2
    for a, b in zip(naive, coal):
        assert np.array_equal(a, b)     # bitwise, not approx


def test_shared_arg_mismatch_blocks_coalescing():
    def scale(x, out, n, a):
        out[:n] = x[:n] * a

    eng = ClusterServeEngine(coalesce_window_s=0.05, max_batch=8)
    eng.register("scale", scale,
                 batch=BatchSpec(stacked=("x",), count="n",
                                 out=("out",), shared=("a",)))
    # different shared scalars → different coalesce keys → no merge
    t1 = eng.submit("t", "scale", (np.ones(3), np.zeros(3), 3, 2.0))
    t2 = eng.submit("t", "scale", (np.ones(3), np.zeros(3), 3, 5.0))
    assert np.array_equal(t1.wait(10.0), np.full(3, 2.0))
    assert np.array_equal(t2.wait(10.0), np.full(3, 5.0))
    assert t1.batch_size == 1 and t2.batch_size == 1
    assert eng.fallthrough_dispatches == 2
    eng.close()


def test_mixed_tenant_fairness_under_saturation():
    """Two tenants with equal quotas hammering a saturated engine both
    make proportional progress (FIFO dispatch, per-tenant caps)."""
    def work(x, out, n):
        time.sleep(0.002)
        out[:n] = x[:n] + 1.0

    eng = ClusterServeEngine(
        coalesce_window_s=0.005, max_batch=4,
        admission=AdmissionController(
            default=TenantQuota(max_inflight=6), max_queue=12))
    eng.register("work", work,
                 batch=BatchSpec(stacked=("x",), count="n",
                                 out=("out",)))

    def submit(i, tenant):
        return eng.submit(tenant, "work",
                          (np.full(2, float(i)), np.zeros(2), 2))

    res = open_loop(submit, requests=60, rate_rps=2000.0, seed=3,
                    tenants=("alice", "bob"))
    eng.close()
    a = res.per_tenant["alice"]
    b = res.per_tenant["bob"]
    assert a["completed"] > 0 and b["completed"] > 0
    # equal quotas → neither tenant starves (within 3x of each other)
    ratio = max(a["completed"], b["completed"]) / \
        min(a["completed"], b["completed"])
    assert ratio <= 3.0, (a, b)
    assert res.completed == a["completed"] + b["completed"]
    assert res.rejected == a["rejected"] + b["rejected"]
    # saturation at 2000 rps against ~ms service must shed load
    assert res.rejected > 0
    assert eng.telemetry()["e2e_ms"]["p95"] is not None


# ---------------------------------------------------------------------------
# cluster-backed serving (compiled kernel over worker processes)
# ---------------------------------------------------------------------------

_SPEC = BatchSpec(stacked=("A",), count="N", out=("out",),
                  shared=("s", "M", "iters"))


def _gpu_posing_fleet():
    return ClusterRuntime(workers=2, device="cpu", sim_gpu_workers=(0, 1))


def test_cluster_coalesced_matches_per_request_bitwise():
    rng = np.random.default_rng(1)
    s = rng.normal(size=12)
    mats = [rng.normal(size=(6, 12)) for _ in range(6)]
    rt = _gpu_posing_fleet()
    try:
        ck = compile_kernel(mini_stap, runtime=rt)
        ck.pfor_config.distribute_threshold = 0
        results = {}
        for window in (0.0, 0.05):
            eng = ClusterServeEngine(rt, coalesce_window_s=window,
                                     max_batch=8)
            eng.register("stap", ck, batch=_SPEC)
            tks = [eng.submit("t", "stap",
                              (A, s, np.zeros(6), 6, 12, 10))
                   for A in mats]
            results[window] = [tk.wait(60.0).copy() for tk in tks]
            eng.close()
            if window > 0:
                assert eng.coalesced_requests >= 2
        for a, b in zip(results[0.0], results[0.05]):
            assert np.array_equal(a, b)
        st = rt.stats()
        assert st["pfor_runs"] >= 2
        # every chunk took the card's path: the torch twin, batched
        assert st["torch_chunks"] > 0 and st["torch_fallbacks"] == 0
        assert st["batch_fallbacks"] == 0
    finally:
        rt.shutdown()


def test_worker_kill_mid_serving_keeps_results_correct():
    """SIGKILL a worker while the engine is serving: pfor-level retry +
    lineage replay keep every accepted request's result exact."""
    rng = np.random.default_rng(2)
    s = rng.normal(size=12)
    mats = [rng.normal(size=(6, 12)) for _ in range(10)]
    expected = []
    for A in mats:
        o = np.zeros(6)
        mini_stap(A, s, o, 6, 12, 10)
        expected.append(o)
    rt = _gpu_posing_fleet()
    try:
        ck = compile_kernel(mini_stap, runtime=rt)
        ck.pfor_config.distribute_threshold = 0
        eng = ClusterServeEngine(
            rt, coalesce_window_s=0.01, max_batch=4,
            admission=AdmissionController(
                default=TenantQuota(max_inflight=64), max_queue=64))
        eng.register("stap", ck, batch=_SPEC)
        tks = [eng.submit("t", "stap", (A, s, np.zeros(6), 6, 12, 10))
               for A in mats]
        # SIGKILL lands while the dispatcher is still draining batches
        assert rt.kill_worker() is not None
        outs = [tk.wait(120.0) for tk in tks]
        eng.close()
        for got, exp in zip(outs, expected):
            assert np.allclose(got, exp, atol=1e-12)
        deadline = time.perf_counter() + 10.0
        while (rt.stats()["worker_deaths"] < 1
               and time.perf_counter() < deadline):
            time.sleep(0.02)       # monitor detects the death async
        assert rt.stats()["worker_deaths"] >= 1
    finally:
        rt.shutdown()


def test_submit_batch_and_release():
    rt = ClusterRuntime(workers=2, device="cpu", start_method="spawn")
    try:
        refs = rt.submit_batch(_np_square, [(i,) for i in range(5)])
        got = rt.get(refs)
        assert got == [i * i for i in range(5)]
        for ref in refs:
            rt.release(ref)
            assert not rt.plane.contains(ref.oid)
        assert rt.queue_depth() == 0
    finally:
        rt.shutdown()


def _np_square(i):
    return i * i


_REFERENCE = """
from repro.core.compiler import compile_kernel
from repro.distrib import ClusterRuntime
from repro.serve import BatchSpec, ClusterServeEngine
from torch_kernels import mini_stap
spec = BatchSpec(stacked=("A",), count="N", out=("out",),
                 shared=("s", "M", "iters"))
rt = ClusterRuntime(workers=2)
try:
    ck = compile_kernel(mini_stap, runtime=rt)
    ck.pfor_config.distribute_threshold = 0
    eng = ClusterServeEngine(rt, coalesce_window_s=0.05, max_batch=8)
    eng.register("stap", ck, batch=spec)
    n = int(inputs["n"])
    tks = [eng.submit("t", "stap", (inputs[f"A{k}"], inputs["s"],
                                    np.zeros(6), 6, 12, 10))
           for k in range(n)]
    for k, tk in enumerate(tks):
        outputs[f"out{k}"] = tk.wait(120.0).copy()
    eng.close()
    outputs["coalesced"] = np.asarray(eng.coalesced_requests)
finally:
    rt.shutdown()
"""


def test_coalesced_mini_stap_equals_reference_bitwise(tmp_path):
    rng = np.random.default_rng(1)
    s = rng.normal(size=12)
    mats = [rng.normal(size=(6, 12)) for _ in range(6)]
    inputs = {"s": s, "n": np.asarray(len(mats))}
    inputs.update({f"A{k}": A for k, A in enumerate(mats)})
    ref = run_reference(_REFERENCE, inputs, tmp_path)
    rt = ClusterRuntime(workers=2, device="cpu", start_method="spawn")
    try:
        ck = compile_kernel(mini_stap, runtime=rt)
        ck.pfor_config.distribute_threshold = 0
        eng = ClusterServeEngine(rt, coalesce_window_s=0.05, max_batch=8)
        eng.register("stap", ck, batch=_SPEC)
        tks = [eng.submit("t", "stap", (A, s, np.zeros(6), 6, 12, 10))
               for A in mats]
        outs = [tk.wait(120.0).copy() for tk in tks]
        eng.close()
        assert eng.coalesced_requests >= 2
        assert int(ref["coalesced"]) >= 2
    finally:
        rt.shutdown()
    for k, got in enumerate(outs):
        assert np.array_equal(got, ref[f"out{k}"]), k


# ---------------------------------------------------------------------------
# elastic wiring + metrics
# ---------------------------------------------------------------------------

class _FakeRt:
    def __init__(self, size):
        self._size = size
        self.scaled_to = []

    def workers_alive(self):
        return self._size

    def queue_depth(self):
        return 0           # the runtime itself looks idle

    def scale_to(self, n):
        self.scaled_to.append(n)
        self._size = n


def test_elastic_controller_scales_on_serving_depth():
    rt = _FakeRt(2)
    depth = {"v": 10}
    ctl = ElasticController(
        rt, ElasticPolicy(min_workers=1, max_workers=8, step=2),
        depth_fn=lambda: depth["v"])
    assert ctl.tick() == 4          # 10 > 2*2 → grow by step
    assert rt.scaled_to == [4]
    depth["v"] = 0
    assert ctl.tick() == 3          # idle serving queue → shrink by 1
    assert rt.scaled_to == [4, 3]


def test_histogram_snapshot_has_p95():
    h = Histogram()
    for v in range(100):
        h.observe(float(v))
    snap = h.snapshot()
    assert snap["p95"] == 95.0
    assert snap["p50"] == 50.0
