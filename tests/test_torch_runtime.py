"""The port's raylite runtime (``repro_torch.runtime``) and trace
summarizer (``repro_torch.obs.summarize``).

The cases of the reference's ``tests/test_runtime.py`` run against the
port's copy: the task DAG, lineage replay (also under racing
evictions), retries, straggler speculation, elastic scaling and worker
failure. The raylite cases of ``tests/test_serve_pfor.py`` compile
kernels with both packages on a ``TaskRuntime`` and hold the port's np
variant to the reference's bit for bit on the same seeded inputs (the
reference in a subprocess, ``tests/torch_reference.py``), with the same
task counts. The two summarize cases of ``tests/test_obs.py`` read a
trace exported by the port's own ``obs``.

These runtimes are made with ``device="cpu"``, so each pfor chunk runs
the numpy body in a host thread, as the reference's raylite does. The
default runtime runs the body's torch twin on the card: on a host
without one it raises at construction, and the ``cuda`` case below runs
the STAP pipeline that way.
"""

import json
import time

import numpy as np
import pytest
import torch

from benchmarks.stap import FFT_SIZE, make_data, stap_kernel, stap_ref
from repro_torch import obs
from repro_torch.core import txp
from repro_torch.core.compiler import compile_kernel
from repro_torch.obs import summarize
from repro_torch.runtime import (ElasticController, ElasticPolicy, ObjectRef,
                                 TaskFailedError, TaskRuntime)
from torch_kernels import rowfft_kernel, saxpy_kernel, scale_kernel
from torch_reference import CASE_CODE, encode_case, run_reference


@pytest.fixture
def rt():
    r = TaskRuntime(workers=4, speculation=False, device="cpu")
    yield r
    r.shutdown()


# ---------------------------------------------------------------------------
# tests/test_runtime.py against the port
# ---------------------------------------------------------------------------

def test_dag_chaining(rt):
    def add(a, b):
        return a + b

    a = rt.submit(add, 1, 2)
    b = rt.submit(add, a, 10)
    c = rt.submit(add, a, b)
    assert rt.get(c) == 16


def test_async_submission_is_nonblocking(rt):
    def slow(x):
        time.sleep(0.2)
        return x

    t0 = time.perf_counter()
    refs = [rt.submit(slow, i) for i in range(8)]
    assert time.perf_counter() - t0 < 0.1  # submission returns immediately
    assert rt.get(refs[-1]) == 7


def test_lineage_replay_after_eviction(rt):
    def mul(a, b):
        return a * b

    a = rt.submit(mul, 3, 4)
    b = rt.submit(mul, a, 2)
    assert rt.get(b) == 24
    rt.store.evict(b)
    assert rt.get(b) == 24
    assert rt.lineage.replays >= 1


def test_lineage_transitive_replay(rt):
    def inc(x):
        return x + 1

    chain = rt.submit(inc, 0)
    for _ in range(5):
        chain = rt.submit(inc, chain)
    assert rt.get(chain) == 6
    # evict everything reachable and recover the tip
    for oid in list(rt.store._data):
        rt.store.evict(ObjectRef(oid))
    # the store is empty; recompute from lineage
    assert rt.lineage.reconstruct(chain) == 6


def test_retry_on_failure(rt):
    def flaky(x):
        return x * 2

    rt.failure_injections["test_retry_on_failure.<locals>.flaky"] = 2
    ref = rt.submit(flaky, 21)
    assert rt.get(ref) == 42
    assert rt.stats()["retries"] >= 2


def test_task_failure_surfaces(rt):
    def boom():
        raise ValueError("nope")

    ref = rt.submit(boom)
    with pytest.raises(TaskFailedError):
        rt.get(ref)


def test_straggler_speculation():
    rt = TaskRuntime(workers=3, speculation=True, straggler_factor=2.0,
                     straggler_min_s=0.05, device="cpu")
    try:
        state = {"first": True}

        def work(i):
            time.sleep(0.01)
            return i

        def straggler(i):
            # first execution sleeps long; the speculative copy is fast
            if state["first"]:
                state["first"] = False
                time.sleep(1.0)
            return i

        for i in range(10):
            rt.get(rt.submit(work, i))
        t0 = time.perf_counter()
        ref = rt.submit(straggler, 99)
        assert rt.get(ref, timeout=5.0) == 99
        took = time.perf_counter() - t0
        assert took < 1.0, f"speculation did not win: {took}"
        assert rt.stats()["speculated"] >= 1
    finally:
        rt.shutdown()


def test_elastic_scale_up_down(rt):
    rt.scale_to(8)
    time.sleep(0.3)
    assert rt.pool.size == 8
    rt.scale_to(2)
    time.sleep(0.5)
    assert rt.pool.size == 2


def test_elastic_controller_grows_under_load(rt):
    ctrl = ElasticController(rt, ElasticPolicy(min_workers=2,
                                               max_workers=8, step=2))

    def slow(i):
        time.sleep(0.05)
        return i

    refs = [rt.submit(slow, i) for i in range(64)]
    for _ in range(20):
        ctrl.tick()
        time.sleep(0.01)
    assert rt.pool.size > 4 or rt.pool.queue_depth() == 0
    rt.get(refs[-1])


def test_worker_failure_requeues(rt):
    def job(i):
        time.sleep(0.05)
        return i

    refs = [rt.submit(job, i) for i in range(12)]
    rt.pool.kill_worker()
    rt.pool.add_worker()
    assert [rt.get(r) for r in refs] == list(range(12))


def _racing_fulfill(rt, target=None, times=None):
    """Wrap ``rt.store.fulfill`` so every refill (of ``target`` only,
    when given, at most ``times`` times) is evicted again at once — a
    producing worker killed mid-replay. Returns (restore, count)."""
    original = rt.store.fulfill
    raced = {"n": 0}

    def racing(r, v):
        original(r, v)
        if (target is None or r.id == target.id) and (
                times is None or raced["n"] < times):
            raced["n"] += 1
            rt.store.evict(r)

    rt.store.fulfill = racing
    return (lambda: setattr(rt.store, "fulfill", original)), raced


@pytest.mark.parametrize("shape", ["direct", "transitive"])
def test_replay_under_racing_eviction(rt, shape):
    """A replayed value returns from the recomputation itself, so an
    eviction racing the refill (directly, or of every object of a chain)
    never surfaces ObjectLostError — the reference's
    ``test_replay_idempotent_under_concurrent_eviction`` and
    ``test_replay_transitive_with_racing_eviction``."""
    if shape == "direct":
        ref = rt.submit(lambda a, b: a * b, 6, 7)
        assert rt.get(ref) == 42
        rt.store.evict(ref)
        restore, raced = _racing_fulfill(rt, target=ref, times=2)
        try:
            assert rt.get(ref) == 42   # first lineage pass succeeds
        finally:
            restore()
        assert raced["n"] >= 1
        assert rt.lineage.replays >= 1
    else:
        a = rt.submit(lambda x: x + 1, 0)
        b = rt.submit(lambda x: x + 1, a)
        assert rt.get(b) == 2
        rt.store.evict(a)
        rt.store.evict(b)
        restore, raced = _racing_fulfill(rt)
        try:
            assert rt.lineage.reconstruct(b) == 2
        finally:
            restore()
        assert raced["n"] >= 2


# ---------------------------------------------------------------------------
# tests/test_serve_pfor.py's raylite cases, against the reference
# ---------------------------------------------------------------------------

def _pfor_cases():
    """(id, kernel, args, output index, workers, compile kwargs,
    distribute_threshold or None for the default)."""
    rng = np.random.default_rng(0)
    N, M = 64, 16
    yield ("saxpy", saxpy_kernel,
           [np.zeros((N, M)), rng.normal(size=(N, M)), rng.normal(size=N),
            N], 0, 2, {}, None)
    rng = np.random.default_rng(0)
    N, M, F = 32, 16, 16
    A = rng.normal(size=(N, M)) + 1j * rng.normal(size=(N, M))
    yield ("rowfft", rowfft_kernel, [np.zeros((N, F), complex), A, N, F],
           0, 4, {"tile": 4}, 0)
    rng = np.random.default_rng(1)
    yield ("scale", scale_kernel, [np.zeros((8, 4)),
                                   rng.normal(size=(8, 4)), 8], 0, 2, {},
           None)
    cubes, sv, mf, out = make_data(n_cubes=4)
    yield ("stap_pipeline", stap_kernel, [cubes, sv, mf, out, 4, FFT_SIZE],
           3, 2, {}, None)


PFOR = list(_pfor_cases())

_REFERENCE = """
import importlib, json
from repro.core.compiler import compile_kernel
from repro.runtime import TaskRuntime
""" + CASE_CODE + """
for name in str(inputs["names"]).split(","):
    workers, kw, thr = json.loads(str(inputs[name + "/run"]))
    rt = TaskRuntime(workers=workers, speculation=False)
    try:
        ck = compile_kernel(case_fn(name), runtime=rt, **kw)
        if thr is not None:
            ck.pfor_config.distribute_threshold = thr
        args = case_args(name)
        ck.call_variant("np", *args)
        for i, a in enumerate(args):
            outputs[f"{name}/{i}"] = np.asarray(a)
        outputs[name + "/tasks"] = np.asarray(rt.stats()["tasks"])
        outputs[name + "/has_pfor"] = np.asarray(ck.sched.has_pfor)
    finally:
        rt.shutdown()
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    inputs = {"names": np.asarray(",".join(c[0] for c in PFOR))}
    for name, fn, args, _, workers, kw, thr in PFOR:
        inputs.update(encode_case(name, fn, args))
        inputs[name + "/run"] = np.asarray(json.dumps([workers, kw, thr]))
    return run_reference(_REFERENCE, inputs,
                         tmp_path_factory.mktemp("raylite"))


def _run_port(case):
    name, fn, args, out, workers, kw, thr = case
    rt = TaskRuntime(workers=workers, speculation=False, device="cpu")
    try:
        ck = compile_kernel(fn, runtime=rt, **kw)
        if thr is not None:
            ck.pfor_config.distribute_threshold = thr
        got = [a.copy() if isinstance(a, np.ndarray) else a for a in args]
        ck.call_variant("np", *got)
        return ck, got, rt.stats()["tasks"]
    finally:
        rt.shutdown()


def _case(name):
    return next(c for c in PFOR if c[0] == name)


def _same_as_reference(reference, case, got, tasks):
    name, out = case[0], case[3]
    assert np.array_equal(got[out], reference[f"{name}/{out}"])
    assert tasks == int(reference[name + "/tasks"])


def test_fully_affine_loop_absorbed_not_distributed(reference):
    """Intra-node maximization wins for fully analyzable loops: the loop
    is absorbed into one vectorized op, no tasks spawned."""
    case = _case("saxpy")
    ck, got, tasks = _run_port(case)
    np.testing.assert_allclose(got[0], case[2][1] * case[2][2][:, None])
    assert not ck.sched.has_pfor          # absorbed
    assert not bool(reference["saxpy/has_pfor"])
    assert tasks == 0
    _same_as_reference(reference, case, got, tasks)


def test_pfor_distributed_matches_sequential(reference):
    """A loop with a materialization point (fft) stays explicit, is
    detected parallel, and distributes over raylite tasks."""
    case = _case("rowfft")
    ck, got, tasks = _run_port(case)
    A, F = case[2][1], case[2][3]
    np.testing.assert_allclose(got[0], np.fft.fft(A, F, axis=1) * 2.0)
    assert ck.sched.has_pfor
    assert tasks >= 8  # actually distributed
    _same_as_reference(reference, case, got, tasks)


def test_pfor_sequential_below_threshold(reference):
    case = _case("scale")
    ck, got, tasks = _run_port(case)
    np.testing.assert_allclose(got[0], case[2][1] * 2.0)
    assert tasks == 0
    _same_as_reference(reference, case, got, tasks)


def test_stap_pipeline_correctness(reference):
    case = _case("stap_pipeline")
    ck, got, tasks = _run_port(case)
    cubes, sv, mf, out, n, fft = case[2]
    out_ref = out.copy()
    stap_ref(cubes, sv, mf, out_ref, n, fft)
    np.testing.assert_allclose(got[3], out_ref, atol=1e-9)
    # the cube loop must be recognized as a distributable pfor
    assert ck.sched.has_pfor
    _same_as_reference(reference, case, got, tasks)


def test_default_runtime_without_a_card_raises_naming_cpu(monkeypatch):
    """The default runtime computes pfor chunks on the card: without one
    it refuses at construction and says how to ask for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(txp.DeviceUnavailable, match="device='cpu'"):
        TaskRuntime(workers=2, speculation=False)


def test_card_runtime_refuses_a_cpu_bound_backend(monkeypatch):
    """A card runtime whose torch backend the process bound to the CPU
    raises at its first distributed pfor instead of computing there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(txp, "_DEVICE", "cpu")
    case = _case("stap_pipeline")
    rt = TaskRuntime(workers=2, speculation=False)
    try:
        ck = compile_kernel(case[1], runtime=rt)
        ck.pfor_config.distribute_threshold = 0
        with pytest.raises(ValueError, match="bound to 'cpu'"):
            ck.call_variant("np", *[a.copy() if isinstance(a, np.ndarray)
                                    else a for a in case[2]])
        assert rt.stats()["tasks"] == 0
    finally:
        rt.shutdown()


@pytest.mark.cuda
def test_stap_pipeline_on_the_card():
    """The default runtime runs every STAP chunk's torch twin on the
    card, within 1e-9 of the sequential reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the default runtime computes "
                    "on the card")
    case = _case("stap_pipeline")
    cubes, sv, mf, out, n, fft = case[2]
    out_ref = out.copy()
    stap_ref(cubes, sv, mf, out_ref, n, fft)
    rt = TaskRuntime(workers=2, speculation=False)
    try:
        ck = compile_kernel(case[1], runtime=rt)
        ck.pfor_config.distribute_threshold = 0
        got = out.copy()
        ck.call_variant("np", cubes, sv, mf, got, n, fft)
        st = rt.stats()
    finally:
        rt.shutdown()
    np.testing.assert_allclose(got, out_ref, atol=1e-9)
    assert st["pfor_chunks"]["torch"] == st["tasks"] > 0
    assert st["pfor_chunks"]["np"] == 0


# ---------------------------------------------------------------------------
# tests/test_obs.py's summarize cases, on the port's obs
# ---------------------------------------------------------------------------

@pytest.fixture
def traced():
    """Tracing on with a clean ring; restores the dark default after."""
    was = obs.enabled()
    obs.enable()
    obs.recorder().clear()
    yield obs.recorder()
    obs.recorder().clear()
    if not was:
        obs.disable()


def _synthetic_round(rec):
    """A hand-built pfor round: head phases + one chunk on worker 1."""
    t = 100.0
    rec.name_node(0, "head-node")
    rec.name_track(0, obs.worker_tid(1), "worker1")
    rec.record("plan", "pfor", t, t + 0.01, args={"round": 0})
    rec.record("dispatch", "pfor", t + 0.01, t + 0.02, args={"round": 0})
    rec.record("run", "worker", t + 0.02, t + 0.08,
               tid=obs.worker_tid(1),
               args={"task": 1, "wid": 1, "round": 0, "lo": 0, "hi": 8,
                     "backend": "np"})
    rec.record("chunk_inflight", "pfor", t + 0.015, t + 0.085,
               tid=obs.worker_tid(1),
               args={"round": 0, "task": 1, "lo": 0, "hi": 8,
                     "backend": "np", "wid": 1, "ran": "np"})
    rec.record("gather", "pfor", t + 0.08, t + 0.095, args={"round": 0})
    rec.record("pfor_round", "pfor", t, t + 0.1,
               args={"round": 0, "name": "body", "unit": 0, "chunks": 1,
                     "workers": 1})
    rec.record("parse", "compile", t - 1.0, t - 0.99,
               args={"kernel": "k"})


def test_summarize_reads_exported_trace(tmp_path, traced, capsys):
    _synthetic_round(traced)
    path = str(tmp_path / "trace.json")
    obs.export_chrome_trace(path)
    s = summarize.summarize(summarize.load_events(path))
    assert s["rounds_traced"] == 1
    assert s["workers"]["w1"]["run_spans"] == 1
    assert s["workers"]["w1"]["busy_s"] == pytest.approx(0.06, abs=1e-6)
    assert s["compile"]["k"]["parse"] == pytest.approx(0.01, abs=1e-6)
    [cp] = s["critical_paths"]
    assert cp["gating_chunk"]["wid"] == 1
    assert "% of round wall" in s["dominant"]["statement"]
    # the CLI contract: exit 0, valid --json
    assert summarize.main([path, "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["dominant"]["phase"] in ("plan", "dispatch", "gather",
                                        "split", "ship", "merge")


def test_summarize_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert summarize.main([str(bad)]) == 2
    assert summarize.main([str(tmp_path / "missing.json")]) == 2
