"""The port's LM serving with the state on a cluster worker
(``repro_torch.serve.ClusterLMEngine``, whose worker side is
``repro_torch.serve.remote_lm``) on the CPU.

Spawn fleets of two CPU workers (``device="cpu"``) serve small models:
the dense family (stablelm_3b, gemma2_2b) and the hybrid one (Jamba:
Mamba + attention + MoE, whose caches hold Mamba states), float32, with
the reference's weights (``init_params(cfg, jax.random.key(0))``,
carried over with ``transformer.params_from_reference``). Requests
arrive one per tick into 2 slots, as the reference's engine tests send
them, and the state chain is re-anchored every 4 ops, so a run passes
several anchors. The cluster's greedy tokens must equal the port's
``ServeEngine``'s exactly and, for the dense family, the reference's
``ServeEngine``'s. The reference's prefill is wrong for recurrent layers
(ROADMAP Queue 3, entry 7), so Jamba's first token of each request is
held instead to the reference's cache-free ``forward`` of its prompt:
its logit there within ``LOGIT_TOL`` of the largest (its later tokens
are held to the port's engine, which ``tests/test_torch_lm_models.py``
holds to the reference's ``decode_step``). The reference runs in a
subprocess (``tests/torch_reference.py``), which also gives the
reference engine's telemetry keys.

Also: the worker-kill drill before the first anchor (replay from the
boot) and after it (replay from the anchor), ``Resident`` pickling (bit
for bit, bf16 as 2 bytes an element, above the worker's inline limit),
the refusal of a fork-started fleet, and the ticketed front door with
two tenants and an admission rejection.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distrib import ClusterRuntime
from repro_torch.distrib.worker import INLINE_MAX
from repro_torch.models import transformer as T
from repro_torch.serve import (AdmissionController, AdmissionError,
                               ClusterLMEngine, LMTicket, Request,
                               ServeEngine, TenantQuota, remote_lm)
from torch_reference import PARAMS_CODE, reference_params, run_reference

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["stablelm_3b", "gemma2_2b", "jamba_1_5_large_398b"]
RECURRENT = ("jamba_1_5_large_398b",)
N_SLOTS, MAX_SEQ, MAX_TOKENS, TRIM = 2, 64, 8, 4
PROMPT_LENS = (5, 11, 8)
# float32 logits of the two frameworks agree within 1e-4
# (tests/test_torch_lm_models.py)
LOGIT_TOL = 1e-4

# the shape of a telemetry dict: its keys, and those of its latency
# entries, tenant tables and admission
_SHAPE_CODE = """
def shape(tel):
    out = {"keys": sorted(tel)}
    out["latency"] = {k: sorted(v) for k, v in tel["latency"].items()}
    out["tenants"] = sorted(tel["tenants"])
    out["admission"] = sorted(tel.get("admission", {}))
    return out
"""

_REFERENCE = PARAMS_CODE + _SHAPE_CODE + """
import dataclasses, json
import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.models import common as RC
from repro.models import transformer as RT
from repro.serve.admission import AdmissionController as RAdmission
from repro.serve.cluster_engine import ClusterLMEngine as RClusterLM
from repro.serve.engine import Request as RRequest, ServeEngine as RServe

spec = json.loads(str(inputs["spec"]))
for arch in spec["families"]:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32)
    params = jax.jit(lambda key: RT.init_params(cfg, key)[0])(
        jax.random.key(0))
    flat(f"params/{arch}/float32", params)
    prompts = [inputs[f"{arch}/prompt{i}"] for i in range(spec["n_req"])]
    if arch in spec["recurrent"]:
        def last_logits(p, t):
            x = RT.embed_tokens(p, t, cfg)
            x, _ = RT.forward(p, x, cfg, positions=jnp.arange(t.shape[1]))
            x = RC.rmsnorm(x[:, -1:], p["final_ln"], cfg.norm_eps)
            w = p.get("unembed", p["embed"])
            return RC.mask_padded_vocab(jnp.einsum("btd,vd->btv", x, w),
                                        cfg.vocab)[:, 0]

        for i, p in enumerate(prompts):
            outputs[f"{arch}/forward{i}"] = np.asarray(jax.jit(last_logits)(
                params, jnp.asarray(p)[None])[0], np.float64)
        continue
    eng = RServe(params, cfg, n_slots=spec["n_slots"],
                 max_seq=spec["max_seq"])
    for i, p in enumerate(prompts):
        eng.add_request(RRequest(f"req-{i}", p,
                                 max_tokens=spec["max_tokens"]))
        eng.step()
    for r in eng.run_until_done():
        outputs[f"{arch}/{r.request_id}"] = np.asarray(r.generated,
                                                       np.int64)


class _Fleet:
    # the boot is all the reference engine asks of its fleet here
    start_method = "spawn"

    def submit(self, fn, *args):
        return None


eng = RClusterLM(_Fleet(), {}, None, admission=RAdmission())
outputs["telemetry_shape"] = np.asarray(json.dumps(shape(eng.telemetry())))
"""

_shape_ns: dict = {}
exec(_SHAPE_CODE, _shape_ns)
telemetry_shape = _shape_ns["shape"]


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)


def _prompts(arch):
    rng = np.random.default_rng(11 + len(arch))
    return [rng.integers(0, _cfg(arch).vocab, n).astype(np.int32)
            for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    inputs = {"spec": np.asarray(json.dumps({
        "families": FAMILIES, "recurrent": list(RECURRENT),
        "n_req": len(PROMPT_LENS), "n_slots": N_SLOTS, "max_seq": MAX_SEQ,
        "max_tokens": MAX_TOKENS}))}
    for arch in FAMILIES:
        for i, p in enumerate(_prompts(arch)):
            inputs[f"{arch}/prompt{i}"] = p
    return run_reference(_REFERENCE, inputs,
                         tmp_path_factory.mktemp("cluster_lm_reference"))


@pytest.fixture
def fleet():
    rt = ClusterRuntime(workers=2, device="cpu", start_method="spawn",
                        respawn=False)
    try:
        yield rt
    finally:
        rt.shutdown()


def _drive(eng, prompts, on_step=None):
    """The reference's arrival pattern: one request per tick, then ticks
    until every request is done (``on_step`` after each)."""
    for i, p in enumerate(prompts):
        eng.add_request(Request(f"req-{i}", p, max_tokens=MAX_TOKENS),
                        tenant=f"tenant-{i % 2}")
        eng.step()
        if on_step is not None:
            on_step()
    while eng.queue or eng.active:
        eng.step()
        if on_step is not None:
            on_step()
    return {r.request_id: list(r.generated) for r in eng.finished}


def _local(params, cfg, prompts):
    return _drive(ServeEngine(params, cfg, n_slots=N_SLOTS,
                              max_seq=MAX_SEQ, device="cpu"), prompts)


@pytest.mark.parametrize("arch", FAMILIES)
def test_cluster_tokens_equal_both_serve_engines(reference, fleet, arch):
    cfg = _cfg(arch)
    params = reference_params(reference, arch, "float32", cfg)
    prompts = _prompts(arch)
    want = _local(params, cfg, prompts)
    eng = ClusterLMEngine(fleet, params, cfg, n_slots=N_SLOTS,
                          max_seq=MAX_SEQ, trim_every=TRIM)
    longest = [0]
    got = _drive(eng, prompts,
                 lambda: longest.__setitem__(0, max(longest[0],
                                                    len(eng._chain))))
    eng.close()
    assert got == want
    assert eng.anchors >= 2 and longest[0] < TRIM
    assert eng.prefills == len(prompts)
    if arch in RECURRENT:
        for i in range(len(prompts)):
            logits = reference[f"{arch}/forward{i}"]
            first = got[f"req-{i}"][0]
            assert logits.max() - logits[first] <= \
                LOGIT_TOL * max(1.0, abs(logits.max()))
    else:
        assert got == {f"req-{i}": list(reference[f"{arch}/req-{i}"])
                       for i in range(len(prompts))}


def _replayed(rt) -> set:
    return {ev["oid"] for ev in rt.fault_events
            if ev["kind"] == "lineage_replays"}


@pytest.mark.parametrize("when", ["before_anchor", "after_anchor"])
def test_worker_kill_replays_to_the_same_tokens(fleet, when):
    """Kill the state's owner mid-decode: lineage replays the chain from
    its root (the boot, or the last anchor) on the survivor, and the
    token streams do not change."""
    arch = "stablelm_3b"
    cfg = _cfg(arch)
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = _prompts(arch)
    want = _local(params, cfg, prompts)
    trim = 1000 if when == "before_anchor" else TRIM
    eng = ClusterLMEngine(fleet, params, cfg, n_slots=N_SLOTS,
                          max_seq=MAX_SEQ, trim_every=trim)
    killed = {}

    def drill():
        if killed or len(eng._chain) < 2 or not eng.active:
            return
        if (when == "after_anchor") != bool(eng.anchors):
            return
        meta = fleet.plane.meta(eng._state.oid)
        killed.update(root=eng._chain[0].oid, owner=meta.owner,
                      anchors=eng.anchors)
        fleet.kill_worker(meta.owner)

    got = _drive(eng, prompts, drill)
    eng.close()
    assert got == want
    assert killed, "the drill never ran"
    if when == "before_anchor":
        assert killed["anchors"] == 0 and eng.anchors == 0
    else:
        assert killed["anchors"] >= 1
    stats = fleet.stats()
    assert stats["worker_deaths"] == 1 and stats["workers"] == 1
    assert stats["lineage_replays"] >= 2
    # the replay walked back to the chain's root: the boot or the anchor
    assert killed["root"] in _replayed(fleet)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int32, torch.int64])
def test_resident_pickles_bit_for_bit(dtype):
    gen = torch.Generator().manual_seed(3)
    if dtype.is_floating_point:
        x = torch.randn(64, 33, generator=gen).to(dtype)
        x[0, :3] = torch.tensor([float("inf"), -0.0, float("nan")])
    else:
        x = torch.randint(-2**31, 2**31 - 1, (64, 33), generator=gen,
                          dtype=torch.int64).to(dtype)
    res = remote_lm.Resident({"params": {"embed": x},
                              "caches": [{"kv": (x[:4], x[4:9])}]})
    back = pickle.loads(pickle.dumps(res))
    host = back.value["params"]["embed"]
    assert isinstance(host, remote_lm.Bits if dtype == torch.bfloat16
                      else np.ndarray)
    got = remote_lm.tree_torch(back.value, "cpu")
    for a, b in ((got["params"]["embed"], x),
                 (got["caches"][0]["kv"][0], x[:4]),
                 (got["caches"][0]["kv"][1], x[4:9])):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.equal(a.contiguous().view(-1).view(torch.uint8),
                           b.contiguous().view(-1).view(torch.uint8))
    assert isinstance(back.value["caches"][0]["kv"], tuple)


def test_bf16_ships_two_bytes_an_element_above_the_inline_limit():
    x = torch.zeros(1 << 20, dtype=torch.bfloat16)
    res = remote_lm.Resident({"params": {"embed": x}})
    blob = pickle.dumps(res)
    assert 2 * x.numel() <= len(blob) < 2 * x.numel() + 4096
    assert res.nbytes == 2 * x.numel()
    small = remote_lm.Resident({"params": {"embed": x[:8]}})
    assert small.nbytes == remote_lm._RESIDENT_FLOOR > INLINE_MAX


def test_a_consumed_state_refuses_a_second_op(monkeypatch):
    """The caches are written in place: a state an op consumed (or one a
    failed op left half written) is not served again."""
    cfg = _cfg("stablelm_3b")
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(0))
    monkeypatch.setattr(remote_lm.api, "_DEVICE", "cpu")
    boot = remote_lm.lm_boot(remote_lm.tree_np(params), cfg, N_SLOTS,
                             MAX_SEQ)
    one = remote_lm.lm_prefill(boot, np.arange(5, dtype=np.int32), 0)
    with pytest.raises(remote_lm.SupersededState):
        remote_lm.lm_prefill(boot, np.arange(5, dtype=np.int32), 1)
    two = remote_lm.lm_decode(one, np.zeros((N_SLOTS, 1), np.int32))
    assert (one.seq, two.seq) == (1, 2)
    # a copy of the newest state is served; a copy of an older one not
    again = pickle.loads(pickle.dumps(two))
    remote_lm.lm_decode(again, np.zeros((N_SLOTS, 1), np.int32))
    stale = pickle.loads(pickle.dumps(one))
    with pytest.raises(remote_lm.SupersededState):
        remote_lm.lm_decode(stale, np.zeros((N_SLOTS, 1), np.int32))


def test_a_fork_started_fleet_is_refused():
    # the engine reads the fleet's start method before anything else (a
    # real fork fleet would fork this multi-threaded test process)
    fleet = types.SimpleNamespace(start_method="fork")
    with pytest.raises(ValueError, match="spawn"):
        ClusterLMEngine(fleet, {}, _cfg("stablelm_3b"))


def test_tickets_from_two_tenants_with_a_rejection(reference, fleet):
    arch = "stablelm_3b"
    cfg = _cfg(arch)
    params = reference_params(reference, arch, "float32", cfg)
    prompts = _prompts(arch)
    want = _local(params, cfg, prompts)
    adm = AdmissionController(
        {"tenant-b": TenantQuota(rate_per_s=1e-6, burst=1)})
    eng = ClusterLMEngine(fleet, params, cfg, n_slots=N_SLOTS,
                          max_seq=MAX_SEQ, trim_every=TRIM, admission=adm)
    tenants = ("tenant-a", "tenant-b", "tenant-a")
    tickets = [eng.submit(t, p, max_tokens=MAX_TOKENS,
                          request_id=f"req-{i}")
               for i, (t, p) in enumerate(zip(tenants, prompts))]
    with pytest.raises(AdmissionError) as exc:
        eng.submit("tenant-b", prompts[0], max_tokens=MAX_TOKENS,
                   request_id="req-3")
    assert exc.value.reason == "rate"
    assert all(isinstance(t, LMTicket) for t in tickets)
    got = {t.request.request_id: t.wait(120.0) for t in tickets}
    tel = eng.telemetry()
    eng.close()
    assert got == want
    assert all(t.done() and t.finished_s >= t.started_s for t in tickets)
    assert tel["tenants"]["requests"] == {"tenant-a": 2, "tenant-b": 1}
    assert tel["tenants"]["rejections"] == {"tenant-b": 1}
    assert tel["tenants"]["tokens"] == {"tenant-a": 2 * MAX_TOKENS,
                                        "tenant-b": MAX_TOKENS}
    assert tel["admission"]["rejected"] == {"tenant-b": {"rate": 1}}
    assert tel["latency"]["ttft_ms"]["count"] == 3
    assert telemetry_shape(tel) == json.loads(
        str(reference["telemetry_shape"]))


@pytest.mark.parametrize("wrapped", [False, True])
@pytest.mark.parametrize("nbytes", [0, 100, 1 << 16, (1 << 22) + 7])
def test_transport_recv_reads_what_connection_recv_reads(nbytes, wrapped):
    """The one-buffer reader (``distrib.transport.recv``) takes the
    messages ``Connection.send`` frames, of every size class, directly
    and through the chaos wrapper the head puts on a worker's pipe;
    it reports each message's size before reading its body, and raises
    EOFError once the peer is gone."""
    import multiprocessing as mp

    from repro_torch.distrib import ChaosPlan, ChaosWire
    from repro_torch.distrib.transport import recv

    a, b = mp.Pipe()
    msg = ("obj", 7, ("v", np.arange(nbytes // 8, dtype=np.int64)),
           b"x" * (nbytes % 8))
    # past the pipe's buffer the send waits for the reader
    sender = threading.Thread(target=a.send, args=(msg,))
    sender.start()
    starts = []
    if wrapped:
        wire = ChaosWire(b, ChaosPlan())
        got = wire.recv()
    else:
        got = recv(b, starts.append)
    sender.join()
    assert got[:2] == msg[:2] and got[3] == msg[3]
    assert np.array_equal(got[2][1], msg[2][1])
    if not wrapped:
        assert len(starts) == 1 and starts[0] > nbytes
    a.close()
    with pytest.raises(EOFError):
        recv(b)
    b.close()


def _payload(n):
    return np.arange(n, dtype=np.float64)


def test_a_dropped_get_is_asked_again(monkeypatch):
    """The head's request for a worker-resident object ('get') is asked
    again when, ``FETCH_RETRY_S`` after it, nothing from the owner is
    arriving: under a plan that drops the first 'get', a pfor and a
    plain ``get`` both return."""
    from benchmarks.stap import gemm_rowscale
    from repro_torch.core.compiler import compile_kernel
    from repro_torch.distrib import ChaosPlan
    from repro_torch.distrib import cluster

    monkeypatch.setattr(cluster, "FETCH_RETRY_S", 0.5)
    plan = ChaosPlan(seed=5, drop_p=1.0, drop_kinds=("get",), max_drops=1)
    rt = ClusterRuntime(workers=2, device="cpu", start_method="spawn",
                        chaos=plan)
    try:
        rng = np.random.default_rng(4)
        n, k, m = 64, 8, 96
        A, B = rng.normal(size=(n, k)), rng.normal(size=(k, m))
        ck = compile_kernel(gemm_rowscale, runtime=rt, workers=2)
        ck.pfor_config.distribute_threshold = 0
        C = np.zeros((n, m))
        ck.call_variant("np", A, B, C, n, k, m)
        np.testing.assert_allclose(C, (2.0 * A) @ B, atol=1e-8, rtol=0)
        # past the inline limit the result stays on its worker
        size = 4 * INLINE_MAX // 8
        ref = rt.submit(_payload, size)
        assert np.array_equal(rt.get(ref, timeout=60.0), _payload(size))
        assert plan.dropped == 1
    finally:
        rt.shutdown()


def test_example_serves_from_a_cpu_fleet():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "examples/torch_serve_lm.py",
                          "--cluster", "2", "--device", "cpu"],
                         cwd=str(ROOT), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "cluster decode on cpu matches the single-process engine" \
        in out.stdout


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_fleet_tokens_equal_the_head_engine(cuda_device):
    """A CUDA fleet's workers serve on the card, every attention call on
    the flash kernel, the same tokens as the head's engine there."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    arch = "stablelm_3b"
    cfg = _cfg(arch)
    params, _ = T.init_params(cfg, torch.Generator(
        device=cuda_device).manual_seed(0))
    prompts = _prompts(arch)
    launches = fa.launches
    want = _drive(ServeEngine(params, cfg, n_slots=N_SLOTS,
                              max_seq=MAX_SEQ, device=cuda_device), prompts)
    assert fa.launches > launches
    rt = ClusterRuntime(workers=2, device="cuda", start_method="spawn")
    try:
        eng = ClusterLMEngine(rt, params, cfg, n_slots=N_SLOTS,
                              max_seq=MAX_SEQ, trim_every=TRIM)
        got = _drive(eng, prompts)
        eng.close()
    finally:
        rt.shutdown()
    assert got == want and eng.anchors >= 2
