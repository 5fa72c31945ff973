"""The port's continuous-batching LM engine (``repro_torch.serve.engine``)
against the reference's (``repro.serve.engine``), on the CPU.

Both engines serve the same prompts (made with numpy from a seed) with
the reference's weights (``init_params(cfg, jax.random.key(0))``,
carried over with ``transformer.params_from_reference``) at float32:
3 requests arriving one per tick into 2 slots, so the third waits for a
slot and joins a running batch. Greedy tokens must be equal, token for
token. At ``max_seq`` 64 the reference decodes through
``plain_attention``, at 160 through ``chunked_attention``. The reference
runs in a subprocess (``tests/torch_reference.py``). The MoE family
(olmoe, qwen2_moe) is served the same way: every slot's token, the free
slots' too, competes for expert capacity in a decode step, in both
engines. The recurrent families (jamba, xlstm) are not compared with the
reference's engine, whose prefill is wrong for them (ROADMAP Queue 3,
entry 7; ``tests/test_torch_lm_models.py`` holds them to its forward):
a request that reuses a slot must give the tokens it gives in a fresh
engine, so no recurrent state leaks from the slot's earlier request.
Also: the engine's telemetry, its refusal to start on a missing card,
and the launcher and example run on the CPU. The card's case skips
here.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.core.txp import DeviceUnavailable
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import transformer as T
from repro_torch.serve import Request, ServeEngine
from torch_reference import (PARAMS_CODE, reference_params,
                             run_reference)

ROOT = Path(__file__).resolve().parents[1]

# (arch, max_seq, prompt lengths, max_tokens): at 160 gemma2's 32-key
# window bites on the longer prompts
SERVE_CASES = [("gemma2_2b", 64, (5, 11, 8), 8),
               ("stablelm_3b", 64, (5, 11, 8), 8),
               ("gemma2_2b", 160, (40, 70, 25), 10),
               ("stablelm_3b", 160, (40, 70, 25), 10),
               ("olmoe_1b_7b", 64, (5, 11, 8), 8),
               ("qwen2_moe_a2_7b", 64, (5, 11, 8), 8)]
SERVE_IDS = [f"{a}-{m}" for a, m, _, _ in SERVE_CASES]
N_SLOTS = 2

_REFERENCE = PARAMS_CODE + """
import dataclasses, json
import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.models import transformer as RT
from repro.serve.engine import Request as RRequest, ServeEngine as RServe


done = set()
for case in json.loads(str(inputs["spec"])):
    arch, max_seq, n_req, max_tokens, n_slots = case
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32)
    params = jax.jit(lambda key: RT.init_params(cfg, key)[0])(
        jax.random.key(0))
    if arch not in done:
        done.add(arch)
        flat(f"params/{arch}/float32", params)
    eng = RServe(params, cfg, n_slots=n_slots, max_seq=max_seq)
    for i in range(n_req):
        eng.add_request(RRequest(
            f"req-{i}", inputs[f"{arch}/{max_seq}/prompt{i}"],
            max_tokens=max_tokens))
        eng.step()
    for r in eng.run_until_done():
        outputs[f"{arch}/{max_seq}/{r.request_id}"] = np.asarray(
            r.generated, np.int64)
"""


def _port_cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)


def _prompts(arch, max_seq, lens):
    vocab = _port_cfg(arch).vocab
    rng = np.random.default_rng(7 * max_seq + len(arch))
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    import json

    inputs, spec = {}, []
    for arch, max_seq, lens, max_tokens in SERVE_CASES:
        spec.append([arch, max_seq, len(lens), max_tokens, N_SLOTS])
        for i, p in enumerate(_prompts(arch, max_seq, lens)):
            inputs[f"{arch}/{max_seq}/prompt{i}"] = p
    inputs["spec"] = np.asarray(json.dumps(spec))
    return run_reference(_REFERENCE, inputs,
                         tmp_path_factory.mktemp("lm_serve_reference"))


def _serve(params, cfg, prompts, max_seq, max_tokens, device="cpu"):
    """The reference's arrival pattern: one request per tick."""
    eng = ServeEngine(params, cfg, n_slots=N_SLOTS, max_seq=max_seq,
                      device=device)
    for i, p in enumerate(prompts):
        eng.add_request(Request(f"req-{i}", p, max_tokens=max_tokens),
                        tenant=f"tenant-{i % 2}")
        eng.step()
    done = eng.run_until_done()
    return eng, {r.request_id: list(r.generated) for r in done}


@pytest.mark.parametrize("case", SERVE_CASES, ids=SERVE_IDS)
def test_greedy_tokens_equal_the_reference_engine(reference, case):
    arch, max_seq, lens, max_tokens = case
    cfg = _port_cfg(arch)
    params = reference_params(reference, arch, "float32", cfg)
    before = flash_ops.plain_calls
    eng, got = _serve(params, cfg, _prompts(arch, max_seq, lens), max_seq,
                      max_tokens)
    want = {f"req-{i}": list(reference[f"{arch}/{max_seq}/req-{i}"])
            for i in range(len(lens))}
    assert got == want
    # one prefill per request and one batched decode per tick with an
    # active slot, each through every attention layer's flash op
    assert eng.prefills == len(lens)
    assert flash_ops.plain_calls - before >= cfg.layers * len(lens)


def test_engine_telemetry_after_serving(reference):
    arch, max_seq, lens, max_tokens = SERVE_CASES[0]
    cfg = _port_cfg(arch)
    params = reference_params(reference, arch, "float32", cfg)
    eng, got = _serve(params, cfg, _prompts(arch, max_seq, lens), max_seq,
                      max_tokens)
    tel = eng.telemetry()
    assert tel["prefills"] == 3 and tel["finished"] == 3
    assert tel["queued"] == 0 and tel["active"] == 0
    assert tel["tokens_generated"] == sum(len(g) for g in got.values()) \
        == 3 * max_tokens
    for name in ("ttft_ms", "tpot_ms", "e2e_ms"):
        assert tel["latency"][name]["count"] == 3
    assert tel["tenants"]["requests"] == {"tenant-0": 2, "tenant-1": 1}
    assert sum(tel["tenants"]["tokens"].values()) == 3 * max_tokens
    assert eng.slots.utilization() == 0.0


def test_engine_counters_alias_registry():
    eng = ServeEngine.__new__(ServeEngine)   # no model build needed
    eng.ticks = 0
    eng.ticks += 3
    eng.prefills = 2
    prefix = eng._mscope.prefix
    assert prefix.startswith("serveengine")
    assert eng.ticks == 3
    assert obs.metrics.get(f"{prefix}.ticks").value == 3
    assert obs.metrics.get(f"{prefix}.prefills").value == 2


def test_engine_without_a_card_raises_naming_cpu(monkeypatch):
    """On a host without CUDA the default device raises, before any
    cache is allocated, and names ``device='cpu'``; nothing steps down
    to the CPU unseen."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port_cfg("stablelm_3b")
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(DeviceUnavailable, match="device='cpu'"):
        ServeEngine(params, cfg, n_slots=2, max_seq=32)


def test_engine_refuses_params_on_another_device():
    cfg = _port_cfg("stablelm_3b")
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(0))
    params = dict(params, embed=params["embed"].to("meta"))
    with pytest.raises(ValueError, match="params"):
        ServeEngine(params, cfg, n_slots=2, max_seq=32, device="cpu")


def test_engine_admits_into_freed_slots_and_stops_at_max_seq():
    """A request longer than the cache allows stops at max_seq - 1
    (the reference's rule), and the queue drains through freed slots."""
    cfg = _port_cfg("gemma2_2b")
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(2))
    eng = ServeEngine(params, cfg, n_slots=1, max_seq=24, device="cpu")
    rng = np.random.default_rng(0)
    for i, n in enumerate((10, 4, 6)):
        eng.add_request(Request(f"r{i}", rng.integers(0, cfg.vocab, n),
                                max_tokens=50))
    done = {r.request_id: r for r in eng.run_until_done()}
    assert sorted(done) == ["r0", "r1", "r2"]
    for r in done.values():             # stopped at max_seq - 1
        assert len(r.prompt) + len(r.generated) == 23


@pytest.mark.parametrize("arch, n_slots", [("jamba_1_5_large_398b", 1),
                                           ("xlstm_125m", 2)])
def test_reused_slot_gives_the_tokens_of_a_fresh_engine(arch, n_slots):
    """A request admitted into a slot that an earlier request's recurrent
    state (and KV cache) filled generates what it generates alone in a
    fresh engine: the insert overwrites every state leaf of the slot.
    (Jamba on one slot: with more, the MoE capacity couples the slots.)"""
    cfg = _port_cfg(arch)
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(11)
    first = [rng.integers(0, cfg.vocab, n) for n in (9, 6)[:n_slots]]
    late = rng.integers(0, cfg.vocab, 7)

    def serve(prompts):
        eng = ServeEngine(params, cfg, n_slots=n_slots, max_seq=64,
                          device="cpu")
        for i, p in enumerate(prompts):
            eng.add_request(Request(f"r{i}", p, max_tokens=6))
        return {r.request_id: r for r in eng.run_until_done()}

    reused = serve(first + [late])
    alone = serve([late])
    last = reused[f"r{n_slots}"]
    # it waited for a slot, which an earlier request had used
    assert last.first_token_s > min(r.finished_s for r in reused.values()
                                    if r is not last)
    assert last.generated == alone["r0"].generated


def _run(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    return subprocess.run([sys.executable, *args], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)


def test_launcher_serves_the_smoke_model_on_the_cpu():
    out = _run(["-m", "repro_torch.launch.serve", "--smoke", "--device",
                "cpu", "--requests", "4", "--max-tokens", "6"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[serve] stablelm_3b_smoke:" in out.stdout
    assert "'requests': 4" in out.stdout and "'device': 'cpu'" in out.stdout


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "jamba_1_5_large_398b",
                                  "xlstm_125m"])
def test_launcher_serves_the_moe_and_recurrent_families_on_the_cpu(arch):
    out = _run(["-m", "repro_torch.launch.serve", "--arch", arch,
                "--smoke", "--device", "cpu", "--requests", "3",
                "--max-tokens", "4"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"[serve] {arch}_smoke:" in out.stdout
    assert "'requests': 3" in out.stdout


def test_example_serves_on_the_cpu():
    out = _run(["examples/torch_serve_lm.py", "--device", "cpu"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "'requests': 8" in out.stdout


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", SERVE_CASES, ids=SERVE_IDS)
def test_cuda_engine_tokens_equal_the_cpu_engine(cuda_device, case):
    """The engine on the card, every attention layer on the flash kernel
    and no plain call, against the CPU engine that the test above holds
    to the reference (the GPU host has no jax), at float32 on the same
    weights."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    arch, max_seq, lens, max_tokens = case
    cfg = _port_cfg(arch)
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = _prompts(arch, max_seq, lens)
    _, want = _serve(params, cfg, prompts, max_seq, max_tokens)
    card = {k: v.to(cuda_device) for k, v in params.items()
            if k != "blocks"}
    card["blocks"] = [{n: {w: t.to(cuda_device) for w, t in layer.items()}
                       for n, layer in block.items()}
                      for block in params["blocks"]]
    plain, launches = flash_ops.plain_calls, fa.launches
    eng, got = _serve(card, cfg, prompts, max_seq, max_tokens,
                      device=cuda_device)
    assert flash_ops.plain_calls == plain
    assert fa.launches - launches >= cfg.layers * len(lens)
    assert got == want
