"""The port's LM (``repro_torch.models``) against the reference's
(``repro.models``), at small sizes on the CPU: the dense family, the MoE
family (olmoe, qwen2_moe) and the recurrent ones (jamba: Mamba +
attention + MoE; xlstm: mLSTM + sLSTM).

Inputs are made with numpy from a seed and handed to both packages; the
weights are the reference's own ``init_params(cfg, jax.random.key(0))``,
carried over with ``transformer.params_from_reference``. The reference
runs its default attention path (``use_pallas=False``: ``plain_attention``
up to ``2 * attn_chunk`` keys, ``chunked_attention`` beyond), in one
subprocess per module (``tests/torch_reference.py``). The port's
``attention`` runs the flash op, whose CPU path is the kernel's plain
version.

Tolerances: the primitive layers at float32 1e-6; attention at float32
1e-5; prefill and decode logits at float32 1e-4 (absolute and relative).
At bfloat16 the two frameworks round at other places (XLA fuses
elementwise chains in float32, the flash op casts its unnormalised
probabilities to bf16 where ``plain_attention`` casts normalised ones),
so logits are compared at ``BF16_LOGIT_TOL`` of the largest logit's
magnitude, a few bf16 ulps of it. The CUDA cases need a card and skip
here.

The MoE models are held to the reference's ``prefill`` and
``decode_step``. The recurrent ones are not: the reference's prefill
takes each recurrent mixer's single-token branch over the whole prompt
(ROADMAP Queue 3, entry 7). Their prefill logits are held to the
reference's cache-free ``forward`` of the prompt (the same tokens, so
the same MoE capacity), and their decode logits to the reference's
``decode_step`` run on the port's caches after prefill, carried back to
the reference's layout (a second subprocess).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine
from torch_reference import (PARAMS_CODE, reference_params,
                             run_reference)

# (arch, dtype, max_seq): max_seq 64 takes the reference's plain path
# (64 <= 2 * attn_chunk), 160 its chunked one; the prompts' lengths
# (below) let gemma2's 32-key window bite at 160
MODEL_CASES = [(arch, dtype, max_seq)
               for arch in ("gemma2_2b", "stablelm_3b")
               for dtype in ("float32", "bfloat16")
               for max_seq in (64, 160)]
# qkv bias (qwen) and the non-gated squared ReLU (nemotron); the MoE
# family (olmoe: 8 experts padded to 16; qwen2_moe: a shared expert)
MODEL_CASES += [("qwen1_5_110b", "float32", 64),
                ("nemotron_4_340b", "float32", 64),
                ("olmoe_1b_7b", "float32", 64),
                ("qwen2_moe_a2_7b", "float32", 64)]
MODEL_IDS = [f"{a}-{d}-{m}" for a, d, m in MODEL_CASES]
# the recurrent families, held to the reference's forward (prefill) and
# to its decode_step on the port's caches
RECURRENT_CASES = [("jamba_1_5_large_398b", "float32", 64),
                   ("xlstm_125m", "float32", 64)]
RECURRENT_IDS = [f"{a}-{d}-{m}" for a, d, m in RECURRENT_CASES]
PROMPT_LENS = {64: (7, 13), 160: (41, 90)}
DECODE_STEPS = 6
BF16_LOGIT_TOL = 0.03
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (id, (B, Sq, Skv, H, KVH, D), causal, window, softcap, q_offset)
ATTN_CASES = [
    ("prefill", (2, 20, 48, 4, 2, 16), True, 0, 0.0, 0),
    ("prefill-window-cap", (2, 20, 48, 4, 1, 16), True, 8, 30.0, 0),
    ("decode-per-slot", (3, 1, 48, 4, 2, 16), True, 0, 0.0, [5, 30, 47]),
    ("decode-per-slot-window-cap", (3, 1, 48, 4, 2, 16), True, 8, 50.0,
     [5, 30, 47]),
    ("chunk-int-offset", (2, 6, 48, 2, 2, 16), True, 12, 0.0, 17),
    ("noncausal", (1, 9, 48, 4, 4, 8), False, 0, 20.0, 0),
]
ATTN_IDS = [c[0] for c in ATTN_CASES]
MLP_ACTS = ("gelu", "silu", "sqrelu", "relu")

_REFERENCE = PARAMS_CODE + """
import dataclasses, json
import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.models import common as RC
from repro.models import transformer as RT
from repro.serve.engine import ServeEngine as RServe

spec = json.loads(str(inputs["spec"]))
DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def f64(a):
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


x, scale = (jnp.asarray(inputs["rms/" + n], jnp.float32) for n in ("x", "s"))
outputs["rms/out"] = f64(RC.rmsnorm(x, scale, 1e-6))
x = jnp.asarray(inputs["rope/x"], jnp.float32)
for n in ("pos1", "pos2"):
    outputs["rope/" + n] = f64(RC.rope(x, jnp.asarray(inputs["rope/" + n]),
                                       10000.0))
for act in spec["mlp_acts"]:
    cfg = RC.ArchConfig(name="t", family="dense", d_model=32, d_ff=48,
                        mlp_act=act, dtype=jnp.float32)
    p = {n: jnp.asarray(inputs[f"mlp/{act}/{n}"], jnp.float32)
         for n in ("wi", "wg", "wo", "ln") if f"mlp/{act}/{n}" in inputs}
    outputs[f"mlp/{act}/out"] = f64(RC.apply_mlp(
        p, jnp.asarray(inputs["mlp/x"], jnp.float32), cfg))
for cid, causal, window, cap in spec["attn"]:
    q, k, v = (jnp.asarray(inputs[f"attn/{cid}/{n}"], jnp.float32)
               for n in "qkv")
    off = inputs[f"attn/{cid}/offset"]
    off = int(off) if off.ndim == 0 else jnp.asarray(off)
    outputs[f"attn/{cid}/plain"] = f64(RC.plain_attention(
        q, k, v, causal=causal, window=window, cap=cap, q_offset=off))
    outputs[f"attn/{cid}/chunked"] = f64(RC.chunked_attention(
        q, k, v, causal=causal, window=window, cap=cap, chunk=8,
        q_offset=off))
done = set()
for arch, dtype, max_seq in spec["models"]:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=DT[dtype])
    params = jax.jit(lambda key: RT.init_params(cfg, key)[0])(
        jax.random.key(0))
    if (arch, dtype) not in done:
        done.add((arch, dtype))
        flat(f"params/{arch}/{dtype}", params)
    key = f"model/{arch}/{dtype}/{max_seq}"
    prefill = jax.jit(lambda p, t: RT.prefill(p, {"tokens": t}, cfg,
                                              max_seq))
    decode = jax.jit(lambda p, t, c: RT.decode_step(p, t, c, cfg))
    caches = RT.init_caches(cfg, 2, max_seq)
    for slot in (0, 1):
        one, logits = prefill(
            params, jnp.asarray(inputs[f"{key}/p{slot}"])[None])
        outputs[f"{key}/prefill{slot}"] = f64(logits)
        caches = RServe._insert_impl(caches, one, jnp.int32(slot))
    steps = []
    toks = jnp.asarray(inputs[f"{key}/decode"])
    for t in range(toks.shape[1]):
        logits, caches = decode(params, toks[:, t:t + 1], caches)
        steps.append(f64(logits))
    outputs[f"{key}/decode"] = np.stack(steps)
for arch, dtype, max_seq in spec["recurrent"]:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=DT[dtype])
    params = jax.jit(lambda key: RT.init_params(cfg, key)[0])(
        jax.random.key(0))
    flat(f"params/{arch}/{dtype}", params)
    key = f"recurrent/{arch}/{dtype}/{max_seq}"

    def last_logits(p, t):
        x = RT.embed_tokens(p, t, cfg)
        x, _ = RT.forward(p, x, cfg, positions=jnp.arange(t.shape[1]))
        x = RC.rmsnorm(x[:, -1:], p["final_ln"], cfg.norm_eps)
        w = p.get("unembed", p["embed"])
        return RC.mask_padded_vocab(jnp.einsum("btd,vd->btv", x, w),
                                    cfg.vocab)[:, 0]

    for slot in (0, 1):
        outputs[f"{key}/forward{slot}"] = f64(jax.jit(last_logits)(
            params, jnp.asarray(inputs[f"{key}/p{slot}"])[None]))
"""

# the reference's decode steps from the port's caches after prefill
_REFERENCE_DECODE = """
import dataclasses, json
import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.models import transformer as RT

DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
for arch, dtype, max_seq in json.loads(str(inputs["spec"])):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=DT[dtype])
    params = jax.jit(lambda key: RT.init_params(cfg, key)[0])(
        jax.random.key(0))
    key = f"recurrent/{arch}/{dtype}/{max_seq}"
    caches = []
    for i in range(cfg.period):
        pre = f"{key}/cache/{i}/"
        leaves = {k[len(pre):]: v for k, v in inputs.items()
                  if k.startswith(pre)}
        if cfg.layer_kind(i) == "attn":
            caches.append({"kv": {
                "k": jnp.asarray(leaves["k"], cfg.dtype),
                "v": jnp.asarray(leaves["v"], cfg.dtype),
                "index": jnp.asarray(leaves["index"], jnp.int32)}})
        else:
            caches.append({"ssm": {n: jnp.asarray(v, jnp.float32)
                                   for n, v in leaves.items()}})
    decode = jax.jit(lambda p, t, c: RT.decode_step(p, t, c, cfg))
    toks = inputs[f"{key}/decode"]
    steps = []
    for t in range(toks.shape[1]):
        logits, caches = decode(params, jnp.asarray(toks[:, t:t + 1]),
                                caches)
        steps.append(np.asarray(jnp.asarray(logits, jnp.float32),
                                np.float64))
    outputs[f"{key}/decode"] = np.stack(steps)
"""


def _model_key(arch, dtype, max_seq):
    return f"model/{arch}/{dtype}/{max_seq}"


def _recurrent_key(arch, dtype, max_seq):
    return f"recurrent/{arch}/{dtype}/{max_seq}"


def _model_inputs(arch, max_seq):
    """(prompt 0, prompt 1, decode tokens (2, DECODE_STEPS))."""
    vocab = get_smoke_config(arch).vocab
    rng = np.random.default_rng(max_seq + len(arch))
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in PROMPT_LENS[max_seq]]
    return (*prompts,
            rng.integers(0, vocab, (2, DECODE_STEPS)).astype(np.int32))


def _attn_inputs(case):
    _, (b, sq, skv, h, kvh, d), *_ = case
    rng = np.random.default_rng(sq * 31 + skv + h)
    return (rng.normal(size=(b, sq, h, d)), rng.normal(size=(b, skv, kvh, d)),
            rng.normal(size=(b, skv, kvh, d)))


def _layer_inputs():
    rng = np.random.default_rng(3)
    out = {"rms/x": rng.normal(size=(2, 5, 64)),
           "rms/s": 0.1 * rng.normal(size=(64,)),
           "rope/x": rng.normal(size=(2, 7, 4, 16)),
           "rope/pos1": np.arange(7, dtype=np.int32),
           "rope/pos2": (np.array([[3], [250]]) + np.arange(7)).astype(
               np.int32),
           "mlp/x": rng.normal(size=(2, 5, 32))}
    for act in MLP_ACTS:
        names = ("wi", "wg", "wo") if act in ("gelu", "silu") \
            else ("wi", "wo")
        for n in names:
            shape = (48, 32) if n == "wo" else (32, 48)
            out[f"mlp/{act}/{n}"] = rng.normal(size=shape) / np.sqrt(
                shape[0])
        out[f"mlp/{act}/ln"] = 0.1 * rng.normal(size=(32,))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    inputs = _layer_inputs()
    spec = {"mlp_acts": list(MLP_ACTS), "attn": [], "models": [],
            "recurrent": []}
    for case in ATTN_CASES:
        cid, _, causal, window, cap, off = case
        spec["attn"].append([cid, causal, window, cap])
        for n, a in zip("qkv", _attn_inputs(case)):
            inputs[f"attn/{cid}/{n}"] = a
        inputs[f"attn/{cid}/offset"] = np.asarray(off, np.int32)
    for arch, dtype, max_seq in MODEL_CASES:
        spec["models"].append([arch, dtype, max_seq])
        key = _model_key(arch, dtype, max_seq)
        p0, p1, dec = _model_inputs(arch, max_seq)
        inputs.update({f"{key}/p0": p0, f"{key}/p1": p1,
                       f"{key}/decode": dec})
    for arch, dtype, max_seq in RECURRENT_CASES:
        spec["recurrent"].append([arch, dtype, max_seq])
        key = _recurrent_key(arch, dtype, max_seq)
        p0, p1, _ = _model_inputs(arch, max_seq)
        inputs.update({f"{key}/p0": p0, f"{key}/p1": p1})
    inputs["spec"] = np.asarray(json.dumps(spec))
    return run_reference(_REFERENCE, inputs,
                         tmp_path_factory.mktemp("lm_models_reference"))


def _flat_caches(caches, prefix):
    """The port's caches as numpy leaves under ``prefix/<i>/<name>``."""
    out = {}
    for i, c in enumerate(caches):
        for leaves in c.values():
            for name, t in leaves.items():
                t = t.cpu()
                out[f"{prefix}/{i}/{name}"] = (
                    t.float() if t.is_floating_point() else t).numpy()
    return out


@pytest.fixture(scope="module")
def recurrent_decode(reference, tmp_path_factory):
    """The reference's decode logits from the port's caches after the
    prefill of both prompts (``_port_prefill``)."""
    inputs, spec = {}, []
    for arch, dtype, max_seq in RECURRENT_CASES:
        spec.append([arch, dtype, max_seq])
        cfg = _port_cfg(arch, dtype)
        params = reference_params(reference, arch, dtype, cfg)
        key = _recurrent_key(arch, dtype, max_seq)
        p0, p1, dec = _model_inputs(arch, max_seq)
        _, caches = _port_prefill(params, cfg, (p0, p1), max_seq)
        inputs.update(_flat_caches(caches, f"{key}/cache"))
        inputs[f"{key}/decode"] = dec
    inputs["spec"] = np.asarray(json.dumps(spec))
    return run_reference(_REFERENCE_DECODE, inputs,
                         tmp_path_factory.mktemp("lm_recurrent_decode"))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol, err_msg=what)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------

def test_rmsnorm_matches_reference(reference):
    li = _layer_inputs()
    got = C.rmsnorm(_t(li["rms/x"]), _t(li["rms/s"]), 1e-6)
    _close(got.numpy(), reference["rms/out"], 1e-6, "rmsnorm")


@pytest.mark.parametrize("pos", ["pos1", "pos2"])
def test_rope_matches_reference(reference, pos):
    """Positions shared by the batch (S,) and per batch row (B, S)."""
    li = _layer_inputs()
    got = C.rope(_t(li["rope/x"]), torch.from_numpy(li["rope/" + pos]),
                 10000.0)
    _close(got.numpy(), reference["rope/" + pos], 1e-6, pos)


@pytest.mark.parametrize("act", MLP_ACTS)
def test_mlp_matches_reference(reference, act):
    """The gated MLP (gelu as jax's tanh approximation, silu) and the
    plain one (squared ReLU, ReLU)."""
    li = _layer_inputs()
    cfg = C.ArchConfig(name="t", family="dense", d_model=32, d_ff=48,
                       mlp_act=act, dtype=torch.float32)
    p = {n: _t(li[f"mlp/{act}/{n}"]) for n in ("wi", "wg", "wo", "ln")
         if f"mlp/{act}/{n}" in li}
    got = C.apply_mlp(p, _t(li["mlp/x"]), cfg)
    _close(got.numpy(), reference[f"mlp/{act}/out"], 1e-6, act)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["plain", "chunked"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=ATTN_IDS)
def test_attention_matches_reference_paths(reference, case, path):
    """The port's ``attention`` (the flash op) against the reference's
    ``plain_attention`` and ``chunked_attention`` (8-key chunks), with an
    int and a per-slot ``q_offset``, GQA, window and softcap."""
    cid, (b, sq, skv, h, kvh, d), causal, window, cap, off = case
    cfg = C.ArchConfig(name="t", family="dense", attn_softcap=cap,
                       dtype=torch.float32)
    q, k, v = (_t(a) for a in _attn_inputs(case))
    offset = off if isinstance(off, int) else torch.tensor(
        off, dtype=torch.int32)
    got = C.attention(q, k, v, cfg, causal=causal, window=window,
                      q_offset=offset)
    assert tuple(got.shape) == (b, sq, h, d)
    _close(got.numpy(), reference[f"attn/{cid}/{path}"], 1e-5, cid)


# ---------------------------------------------------------------------------
# the model: params, prefill, decode
# ---------------------------------------------------------------------------

def _port_cfg(arch, dtype):
    return dataclasses.replace(get_smoke_config(arch),
                               dtype=TORCH_DT[dtype])


@pytest.mark.parametrize("arch", ["gemma2_2b", "stablelm_3b",
                                  "qwen1_5_110b", "nemotron_4_340b",
                                  "olmoe_1b_7b", "qwen2_moe_a2_7b",
                                  "jamba_1_5_large_398b", "xlstm_125m"])
def test_init_params_has_the_reference_layout(reference, arch):
    """Same tree, shapes and dtype as the reference's init (the values
    come from another generator)."""
    cfg = _port_cfg(arch, "float32")
    mine, specs = T.init_params(cfg, torch.Generator().manual_seed(0))
    theirs = reference_params(reference, arch, "float32", cfg)

    def walk(a, b, s, path):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b) == sorted(s), path
            for k in a:
                walk(a[k], b[k], s[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b) == len(s), path
            for i, (x, y, z) in enumerate(zip(a, b, s)):
                walk(x, y, z, f"{path}/{i}")
        else:
            assert a.shape == b.shape and a.dtype == b.dtype, path
            assert len(s) == a.dim(), path

    walk(mine, theirs, specs, arch)


def test_params_from_reference_keeps_bf16_values_exactly(reference):
    cfg = _port_cfg("gemma2_2b", "bfloat16")
    params = reference_params(reference, "gemma2_2b", "bfloat16", cfg)
    wq = params["blocks"][0]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    want = reference["params/gemma2_2b/bfloat16/blocks/0/attn/wq"]
    assert np.array_equal(wq.float().numpy(), want)


def _port_prefill(params, cfg, prompts, max_seq):
    """Two prompts prefilled alone and inserted into a 2-slot cache:
    (each prompt's last-token logits, the caches)."""
    dev = params["embed"].device
    caches = T.init_caches(cfg, 2, max_seq, device=dev)
    prefills = []
    with torch.inference_mode():
        for slot, prompt in enumerate(prompts):
            one, logits = T.prefill(
                params, {"tokens": torch.from_numpy(prompt).to(dev)[None]},
                cfg, max_seq)
            prefills.append(logits.float().cpu().numpy())
            ServeEngine._insert(caches, one, slot)
    return prefills, caches


def _port_decode(params, cfg, caches, dec):
    """Decode steps of the tokens ``dec`` (2, steps) from ``caches``,
    both slots at their own positions: the logits of each step."""
    dec = torch.from_numpy(dec).to(params["embed"].device)
    steps = []
    with torch.inference_mode():
        for t in range(dec.shape[1]):
            logits, caches = T.decode_step(params, dec[:, t:t + 1], caches,
                                           cfg)
            steps.append(logits.float().cpu().numpy())
    return np.stack(steps), caches


def _port_model_run(params, cfg, key_inputs, max_seq):
    """The reference subprocess's steps on the port: two prompts
    prefilled alone and inserted into a 2-slot cache, then decode steps
    with both slots at their own positions."""
    p0, p1, dec = key_inputs
    prefills, caches = _port_prefill(params, cfg, (p0, p1), max_seq)
    steps, caches = _port_decode(params, cfg, caches, dec)
    return prefills, steps, caches


@pytest.mark.parametrize("case", MODEL_CASES, ids=MODEL_IDS)
def test_prefill_and_decode_logits_match_reference(reference, case):
    arch, dtype, max_seq = case
    cfg = _port_cfg(arch, dtype)
    params = reference_params(reference, arch, dtype, cfg)
    key = _model_key(arch, dtype, max_seq)
    prefills, steps, caches = _port_model_run(
        params, cfg, _model_inputs(arch, max_seq), max_seq)
    want_steps = reference[f"{key}/decode"]
    if dtype == "float32":
        tol = 1e-4
    else:
        real = want_steps[..., :cfg.vocab]
        tol = BF16_LOGIT_TOL * float(np.abs(real).max())
    for slot in (0, 1):
        _close(prefills[slot], reference[f"{key}/prefill{slot}"], tol,
               f"{key} prefill {slot}")
    _close(steps, want_steps, tol, f"{key} decode")
    # every layer's index advanced past both prompts and the steps
    lens = np.array(PROMPT_LENS[max_seq]) + DECODE_STEPS
    for c in caches:
        assert (c["kv"]["index"].cpu().numpy() == lens).all()


@pytest.mark.parametrize("case", RECURRENT_CASES, ids=RECURRENT_IDS)
def test_recurrent_prefill_matches_forward_and_decode_matches_reference(
        reference, recurrent_decode, case):
    """Prefill logits against the reference's cache-free forward of each
    prompt; decode logits (6 steps, 2 slots at their own positions)
    against the reference's decode_step from the port's caches after
    prefill; f32 at 1e-4."""
    arch, dtype, max_seq = case
    cfg = _port_cfg(arch, dtype)
    params = reference_params(reference, arch, dtype, cfg)
    key = _recurrent_key(arch, dtype, max_seq)
    p0, p1, dec = _model_inputs(arch, max_seq)
    prefills, caches = _port_prefill(params, cfg, (p0, p1), max_seq)
    for slot in (0, 1):
        _close(prefills[slot], reference[f"{key}/forward{slot}"], 1e-4,
               f"{key} prefill {slot} against forward")
    steps, caches = _port_decode(params, cfg, caches, dec)
    _close(steps, recurrent_decode[f"{key}/decode"], 1e-4, f"{key} decode")
    lens = np.array(PROMPT_LENS[max_seq]) + DECODE_STEPS
    for c in caches:
        if "kv" in c:
            assert (c["kv"]["index"].cpu().numpy() == lens).all()


def test_init_params_keeps_the_reference_float32_leaves():
    """At bf16 the router and Mamba's dt_bias, a_log and d_skip stay in
    float32, in the port's init and in the reference's carried over."""
    cfg = _port_cfg("jamba_1_5_large_398b", "bfloat16")
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(0))
    mamba, moe = params["blocks"][0]["mamba"], params["blocks"][1]["moe"]
    for leaf in (mamba["dt_bias"], mamba["a_log"], mamba["d_skip"],
                 moe["router"]):
        assert leaf.dtype == torch.float32
    assert mamba["in_proj"].dtype == moe["wi"].dtype == torch.bfloat16
    tree = {"router": np.ones((4, 16), np.float32),
            "wi": np.ones((16, 4, 8), np.float32)}
    got = T.params_from_reference(tree, cfg, "cpu")
    assert got["router"].dtype == torch.float32
    assert got["wi"].dtype == torch.bfloat16


def test_shared_experts_are_one_set_of_tensors():
    """``share_experts``: every MoE layer of a period holds its first
    MoE layer's routed experts, the same tensors; routers stay apart."""
    cfg = _port_cfg("jamba_1_5_large_398b", "float32")
    params, specs = T.init_params(cfg, torch.Generator().manual_seed(0),
                                  share_experts=True)
    moes = [b["moe"] for b in params["blocks"] if "moe" in b]
    assert len(moes) == 2
    for w in ("wi", "wg", "wo"):
        assert moes[0][w] is moes[1][w]
    assert not torch.equal(moes[0]["router"], moes[1]["router"])
    own, _ = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert sorted(own["blocks"][3]["moe"]) == sorted(moes[1])
    assert sorted(specs["blocks"][3]["moe"]) == sorted(moes[1])


def test_uniform_index_cache_writes_at_the_shared_position():
    """The reference's scalar-index cache (steady-state decode) writes
    each step at the one position, clamped to fit, and attends with that
    offset: the same logits as per-slot indices holding equal values."""
    cfg = _port_cfg("gemma2_2b", "float32")
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 9)).astype(np.int64))
    out = []
    for uniform in (True, False):
        caches = T.init_caches(cfg, 2, 32, uniform_index=uniform)
        logits = []
        for t in range(9):
            lg, caches = T.decode_step(params, tokens[:, t:t + 1], caches,
                                       cfg)
            logits.append(lg.numpy())
        out.append(np.stack(logits))
    _close(out[0], out[1], 1e-6, "uniform vs per-slot")


@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b", "olmoe_1b_7b",
                                  "xlstm_125m", "seamless_m4t_medium",
                                  "llava_next_mistral_7b"])
def test_families_not_ported_raise_naming_the_roadmap(arch):
    """Every family is ported now: the MoE, hybrid and ssm ones and the
    audio (encoder-decoder) and vlm (embeddings input) ones load, full
    and smoke, and none raises any more."""
    family = {"jamba_1_5_large_398b": "hybrid", "olmoe_1b_7b": "moe",
              "xlstm_125m": "ssm", "seamless_m4t_medium": "audio",
              "llava_next_mistral_7b": "vlm"}[arch]
    for get in (get_config, get_smoke_config):
        assert get(arch).family == family


def test_model_refuses_a_hybrid_config():
    """A hybrid (attention + Mamba) config builds; so does one that is
    also encoder-decoder (no longer refused): cross attention in each
    decoder layer, an encoder stack and its final norm."""
    cfg = C.ArchConfig(name="hybrid", family="hybrid", layers=2, period=2,
                       d_model=32, n_heads=2, kv_heads=2, d_ff=64, vocab=64,
                       dtype=torch.float32)
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert "mamba" in params["blocks"][1]
    cfg = dataclasses.replace(cfg, is_encdec=True, enc_layers=1)
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert "cross" in params["blocks"][1] and "enc_final_ln" in params
    assert params["encoder"]["attn"]["wq"].shape[0] == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", MODEL_CASES, ids=MODEL_IDS)
def test_cuda_prefill_and_decode_logits_match_the_cpu(cuda_device, case):
    """The same steps with every attention layer on the flash kernel,
    against the CPU path that the tests above hold to the reference (the
    GPU host has no jax): the same weights, drawn on the CPU."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    arch, dtype, max_seq = case
    cfg = _port_cfg(arch, dtype)
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(0))
    inputs = _model_inputs(arch, max_seq)
    cpu_pre, cpu_steps, _ = _port_model_run(params, cfg, inputs, max_seq)
    card = _to(params, cuda_device)
    before = fa.launches
    pre, steps, _ = _port_model_run(card, cfg, inputs, max_seq)
    assert fa.launches - before == cfg.layers * (2 + DECODE_STEPS)
    tol = 1e-4 if dtype == "float32" else BF16_LOGIT_TOL * float(
        np.abs(cpu_steps[..., :cfg.vocab]).max())
    for slot in (0, 1):
        _close(pre[slot], cpu_pre[slot], tol, f"{case} prefill {slot}")
    _close(steps, cpu_steps, tol, f"{case} decode on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("case", RECURRENT_CASES, ids=RECURRENT_IDS)
def test_cuda_recurrent_prefill_and_decode_match_the_cpu(cuda_device,
                                                         case):
    """The recurrent families on the card, every Mamba prefill on the
    scan kernel and every attention layer on the flash kernel, against
    the CPU path that the test above holds to the reference."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.mamba_scan import mamba_scan as sc
    from repro_torch.kernels.mamba_scan import ops as scan_ops

    arch, dtype, max_seq = case
    cfg = _port_cfg(arch, dtype)
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(0))
    inputs = _model_inputs(arch, max_seq)
    cpu_pre, cpu_steps, _ = _port_model_run(params, cfg, inputs, max_seq)
    card = _to(params, cuda_device)
    kinds = [cfg.layer_kind(i) for i in range(cfg.period)]
    flash0, scan0, plain0 = fa.launches, sc.launches, scan_ops.plain_calls
    pre, steps, _ = _port_model_run(card, cfg, inputs, max_seq)
    assert fa.launches - flash0 == cfg.n_periods * kinds.count("attn") \
        * (2 + DECODE_STEPS)
    assert sc.launches - scan0 == cfg.n_periods * kinds.count("mamba") * 2
    assert scan_ops.plain_calls == plain0
    for slot in (0, 1):
        _close(pre[slot], cpu_pre[slot], 1e-4, f"{case} prefill {slot}")
    _close(steps, cpu_steps, 1e-4, f"{case} decode on the card")
