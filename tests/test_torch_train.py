"""The port's training path (``repro_torch.train``, the loss of
``models/transformer.py``) against the reference's (``repro.train``,
``repro.models.transformer.loss_fn``), at small sizes on the CPU.

Weights are the reference's own ``init_params(cfg, jax.random.key(0))``
at float32, carried over with ``transformer.params_from_reference``;
batches are the reference's data pipeline's (``SyntheticTokens``, seed
1234), which the port carries verbatim. The reference runs in one
subprocess per module (``tests/torch_reference.py``).

* Loss and gradient of each family's smoke preset: dense (stablelm,
  gemma2: window, softcaps), MoE (olmoe), vlm (llava: embeddings in),
  audio (seamless: encoder-decoder), hybrid (jamba) and ssm (xlstm),
  against ``jax.value_and_grad`` of the reference's ``loss_fn``: the loss
  within 1e-5 relative, each leaf's gradient within 1e-4 of its norm.
  The same with the config's ``remat="full"`` (periods checkpointed) and
  ``fused_xent`` off on stablelm, and with gemma2's preset widened to
  two heads (one KV head) of gemma2_2b's head dim, 288.
* Three steps of ``make_train_step`` (microbatch 2, AdamW) against the
  reference's jitted step: each loss within 1e-5 relative, each
  parameter leaf within 1e-4 of its norm after the third step.
* The int8 and top-k round trips and the int8 moments (``_q8``, and an
  AdamW step with them) against the reference's on the same inputs:
  the int8 payloads equal, the rest within 1e-6. At eps 1e-8 the
  reference's int8 moments step an element whose second moment was
  stored as 0 by about m / eps (two steps at phase 11's learning rate);
  the port takes the same steps.
* Two parameters summed directly get a gradient each (autograd hands
  both one tensor) and AdamW moves each by its own.
* Enc-dec (seamless) and vlm (llava) prefill and decode logits against
  the reference's, within 1e-4 at float32.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models import transformer as T
from repro_torch.train import (AdamWConfig, init_opt_state,
                               make_train_step, value_and_grad)
from repro_torch.train import grad_compress as GC
from repro_torch.train import optimizer as O
from repro_torch.train.tree import leaves, leaves_with_paths, unflatten
from torch_reference import PARAMS_CODE, reference_params, run_reference

FAMILIES = ["stablelm_3b", "gemma2_2b", "olmoe_1b_7b",
            "llava_next_mistral_7b", "seamless_m4t_medium",
            "jamba_1_5_large_398b", "xlstm_125m"]
BATCH, SEQ = 2, 16
STEPS_BATCH = 4
LR = 1e-3
DECODE_STEPS = 3
GEN_ARCHS = ["seamless_m4t_medium", "llava_next_mistral_7b"]
# the loss cases' config changes: 0 the smoke preset, 1 remat and the
# unchunked loss, 2 (WIDE) two heads of gemma2_2b's head dim (the
# attention's gradient past D = 128)
VARIANTS = [{}, {"remat": "full", "fused_xent": False},
            {"d_model": 576, "n_heads": 2, "kv_heads": 1, "head_dim": 288}]
WIDE = 2
WIDE_ARCHS = ["gemma2_2b"]

_REFERENCE = PARAMS_CODE + """
import dataclasses, json
import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.models import transformer as RT
from repro.train import AdamWConfig, init_opt_state, make_train_step
from repro.train import grad_compress as GC
from repro.train import optimizer as O

spec = json.loads(str(inputs["spec"]))


def cfg_of(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32,
                               **kw)


def batch_of(prefix):
    return {k.split("/")[-1]: jnp.asarray(v) for k, v in inputs.items()
            if k.startswith(prefix + "/")}


for arch, variant in spec["loss"]:
    cfg = cfg_of(arch, **spec["variants"][variant])
    params = RT.init_params(cfg, jax.random.key(0))[0]
    if variant == 0:
        flat(f"params/{arch}/float32", params)
    elif variant == spec["wide"]:
        flat(f"params/{arch}-{variant}/float32", params)
    batch = batch_of(f"batch/{arch}")
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: RT.loss_fn(p, batch, cfg)))(params)
    outputs[f"loss/{arch}/{variant}"] = np.asarray(loss, np.float64)
    flat(f"grads/{arch}/{variant}", grads)

cfg = cfg_of("stablelm_3b", microbatch=2)
opt_cfg = AdamWConfig(lr=spec["lr"])
params = RT.init_params(cfg, jax.random.key(0))[0]
opt = init_opt_state(params, opt_cfg)
step = jax.jit(make_train_step(cfg, opt_cfg))
for i in range(3):
    params, opt, m = step(params, opt, batch_of(f"steps/{i}"))
    outputs[f"steps/loss/{i}"] = np.asarray(m["loss"], np.float64)
    outputs[f"steps/gnorm/{i}"] = np.asarray(m["grad_norm"], np.float64)
flat("steps/params", params)

g = jnp.asarray(inputs["codec/g"])
r = jnp.asarray(inputs["codec/r"])
c = GC.compress_int8(g)
outputs["codec/int8/payload"] = np.asarray(c.payload)
outputs["codec/int8/scale"] = np.asarray(c.scale)
outputs["codec/int8/decoded"] = np.asarray(GC.roundtrip_int8({"g": g})["g"])
sent, res = GC.topk_sparsify(g, r, 0.1)
outputs["codec/topk/sent"] = np.asarray(sent)
outputs["codec/topk/res"] = np.asarray(res)
q, s = O._q8(g)
outputs["codec/q8/payload"] = np.asarray(q)
outputs["codec/q8/scale"] = np.asarray(s)
tree = {"w": jnp.asarray(inputs["codec/w"]),
        "b": jnp.asarray(inputs["codec/b"])}
grads = {"w": g, "b": jnp.asarray(inputs["codec/gb"])}
ocfg = AdamWConfig(lr=1e-2, quantize_moments=True)
st = init_opt_state(tree, ocfg)
for _ in range(2):
    tree, st = O.adamw_update(tree, grads, st, ocfg)
flat("codec/adam/params", tree)
flat("codec/adam/m", st.m)
flat("codec/adam/v", st.v)
for eps in (1e-8, 1e-4):
    ocfg = AdamWConfig(lr=3e-4, eps=eps, quantize_moments=True)
    tree = {"w": jnp.asarray(inputs["eps/w"])}
    st = init_opt_state(tree, ocfg)
    for k in range(2):
        tree, st = O.adamw_update(
            tree, {"w": jnp.asarray(inputs[f"eps/g{k}"])}, st, ocfg)
    outputs[f"eps/{eps:g}"] = np.asarray(tree["w"])

for arch in spec["gen"]:
    cfg = cfg_of(arch)
    params = RT.init_params(cfg, jax.random.key(0))[0]
    batch = batch_of(f"gen/{arch}")
    tokens = batch.pop("next")
    caches, logits = jax.jit(lambda p, b: RT.prefill(p, b, cfg, 32))(
        params, batch)
    outputs[f"gen/{arch}/prefill"] = np.asarray(logits, np.float64)
    dec = jax.jit(lambda p, t, c: RT.decode_step(p, t, c, cfg))
    for t in range(tokens.shape[1]):
        logits, caches = dec(params, tokens[:, t:t + 1], caches)
        outputs[f"gen/{arch}/decode/{t}"] = np.asarray(logits, np.float64)
"""


def _cfg(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                               **kw)


def _batch(cfg, batch, seq, step=0, seed=1234):
    """The reference pipeline's batch ``step`` for ``cfg`` (numpy)."""
    data = SyntheticTokens(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed,
        embeds_dim=cfg.d_model if cfg.embeds_input else 0,
        src_len=seq if cfg.is_encdec else 0, d_model=cfg.d_model))
    return data.batch_at(step)


def _torch_batch(np_batch):
    return {k: torch.from_numpy(v) for k, v in np_batch.items()}


def _codec_inputs():
    rng = np.random.default_rng(11)
    return {"codec/g": rng.normal(size=(37, 5)).astype(np.float32),
            "codec/r": (0.1 * rng.normal(size=(37, 5))).astype(np.float32),
            "codec/w": rng.normal(size=(37, 5)).astype(np.float32),
            "codec/b": rng.normal(size=(5,)).astype(np.float32),
            "codec/gb": rng.normal(size=(5,)).astype(np.float32),
            **_eps_inputs()}


def _eps_inputs():
    """A weight and two clipped gradients whose elements span 1e-7 ..
    1e-3, the second with half of them 0 (as a row no token of the next
    batch reaches)."""
    rng = np.random.default_rng(21)
    g0 = rng.choice([-1, 1], size=(64, 8)) * 10 ** rng.uniform(
        -7, -3, size=(64, 8))
    return {"eps/w": (0.02 * rng.normal(size=(64, 8))).astype(np.float32),
            "eps/g0": g0.astype(np.float32),
            "eps/g1": np.where(rng.random((64, 8)) < 0.5, 0, g0).astype(
                np.float32)}


def _gen_inputs(arch):
    cfg = _cfg(arch)
    b = _batch(cfg, BATCH, 9, step=3)
    prompt = {k: v for k, v in b.items() if k != "labels"}
    rng = np.random.default_rng(5)
    prompt["next"] = rng.integers(0, cfg.vocab, (BATCH, DECODE_STEPS)) \
        .astype(np.int32)
    return prompt


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    loss_cases = [(arch, 0) for arch in FAMILIES] + [("stablelm_3b", 1)] \
        + [(arch, WIDE) for arch in WIDE_ARCHS]
    inputs = {"spec": np.asarray(json.dumps({
        "loss": loss_cases, "variants": VARIANTS, "wide": WIDE, "lr": LR,
        "gen": GEN_ARCHS}))}
    for arch in FAMILIES:
        for k, v in _batch(_cfg(arch), BATCH, SEQ).items():
            inputs[f"batch/{arch}/{k}"] = v
    steps_cfg = _cfg("stablelm_3b")
    for i in range(3):
        for k, v in _batch(steps_cfg, STEPS_BATCH, SEQ, step=i).items():
            inputs[f"steps/{i}/{k}"] = v
    inputs.update(_codec_inputs())
    for arch in GEN_ARCHS:
        for k, v in _gen_inputs(arch).items():
            inputs[f"gen/{arch}/{k}"] = v
    return run_reference(_REFERENCE, inputs,
                         tmp_path_factory.mktemp("train_reference"),
                         timeout_s=600)


def _leaf_close(got, want, what):
    got = np.asarray(got, np.float64)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    norm = float(np.linalg.norm(want))
    assert err <= 1e-4 * max(norm, 1e-6), (what, err, norm)


def _check_grads(reference, arch, variant, params, grads):
    for (path, _), g in zip(leaves_with_paths(params), grads):
        key = f"grads/{arch}/{variant}/" + "/".join(path)
        _leaf_close(g.numpy(), reference[key], key)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_reference(reference, arch):
    cfg = _cfg(arch)
    params = reference_params(reference, arch, "float32", cfg)
    batch = _torch_batch(_batch(cfg, BATCH, SEQ))
    loss, grads = value_and_grad(lambda p, b: T.loss_fn(p, b, cfg),
                                 params, batch)
    want = float(reference[f"loss/{arch}/0"])
    assert abs(float(loss) - want) <= 1e-5 * abs(want), (float(loss), want)
    _check_grads(reference, arch, 0, params, grads)


def test_remat_and_unfused_loss_match_reference(reference):
    """``remat="full"`` (each period checkpointed) and the unchunked
    cross-entropy give the reference's loss and gradient too."""
    arch = "stablelm_3b"
    cfg = _cfg(arch, remat="full", fused_xent=False)
    params = reference_params(reference, arch, "float32", cfg)
    batch = _torch_batch(_batch(cfg, BATCH, SEQ))
    loss, grads = value_and_grad(lambda p, b: T.loss_fn(p, b, cfg),
                                 params, batch)
    want = float(reference[f"loss/{arch}/1"])
    assert abs(float(loss) - want) <= 1e-5 * abs(want)
    _check_grads(reference, arch, 1, params, grads)


@pytest.mark.parametrize("arch", WIDE_ARCHS)
def test_wide_head_loss_and_gradients_match_reference(reference, arch):
    """gemma2's preset at two heads of 288 (gemma2_2b's head dim; window
    and softcaps kept): the loss and each leaf's gradient against the
    reference's, as the families' presets are held."""
    cfg = _cfg(arch, **VARIANTS[WIDE])
    assert cfg.head_dim == 288 and cfg.layers == 2
    params = reference_params(reference, f"{arch}-{WIDE}", "float32", cfg)
    batch = _torch_batch(_batch(cfg, BATCH, SEQ))
    loss, grads = value_and_grad(lambda p, b: T.loss_fn(p, b, cfg),
                                 params, batch)
    want = float(reference[f"loss/{arch}/{WIDE}"])
    assert abs(float(loss) - want) <= 1e-5 * abs(want), (float(loss), want)
    _check_grads(reference, arch, WIDE, params, grads)


def test_three_train_steps_match_reference(reference):
    cfg = _cfg("stablelm_3b", microbatch=2)
    params = reference_params(reference, "stablelm_3b", "float32", cfg)
    opt_cfg = AdamWConfig(lr=LR)
    opt = init_opt_state(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    for i in range(3):
        params, opt, m = step(params, opt, _torch_batch(
            _batch(cfg, STEPS_BATCH, SEQ, step=i)))
        for name in ("loss", "gnorm"):
            want = float(reference[f"steps/{name}/{i}"])
            got = float(m["loss" if name == "loss" else "grad_norm"])
            assert abs(got - want) <= 1e-5 * abs(want), (name, i, got, want)
    assert int(opt.step) == 3
    for path, p in leaves_with_paths(params):
        key = "steps/params/" + "/".join(path)
        _leaf_close(p.numpy(), reference[key], key)


def test_step_writes_into_the_given_tensors():
    """The port's step (unlike the reference's pure one) overwrites the
    parameters and moments it is given and returns the same tensors."""
    cfg = _cfg("stablelm_3b", microbatch=2)
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(0))
    opt_cfg = AdamWConfig(lr=LR, quantize_moments=True)
    opt = init_opt_state(params, opt_cfg)
    before = [t.clone() for t in leaves((params, opt))]
    ids = [id(t) for t in leaves((params, opt))]
    new_p, new_o, _ = make_train_step(cfg, opt_cfg)(
        params, opt, _torch_batch(_batch(cfg, STEPS_BATCH, SEQ)))
    assert [id(t) for t in leaves((new_p, new_o))] == ids
    assert int(new_o.step) == 1
    assert not torch.equal(params["embed"], before[ids.index(
        id(params["embed"]))])


def test_int8_and_topk_codecs_and_8bit_moments_match_reference(reference):
    inp = {k: torch.from_numpy(v) for k, v in _codec_inputs().items()}
    g = inp["codec/g"]
    c = GC.compress_int8(g)
    assert np.array_equal(c.payload.numpy(),
                          reference["codec/int8/payload"])
    assert np.allclose(c.scale.numpy(), reference["codec/int8/scale"],
                       rtol=1e-6, atol=0)
    dec = GC.roundtrip_int8({"g": g})["g"]
    assert np.allclose(dec.numpy(), reference["codec/int8/decoded"],
                       rtol=1e-6, atol=1e-7)
    sent, res = GC.topk_sparsify(g, inp["codec/r"], 0.1)
    assert np.array_equal(sent.numpy(), reference["codec/topk/sent"])
    assert np.allclose(res.numpy(), reference["codec/topk/res"], atol=1e-7)
    q, s = O._q8(g)
    assert np.array_equal(q.numpy(), reference["codec/q8/payload"])
    assert np.allclose(s.numpy(), reference["codec/q8/scale"], rtol=1e-6)
    tree = {"w": inp["codec/w"], "b": inp["codec/b"]}
    grads = {"w": g, "b": inp["codec/gb"]}
    ocfg = AdamWConfig(lr=1e-2, quantize_moments=True)
    st = O.init_opt_state(tree, ocfg)
    for _ in range(2):
        tree, st = O.adamw_update(tree, grads, st, ocfg)
    for name, sub in (("params", tree), ("m", st.m), ("v", st.v)):
        for path, leaf in leaves_with_paths(sub):
            # PARAMS_CODE's flat() walks a MomentState as a tuple
            idx = [{"payload": "0", "scale": "1"}.get(x, x) for x in path]
            want = reference[f"codec/adam/{name}/" + "/".join(idx)]
            assert np.allclose(leaf.numpy().astype(np.float64), want,
                               rtol=1e-6, atol=1e-7), (name, path)
    # the stochastic rounding draws from a torch.Generator: its payload
    # is within one step of the rounded one
    sto = GC.compress_int8(g, torch.Generator().manual_seed(0))
    assert int((sto.payload.int() - c.payload.int()).abs().max()) <= 1
    # top-k's error feedback carries what was not sent
    state = GC.init_topk_state({"g": g})
    sent_t, state = GC.topk_roundtrip({"g": g}, state, 0.1)
    assert torch.equal(sent_t["g"] + state.residual["g"], g)


def test_reference_int8_moments_step_by_m_over_eps_at_eps_1e8(reference):
    """The reference's int8 moments (one absmax scale a tensor) store a
    second moment below 1/254 of its tensor's largest as 0. Where such
    an element's first moment survives and its next gradient is 0, the
    reference's AdamW at its default eps of 1e-8 steps it by about m /
    1e-8: hundreds of times the learning rate, at the learning rate and
    gradient sizes that phase 11 of chip_smoke.py trains Jamba with.
    The port takes the same steps; eps = 1e-4 keeps every step near the
    learning rate."""
    inp = _eps_inputs()
    w0, g0, g1 = (inp[f"eps/{k}"] for k in ("w", "g0", "g1"))
    zeroed = ((O._q8(torch.from_numpy(0.1 * g0))[0] != 0)
              & (O._q8(torch.from_numpy(0.05 * g0 ** 2))[0] == 0)).numpy() \
        & (g1 == 0)
    assert zeroed.sum() > 10
    lr = 3e-4
    for eps in (1e-8, 1e-4):
        ocfg = AdamWConfig(lr=lr, eps=eps, quantize_moments=True)
        tree = {"w": torch.from_numpy(w0.copy())}
        st = O.init_opt_state(tree, ocfg)
        for g in (g0, g1):
            tree, st = O.adamw_update(tree, {"w": torch.from_numpy(g)}, st,
                                      ocfg)
        want = reference[f"eps/{eps:g}"]
        assert np.allclose(tree["w"].numpy(), want, rtol=1e-5, atol=1e-7)
        moved = np.abs(want - w0) / lr
        if eps == 1e-8:
            assert moved[zeroed].min() > 100, moved[zeroed].min()
            assert moved[~zeroed].max() < 5
        else:
            assert moved.max() < 5


def test_gradients_of_two_summed_parameters_stay_apart():
    """autograd hands one tensor to both inputs of a sum; each leaf
    still gets a gradient of its own, so the tree of gradients ties
    nothing that the parameters do not, and AdamW moves each leaf by its
    own gradient."""
    gen = torch.Generator().manual_seed(3)
    params = {k: torch.randn(4, 3, generator=gen) for k in "ab"}
    params["c"] = torch.randn(3, generator=gen)
    x = torch.randn(4, 3, generator=gen)
    loss, grads = value_and_grad(
        lambda p, b: ((p["a"] + p["b"]) * b).sum() + (p["c"] ** 2).sum(),
        params, x)
    assert len({id(g) for g in grads}) == 3
    assert all(torch.equal(g, x) for g in grads[:2])
    assert torch.equal(grads[2], 2 * params["c"])
    cfg = AdamWConfig(lr=LR)
    moved = {k: t.clone() for k, t in params.items()}
    O.adamw_update(moved, unflatten(params, iter(grads)),
                   O.init_opt_state(moved, cfg), cfg)
    apart = {k: t.clone() for k, t in params.items()}
    O.adamw_update(apart, {"a": x.clone(), "b": x.clone(),
                           "c": 2 * params["c"]},
                   O.init_opt_state(apart, cfg), cfg)
    for k in params:
        assert torch.equal(moved[k], apart[k]), k
        assert not torch.equal(moved[k], params[k]), k


@pytest.mark.parametrize("arch", GEN_ARCHS)
def test_encdec_and_vlm_prefill_and_decode_match_reference(reference, arch):
    cfg = _cfg(arch)
    params = reference_params(reference, arch, "float32", cfg)
    batch = {k: torch.from_numpy(v) for k, v in _gen_inputs(arch).items()}
    tokens = batch.pop("next")
    with torch.no_grad():
        caches, logits = T.prefill(params, batch, cfg, 32)
        got = [logits]
        for t in range(tokens.shape[1]):
            logits, caches = T.decode_step(params, tokens[:, t:t + 1],
                                           caches, cfg)
            got.append(logits)
    keys = [f"gen/{arch}/prefill"] + [f"gen/{arch}/decode/{t}"
                                      for t in range(DECODE_STEPS)]
    for key, g in zip(keys, got):
        want = reference[key]
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    if cfg.is_encdec:
        # decode took the cross keys and values prefill left in the
        # caches, one row per source position
        assert caches[0]["cross_kv"][0].shape[2] == batch["src_embeds"] \
            .shape[1]


def _jamba_tied(pad=False):
    """Jamba's smoke preset (f32) with 2 routed experts, one set shared
    by each period's MoE layers (tied), unpadded unless ``pad``."""
    cfg = _cfg("jamba_1_5_large_398b", n_experts=2)
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(3),
                              share_experts=True,
                              expert_multiple=T.TP_DEFAULT if pad else 1)
    return cfg, params


def test_a_tied_tensor_is_one_leaf_and_unflatten_ties_it_again():
    from repro_torch.train.tree import tree_map, unflatten
    cfg, params = _jamba_tied()
    moes = [b["moe"] for b in params["blocks"] if "moe" in b]
    assert len(moes) == 2 and moes[0]["wi"] is moes[1]["wi"]
    paths = ["/".join(p) for p, _ in leaves_with_paths(params)]
    assert len(paths) == len(set(paths))
    tied = [p for p in paths if p.endswith(("moe/wi", "moe/wg", "moe/wo"))]
    assert len(tied) == 3                  # the first MoE layer's paths
    copy = unflatten(params, iter([t.clone() for t in leaves(params)]))
    cmoes = [b["moe"] for b in copy["blocks"] if "moe" in b]
    assert cmoes[0]["wi"] is cmoes[1]["wi"]
    assert cmoes[0]["router"] is not cmoes[1]["router"]
    mapped = tree_map(lambda t: t * 2, params)
    assert [b["moe"] for b in mapped["blocks"] if "moe" in b][1]["wo"] \
        is [b["moe"] for b in mapped["blocks"] if "moe" in b][0]["wo"]


def test_tied_experts_take_the_sum_of_their_layers_gradients():
    """A tied expert set's gradient is the sum of the gradients the same
    weights get untied, one copy a layer; every other leaf's is equal."""
    cfg, params = _jamba_tied()
    batch = _torch_batch(_batch(cfg, BATCH, SEQ))
    loss_fn = lambda p, b: T.loss_fn(p, b, cfg)  # noqa: E731
    loss, grads = value_and_grad(loss_fn, params, batch)
    untied = {**params, "blocks": [
        {**b, "moe": {k: v.clone() for k, v in b["moe"].items()}}
        if "moe" in b else b for b in params["blocks"]]}
    loss_u, grads_u = value_and_grad(loss_fn, untied, batch)
    assert float(loss) == float(loss_u)
    got = dict(zip(("/".join(p) for p, _ in leaves_with_paths(params)),
                   grads))
    want = dict(zip(("/".join(p) for p, _ in leaves_with_paths(untied)),
                    grads_u))
    moe_idx = [str(i) for i, b in enumerate(params["blocks"]) if "moe" in b]
    for path, g in got.items():
        parts = path.split("/")
        if parts[-1] in ("wi", "wg", "wo") and parts[-2] == "moe":
            w = sum(want[f"blocks/{i}/moe/{parts[-1]}"] for i in moe_idx)
        else:
            w = want[path]
        assert torch.allclose(g, w, rtol=1e-5, atol=1e-6), path


def test_train_step_moves_tied_experts_once_and_keeps_them_tied():
    cfg, params = _jamba_tied()
    opt_cfg = AdamWConfig(lr=LR, quantize_moments=True)
    opt = init_opt_state(params, opt_cfg)
    assert len(leaves(opt.m)) == 2 * len(leaves(params))
    before = [t.clone() for t in leaves(params)]
    step = make_train_step(cfg, opt_cfg)
    params, opt, m = step(params, opt, _torch_batch(_batch(cfg, BATCH,
                                                           SEQ)))
    moes = [b["moe"] for b in params["blocks"] if "moe" in b]
    assert moes[0]["wi"] is moes[1]["wi"]
    assert all(not torch.equal(a, b) for a, b in zip(before, leaves(params))
               if a.dim() >= 2)
    assert bool(torch.isfinite(m["loss"]))


def test_unpadded_experts_hold_the_config_count():
    cfg, params = _jamba_tied()
    moe = next(b["moe"] for b in params["blocks"] if "moe" in b)
    assert moe["router"].shape[-1] == cfg.n_experts == 2
    assert moe["wi"].shape[1] == 2
    _, padded = _jamba_tied(pad=True)
    assert next(b["moe"] for b in padded["blocks"]
                if "moe" in b)["router"].shape[-1] == 16


def test_one_microbatch_keeps_each_gradient_in_its_leaf_dtype():
    """With one microbatch accumulate_grads returns value_and_grad's
    gradient in the leaf's dtype (its float32 sum holds the same values);
    with two it sums in float32."""
    from repro_torch.train import accumulate_grads
    cfg = dataclasses.replace(get_smoke_config("stablelm_3b"),
                              microbatch=1)
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _torch_batch(_batch(cfg, BATCH, SEQ))
    loss, grads = accumulate_grads(cfg, params, batch)
    want_loss, want = value_and_grad(lambda p, b: T.loss_fn(p, b, cfg),
                                     params, batch)
    assert loss.dtype == torch.float32
    assert float(loss) == float(want_loss.float())
    for g, w, p in zip(grads, want, leaves(params)):
        assert g.dtype == p.dtype and torch.equal(g, w)
    _, grads2 = accumulate_grads(dataclasses.replace(cfg, microbatch=2),
                                 params, batch)
    assert all(g.dtype == torch.float32 for g in grads2)
