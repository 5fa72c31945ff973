"""The port's MoE and recurrent layers (``repro_torch.models.{moe,ssm}``)
against the reference's (``repro.models.{moe,ssm}``), at smoke widths on
the CPU.

Every weight and input is drawn with numpy from a seed and handed to
both packages as float32; the reference runs in a subprocess
(``tests/torch_reference.py``).

* ``apply_moe`` on the olmoe and qwen2_moe smoke presets (qwen2_moe's 6
  experts are padded to 16 with masked logits, and it has a shared
  expert): at the presets' capacity factor, where tokens are dropped
  (the test counts them with ``moe.route``), including a decode tick of
  4 slots (capacity 1), and at a factor large enough to drop none.
* ``apply_mamba``, ``apply_mlstm`` and ``apply_slstm`` without a state
  (the forward pass), and each given the zero state and the whole
  sequence (a prefill): its state after the sequence must equal the
  reference's single-token branch stepped over the same input token by
  token, and the port's own single-token steps must give the reference's
  outputs.
* The selective scan's plain version returns the final state h_L, held
  to a float64 step-by-step recurrence in numpy.

Tolerance 1e-5, absolute and relative (float32 throughout; the
reference scans Mamba associatively, the port sequentially; mLSTM's
state is summed in closed form here and stepped there).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_promoted_ref,
                                              mamba_scan_ref)
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.common import rmsnorm
from torch_reference import run_reference

TOL = 1e-5

# (id, arch, capacity factor, (B, S)): at 1.25, 12 tokens x top-2 over
# 16 padded experts give capacity int(24 // 16 * 1.25) = 1, and a decode
# tick of 4 slots capacity 1; at 16 no expert overflows
MOE_CASES = [("olmoe-drop", "olmoe_1b_7b", 1.25, (2, 6)),
             ("olmoe-decode-tick", "olmoe_1b_7b", 1.25, (4, 1)),
             ("olmoe-no-drop", "olmoe_1b_7b", 16.0, (2, 6)),
             ("qwen2-drop", "qwen2_moe_a2_7b", 1.25, (2, 6)),
             ("qwen2-no-drop", "qwen2_moe_a2_7b", 16.0, (1, 9))]
MOE_IDS = [c[0] for c in MOE_CASES]
# (kind, arch, (B, S))
MIXERS = [("mamba", "jamba_1_5_large_398b", (2, 12)),
          ("mlstm", "xlstm_125m", (2, 10)),
          ("slstm", "xlstm_125m", (2, 9))]
MIXER_IDS = [m[0] for m in MIXERS]
APPLY = {"mamba": S.apply_mamba, "mlstm": S.apply_mlstm,
         "slstm": S.apply_slstm}

_REFERENCE = """
import dataclasses, json
import jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.models import moe as RM
from repro.models import ssm as RS

spec = json.loads(str(inputs["spec"]))


def f64(a):
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def params(prefix):
    return {k[len(prefix):]: jnp.asarray(v, jnp.float32)
            for k, v in inputs.items() if k.startswith(prefix)}


for cid, arch, cf in spec["moe"]:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32,
                              capacity_factor=cf)
    outputs[f"moe/{cid}/out"] = f64(RM.apply_moe(
        params(f"moe/{cid}/p/"), jnp.asarray(inputs[f"moe/{cid}/x"]), cfg))
apply = {"mamba": RS.apply_mamba, "mlstm": RS.apply_mlstm,
         "slstm": RS.apply_slstm}
for kind, arch in spec["mixers"]:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32)
    p = params(f"{kind}/p/")
    x = jnp.asarray(inputs[f"{kind}/x"])
    y, _ = apply[kind](p, x, cfg)
    outputs[f"{kind}/forward"] = f64(y)
    st = RS.init_mamba_state(cfg, x.shape[0]) if kind == "mamba" \\
        else RS.init_xlstm_state(cfg, kind, x.shape[0])
    steps = []
    for t in range(x.shape[1]):
        yt, st = apply[kind](p, x[:, t:t + 1], cfg, st)
        steps.append(f64(yt))
    outputs[f"{kind}/stepped"] = np.concatenate(steps, axis=1)
    for name, v in st.items():
        outputs[f"{kind}/state/{name}"] = f64(v)
"""


def _cfg(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                               **kw)


def _moe_inputs(case):
    """(params, x) of a MoE case as float32 numpy arrays."""
    cid, arch, _, (b, s) = case
    cfg = _cfg(arch)
    rng = np.random.default_rng(sum(map(ord, cid)))
    d, f = cfg.d_model, cfg.expert_d_ff
    e = M.padded_experts(cfg)
    g = rng.normal
    p = {"router": g(size=(d, e)), "ln": 0.1 * g(size=(d,)),
         "wi": g(size=(e, d, f)) / np.sqrt(d),
         "wg": g(size=(e, d, f)) / np.sqrt(d),
         "wo": g(size=(e, f, d)) / np.sqrt(f)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p.update(shared_wi=g(size=(d, fs)) / np.sqrt(d),
                 shared_wg=g(size=(d, fs)) / np.sqrt(d),
                 shared_wo=g(size=(fs, d)) / np.sqrt(fs))
    x = g(size=(b, s, d))
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


def _mixer_inputs(kind, arch, shape):
    cfg = _cfg(arch)
    rng = np.random.default_rng(sum(map(ord, kind)))
    g = rng.normal
    d = cfg.d_model
    if kind == "mamba":
        i, n = cfg.ssm_expand * d, cfg.ssm_state
        p = {"in_proj": g(size=(d, 2 * i)) / np.sqrt(d),
             "x_proj": g(size=(i, 2 * n + 1)) / np.sqrt(i),
             "dt_bias": 0.5 * g(size=(i,)),
             "a_log": np.log(rng.uniform(0.5, 4.0, size=(i, n))),
             "d_skip": g(size=(i,)),
             "out_proj": g(size=(i, d)) / np.sqrt(i)}
    elif kind == "mlstm":
        h, hd = cfg.n_heads, d // cfg.n_heads
        p = {w: g(size=(d, h, hd)) / np.sqrt(d) for w in ("wq", "wk", "wv")}
        # gates spread over (0, 1) and exp(-3 .. 8)
        p["wif"] = 2.0 * g(size=(d, 2 * h)) / np.sqrt(d)
        p["wo"] = g(size=(h, hd, d)) / np.sqrt(d)
    else:
        p = {w: g(size=(d, 4 * d)) / np.sqrt(d) for w in ("wx", "wh")}
    p["ln"] = 0.1 * g(size=(d,))
    x = g(size=shape + (d,))
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    inputs = {}
    spec = {"moe": [], "mixers": []}
    for case in MOE_CASES:
        cid, arch, cf, _ = case
        spec["moe"].append([cid, arch, cf])
        p, x = _moe_inputs(case)
        inputs.update({f"moe/{cid}/p/{k}": v for k, v in p.items()})
        inputs[f"moe/{cid}/x"] = x
    for kind, arch, shape in MIXERS:
        spec["mixers"].append([kind, arch])
        p, x = _mixer_inputs(kind, arch, shape)
        inputs.update({f"{kind}/p/{k}": v for k, v in p.items()})
        inputs[f"{kind}/x"] = x
    inputs["spec"] = np.asarray(json.dumps(spec))
    return run_reference(_REFERENCE, inputs,
                         tmp_path_factory.mktemp("moe_ssm_reference"))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=TOL,
                               rtol=TOL, err_msg=what)


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", MOE_CASES, ids=MOE_IDS)
def test_apply_moe_matches_reference(reference, case):
    cid, arch, cf, (b, s) = case
    cfg = _cfg(arch, capacity_factor=cf)
    p, x = (_torch(t) if isinstance(t, dict) else torch.from_numpy(t)
            for t in _moe_inputs(case))
    got = M.apply_moe(p, x, cfg)
    _close(got.numpy(), reference[f"moe/{cid}/out"], cid)
    # the case's premise: which of its assignments overflowed capacity
    ht = rmsnorm(x, p["ln"], cfg.norm_eps).reshape(b * s, -1)
    _, slot, cap = M.route(p, ht, cfg)
    dropped = int((slot == M.padded_experts(cfg) * cap).sum())
    if cf > 2:
        assert dropped == 0, cid
    else:
        assert cap == 1 and dropped > 0, (cid, cap, dropped)


def test_route_keeps_the_earliest_tokens_within_capacity():
    """Positions within an expert follow the flattened (token, top-k)
    order: with every token choosing the same two experts at capacity
    1, token 0's two assignments are kept and every later one dropped;
    each token's weights come highest first."""
    cfg = _cfg("olmoe_1b_7b")
    e = M.padded_experts(cfg)
    router = torch.full((cfg.d_model, e), -1.0)
    router[:, 3], router[:, 5] = 2.0, 1.0     # expert 3 weighs most
    ht = torch.ones((4, cfg.d_model))
    weights, slot, cap = M.route({"router": router}, ht, cfg)
    assert cap == 1
    assert slot.tolist() == [3, 5] + [e * cap] * 6
    assert bool((weights[:, 0] > weights[:, 1]).all())


# ---------------------------------------------------------------------------
# Mamba, mLSTM, sLSTM
# ---------------------------------------------------------------------------

def _mixer(kind, arch, shape):
    cfg = _cfg(arch)
    p, x = _mixer_inputs(kind, arch, shape)
    return cfg, _torch(p), torch.from_numpy(x)


def _zero_state(cfg, kind, batch):
    return S.init_mamba_state(cfg, batch) if kind == "mamba" \
        else S.init_xlstm_state(cfg, kind, batch)


@pytest.mark.parametrize("kind, arch, shape", MIXERS, ids=MIXER_IDS)
def test_mixer_forward_matches_reference(reference, kind, arch, shape):
    cfg, p, x = _mixer(kind, arch, shape)
    y, st = APPLY[kind](p, x, cfg)
    assert st is None
    _close(y.numpy(), reference[f"{kind}/forward"], f"{kind} forward")


@pytest.mark.parametrize("kind, arch, shape", MIXERS, ids=MIXER_IDS)
def test_mixer_prefill_state_equals_reference_steps(reference, kind, arch,
                                                    shape):
    """The zero state and the whole sequence at once: the forward's
    outputs, and the state the reference's single-token branch reaches
    stepping the same input token by token."""
    cfg, p, x = _mixer(kind, arch, shape)
    y, st = APPLY[kind](p, x, cfg, _zero_state(cfg, kind, shape[0]))
    _close(y.numpy(), reference[f"{kind}/forward"], f"{kind} prefill")
    names = sorted(k.rsplit("/", 1)[1] for k in reference
                   if k.startswith(f"{kind}/state/"))
    assert sorted(st) == names
    for name in names:
        _close(st[name].numpy(), reference[f"{kind}/state/{name}"],
               f"{kind} state {name}")


@pytest.mark.parametrize("kind, arch, shape", MIXERS, ids=MIXER_IDS)
def test_mixer_single_token_steps_match_reference(reference, kind, arch,
                                                  shape):
    cfg, p, x = _mixer(kind, arch, shape)
    st = _zero_state(cfg, kind, shape[0])
    steps = []
    for t in range(shape[1]):
        yt, st = APPLY[kind](p, x[:, t:t + 1], cfg, st)
        steps.append(yt.numpy())
    _close(np.concatenate(steps, axis=1), reference[f"{kind}/stepped"],
           f"{kind} steps")
    for name, v in st.items():
        _close(v.numpy(), reference[f"{kind}/state/{name}"],
               f"{kind} stepped state {name}")


def test_mamba_prefill_runs_the_scan_op():
    """A prefill scans through ``scan_ops.mamba_scan`` (on the CPU its
    plain version, counted), a decode step does not."""
    cfg, p, x = _mixer("mamba", "jamba_1_5_large_398b", (2, 12))
    before = scan_ops.plain_calls
    _, st = S.apply_mamba(p, x, cfg, _zero_state(cfg, "mamba", 2))
    assert scan_ops.plain_calls == before + 1
    S.apply_mamba(p, x[:, :1], cfg, st)
    assert scan_ops.plain_calls == before + 1


# ---------------------------------------------------------------------------
# the scan's final state
# ---------------------------------------------------------------------------

def _scan_inputs(b, length, inner, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, length, inner)),
            0.1 * np.abs(rng.normal(size=(b, length, inner))),
            rng.normal(size=(b, length, n)), rng.normal(size=(b, length, n)),
            np.log(np.abs(rng.normal(size=(inner, n))) + 0.5),
            rng.normal(size=(inner,)))


def _stepped_state(x, dt, bm, a):
    h = np.zeros((x.shape[0], x.shape[2], bm.shape[2]))
    for t in range(x.shape[1]):
        h = np.exp(dt[:, t, :, None] * -np.exp(a)[None]) * h \
            + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
    return h


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(2, 37, 5, 3), (1, 64, 8, 16),
                                   (2, 1, 4, 4), (1, 0, 3, 2)],
                         ids=["ragged", "jamba-like", "one-step", "empty"])
def test_plain_scan_final_state_matches_stepped_recurrence(shape, dtype):
    args = _scan_inputs(*shape, seed=sum(shape))
    want = _stepped_state(args[0], args[1], args[2], args[4])
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in args]
    y0 = mamba_scan_promoted_ref(*t)
    for fn in (mamba_scan_ref, mamba_scan_promoted_ref, scan_ops.mamba_scan):
        y, h = fn(*t, return_state=True)
        assert h.shape == shape[:1] + shape[2:] and h.dtype == t[0].dtype
        _close(h.numpy(), want, f"{fn.__name__} h_L")
        assert torch.equal(y.to(y0.dtype), y0)    # y as without the state
