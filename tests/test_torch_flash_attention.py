"""The port's flash attention against the reference's, at small sizes.

The plain torch versions (``repro_torch.kernels.flash_attention.ref``)
and the GQA dispatch (``ops``) on CPU tensors are held to the
reference's Pallas kernel in interpret mode (32-row tiles, as
``tests/test_kernels.py`` runs it) and to its jnp oracle, on the same
inputs made from a numpy seed. The cases follow the shape, window and
softcap sweep of ``tests/test_kernels.py``; the windowed ones mask whole
32-key tiles of later query rows. Ragged cases (Sq, Skv that tile by
nothing; rows whose every key is masked) go to the oracle only: the
Pallas kernel refuses ragged tiles. Tolerances, applied absolutely and
relative to the reference: float64 1e-8, float32 2e-4, bfloat16 2e-2
(both sides round the probabilities and the output to bf16).

The runtime surface ``repro_torch.kernels.api.attention_rows`` is held
to ``repro.kernels.api.attention_rows`` on numpy and ``ChunkSlice``
blocks. The reference side runs once per module in a subprocess
(``tests/torch_reference.py``). The hand-written CUDA kernel runs only
on a card: its tests carry the ``cuda`` marker and skip here.
"""

import numpy as np
import pytest
import torch

from repro_torch.distrib.serial import rebase_chunk
from repro_torch.kernels import api
from repro_torch.kernels.flash_attention import flash_attention as kernel
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    attention_ref, flash_attention_bhsd_ref)
from torch_reference import run_reference

TOL = {"float32": 2e-4, "bfloat16": 2e-2, "float64": 1e-8}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float64": torch.float64}
DTYPES = sorted(TOL)

# (id, (B, Sq, Skv, H, KVH, D), causal, window, softcap, pallas): the
# shapes of tests/test_kernels.py's smoke and sweep, and ragged cases
CASES = [
    ("smoke", (1, 64, 64, 2, 1, 32), True, 0, 0.0, True),
    ("smoke-gqa-window-cap", (1, 64, 64, 4, 2, 32), True, 32, 30.0, True),
    ("sweep-cap", (1, 128, 128, 2, 2, 64), True, 0, 30.0, True),
    ("sweep-window", (1, 128, 128, 4, 1, 32), True, 32, 0.0, True),
    ("sweep-window-cap", (2, 128, 128, 4, 2, 64), True, 32, 30.0, True),
    ("noncausal", (1, 64, 64, 2, 2, 64), False, 0, 0.0, True),
    ("ragged-causal", (1, 37, 50, 2, 1, 24), True, 0, 0.0, False),
    # rows 44.. of the 50 have no key inside the window: they average v
    ("ragged-window-masked-rows", (1, 50, 37, 2, 1, 24), False, 8, 30.0,
     False),
    # Sq over several 64-row query blocks; the window masks whole KV
    # tiles, which the kernel skips
    ("blocks-window", (1, 200, 200, 2, 1, 24), True, 40, 0.0, False),
    # rows 115.. have no key in the window: the block of rows 64-127
    # holds valid rows and such rows, and the next block only such rows
    ("blocks-masked-rows", (1, 150, 100, 2, 1, 40), False, 16, 20.0,
     False),
]
CASE_IDS = [c[0] for c in CASES]

# rows [LO, HI) of the (40, 12) query block form a worker's chunk
LO, HI = 16, 29

_REFERENCE = """
import jax.numpy as jnp
from repro.kernels import api as ref_api
from repro.kernels.flash_attention.ops import flash_attention as ref_pallas
from repro.kernels.flash_attention.ref import attention_ref as ref_oracle
for key in sorted({k.rsplit("/", 1)[0] for k in inputs}):
    q, k, v = (inputs[key + "/" + n] for n in "qkv")
    if key.startswith("fa/"):
        dtype = key.split("/")[2]
        causal, window, softcap, pallas = inputs[key + "/opts"]
        opts = dict(causal=bool(causal), window=int(window),
                    softcap=float(softcap))
        jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
        if pallas:
            got = ref_pallas(jq, jk, jv, force_pallas=True, interpret=True,
                             bq=32, bk=32, **opts)
            outputs[key + "/pallas"] = np.asarray(got.astype(jnp.float64))
        outputs[key + "/oracle"] = np.asarray(
            ref_oracle(jq, jk, jv, **opts).astype(jnp.float64))
    else:
        outputs[key + "/api"] = np.asarray(ref_api.attention_rows(q, k, v))
"""


def _key(case_id, dtype):
    return f"fa/{case_id}/{dtype}"


def _inputs(case):
    case_id, (b, sq, skv, h, kvh, d), *_ = case
    rng = np.random.default_rng(sq + h * 7 + d + len(case_id))
    q = rng.normal(size=(b, sq, h, d))
    k = rng.normal(size=(b, skv, kvh, d))
    v = rng.normal(size=(b, skv, kvh, d))
    return q, k, v


def _api_inputs():
    """name → (q, k, v) for the runtime-surface cases (the
    ``tests/test_kernels_equiv.py`` shapes); the chunk cases are the
    global rows a ChunkSlice of Q[LO:HI] stands for."""
    rng = np.random.default_rng(19)
    out = {}
    for dtype in ("float32", "float64"):
        out[dtype] = tuple((0.3 * rng.normal(size=(r, 12))).astype(dtype)
                           for r in (10, 24, 24))
    Q = 0.3 * rng.normal(size=(40, 12))
    K = 0.3 * rng.normal(size=(24, 12))
    V = rng.normal(size=(24, 12))
    out["chunk-view"] = (Q[LO:HI, 0:12], K[0:24, 0:12], V[0:24, 0:12])
    out["chunk"] = (Q[LO:HI], K, V)
    return out, Q, K, V


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference results, from one subprocess."""
    inputs = {}
    for case in CASES:
        _, _, causal, window, softcap, pallas = case
        for dtype in DTYPES:
            key = _key(case[0], dtype)
            for name, arr in zip("qkv", _inputs(case)):
                inputs[f"{key}/{name}"] = arr
            inputs[key + "/opts"] = np.asarray(
                [causal, window, softcap, pallas], np.float64)
    for name, blocks in _api_inputs()[0].items():
        for n, arr in zip("qkv", blocks):
            inputs[f"api/{name}/{n}"] = arr
    return run_reference(_REFERENCE, inputs,
                         tmp_path_factory.mktemp("flash_reference"))


@pytest.fixture
def cpu_api(monkeypatch):
    """Bind the kernel runtime to the CPU for one test."""
    monkeypatch.setattr(api, "_DEVICE", "cpu")
    api.reset()
    yield api
    api.reset()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def _close(got, want, dtype, case):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=TOL[dtype], rtol=TOL[dtype],
                               err_msg=case)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plain_attention_matches_reference_pallas_and_oracle(reference,
                                                             case, dtype):
    case_id, (b, sq, skv, h, kvh, d), causal, window, softcap, pallas = case
    q, k, v = (torch.from_numpy(a).to(TORCH_DT[dtype])
               for a in _inputs(case))
    opts = dict(causal=causal, window=window, softcap=softcap)
    got_ops = ops.flash_attention(q, k, v, **opts)
    got_ref = attention_ref(q, k, v, **opts)
    key = _key(case_id, dtype)
    for got in (got_ops, got_ref):
        assert got.dtype == TORCH_DT[dtype]
        assert tuple(got.shape) == (b, sq, h, d)
        g = got.to(torch.float64).numpy()
        _close(g, reference[key + "/oracle"], dtype, key)
        if pallas:
            _close(g, reference[key + "/pallas"], dtype, key)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_bhsd_plain_version_equals_gqa_oracle(dtype):
    """The kernel's own (BH, S, D) function — its running-state
    arithmetic unrolled — against the GQA oracle on the same heads, with
    whole tiles masked and rows that have no valid key."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(3, 96, 16))).to(TORCH_DT[dtype])
    k = torch.from_numpy(rng.normal(size=(3, 70, 16))).to(TORCH_DT[dtype])
    v = torch.from_numpy(rng.normal(size=(3, 70, 16))).to(TORCH_DT[dtype])
    for causal, window, softcap in ((True, 16, 0.0), (False, 16, 20.0)):
        opts = dict(causal=causal, window=window, softcap=softcap)
        got = flash_attention_bhsd_ref(q, k, v, **opts)
        want = attention_ref(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                             v.transpose(0, 1)[None], **opts)[0]
        _close(got.numpy(), want.transpose(0, 1).numpy(), dtype, str(opts))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_api_attention_rows_matches_reference_api(reference, cpu_api,
                                                  dtype):
    q, k, v = _api_inputs()[0][dtype]
    got = cpu_api.attention_rows(q, k, v)
    assert got.dtype == np.dtype(dtype) and got.shape == (10, 12)
    _close(got, reference[f"api/{dtype}/api"], dtype, dtype)
    # unscaled softmax rows: p = exp(q·kᵀ), out = (p @ v) / p.sum()
    p = np.exp(q.astype(np.float64) @ k.astype(np.float64).T)
    _close(got, (p @ v) / p.sum(-1, keepdims=True), dtype, "numpy")
    st = cpu_api.take_stats()
    assert st["cuda_calls"] == 1 and st["cuda_plain_calls"] == 1


def test_api_attention_rows_on_chunk_slices_matches_reference_api(
        reference, cpu_api):
    """Twin bodies hand the api ChunkSlice views of a worker's rows,
    indexed by global rows: the result must equal the reference api on
    the same global rows."""
    _, Q, K, V = _api_inputs()
    rows = rebase_chunk(Q[LO:HI].copy(), LO)
    got = cpu_api.attention_rows(rows[LO:HI, 0:12], K[0:24, 0:12],
                                 V[0:24, 0:12])
    _close(got, reference["api/chunk-view/api"], "float64",
           "chunk-slice view")
    _close(cpu_api.attention_rows(rows, K, V), reference["api/chunk/api"],
           "float64", "chunk slice")


def test_api_attention_rows_refuses_integer_operands(cpu_api):
    ints = np.arange(6, dtype=np.int64).reshape(2, 3)
    with pytest.raises(TypeError, match="cuda-lowering-infeasible"):
        cpu_api.attention_rows(ints, ints, ints)


@pytest.mark.parametrize("b", [1, 2])
def test_gqa_dispatch_hands_the_kernel_contiguous_heads(monkeypatch, b):
    """The regroup gives the (BH, S, D) function contiguous operands,
    which the kernel requires, at B = 1 too (where a reshape of the
    head-major view would not copy)."""
    seen = []

    def bhsd(q, k, v, **opts):
        seen.append([t.is_contiguous() for t in (q, k, v)])
        return flash_attention_bhsd_ref(q, k, v, **opts)

    monkeypatch.setattr(ops, "flash_attention_bhsd", bhsd)
    rng = np.random.default_rng(b)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, 24, h, 8)))
               for h in (4, 2, 2))
    got = ops.flash_attention(q, k, v, causal=True)
    assert seen == [[True, True, True]]
    _close(got.numpy(), attention_ref(q, k, v, causal=True).numpy(),
           "float64", f"b={b}")


def test_kernel_wrapper_refuses_cpu_tensors():
    t = torch.ones(1, 4, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.flash_attention_bhsd(t, t, t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_cuda_kernel_matches_plain_version(cuda_device, case, dtype):
    _, _, causal, window, softcap, _ = case
    q, k, v = (torch.from_numpy(a).to(cuda_device, TORCH_DT[dtype])
               for a in _inputs(case))
    opts = dict(causal=causal, window=window, softcap=softcap)
    before = kernel.launches
    got = ops.flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == TORCH_DT[dtype] and got.is_cuda
    want = attention_ref(q, k, v, **opts)
    _close(got.double().cpu().numpy(), want.double().cpu().numpy(), dtype,
           _key(case[0], dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 24, 72, 128, 200, 288])
def test_cuda_kernel_head_dims(cuda_device, d, dtype):
    """Every tile class the kernels instantiate (the float64 tile's
    D-classes 32, 64, 128, 192, 288 included; D = 1 and 24 are
    zero-filled to 32), up to gemma2_2b's 288, ragged and windowed,
    through the bhsd layout."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, s, d)) * d ** -0.25)
               .to(cuda_device, TORCH_DT[dtype]) for s in (100, 77, 77))
    opts = dict(causal=True, window=40, softcap=30.0)
    got = kernel.flash_attention_bhsd(q, k, v, **opts)
    want = flash_attention_bhsd_ref(q, k, v, **opts)
    _close(got.double().cpu().numpy(), want.double().cpu().numpy(), dtype,
           f"d={d}")
