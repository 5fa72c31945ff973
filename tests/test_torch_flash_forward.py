"""The bf16 flash-attention forward's two kernels (the tensor-core
prefill and the split-KV decode) and its grouped-query entry.

On the CPU: the plain version of the decode's partition
(``ref.attention_split_ref``: each key split's (m, l, acc), merged in
split order) is held to the reference model's ``plain_attention`` (the
offset tests' oracle, run in a subprocess by ``tests/torch_reference.py``)
at 1, 2, 7 and Skv splits, with offsets per batch row, windows, a
softcap, GQA 1/2/8, rows with no valid key anywhere and splits with no
valid key for any row; float32 within 2e-4, bfloat16 2e-2 (absolute and
relative). The reference's ``plain_attention`` takes its scores in
float32 whatever the operands' dtype, so float64 is held to it within
2e-4 and, within 1e-8, to the port's plain GQA attention (``attention_ref``,
which ``tests/test_torch_flash_attention.py`` holds to the reference's
float64 oracle). ``flash_attention_gqa``'s argument checks, and
the dispatch: bf16 on the card with no gradient recorded goes to the
grouped-query entry with no regroup, every other call through the
regroup (a card is posed by patching ``Tensor.is_cuda``; nothing
launches).

On the card (``cuda`` marker; they skip here): each kernel against the
plain versions at D in {1, 24, 64, 72, 80, 128, 200, 288} and G in {1, 2,
8}, with Sq on both sides of the kernel rule's threshold (Sq x G <= 16:
the decode) and across several query blocks, with offsets, a window, the
softcap and rows with no valid key, K/V as non-contiguous slices of a
larger cache, the logsumexp, and the same bits on a second call.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as kernel
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    attention_ref, attention_split_ref, flash_attention_bhsd_ref)
from torch_reference import run_reference

TOL = {"float32": 2e-4, "bfloat16": 2e-2, "float64": 1e-8}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float64": torch.float64}
DTYPES = sorted(TOL)
# the decode kernel takes Sq x G query rows up to this (csrc DEC_ROWS)
DEC_ROWS = 16

# (id, (B, Sq, Skv, H, KVH, D), causal, window, softcap, q_offset: an int
# or one per batch row)
SPLIT_CASES = [
    # decode steps of 3 slots, GQA 8: slot 1 past the cache's end with no
    # key in its window (it averages v); splits before slot 2's window
    # hold no valid key for any of its rows
    ("decode-gqa8-window", (3, 1, 40, 8, 1, 16), True, 8, 30.0,
     [45, 60, 20]),
    ("decode-gqa2-cap", (3, 2, 40, 4, 2, 16), True, 0, 20.0, [0, 17, 37]),
    # rows before key 0 under the causal mask have none
    ("before-key-0", (2, 4, 33, 2, 2, 8), True, 0, 0.0, [-3, 2]),
    ("noncausal-window", (2, 6, 30, 2, 1, 8), False, 5, 10.0, [3, 27]),
    ("prefill-int", (2, 12, 40, 8, 8, 16), True, 16, 0.0, 5),
]
SPLIT_IDS = [c[0] for c in SPLIT_CASES]
SPLITS = [1, 2, 7, "skv"]

_REFERENCE = """
import jax.numpy as jnp
from repro.models.common import plain_attention
for key in sorted({k.rsplit("/", 1)[0] for k in inputs}):
    q, k, v = (inputs[key + "/" + n] for n in "qkv")
    dtype = key.split("/")[1]
    causal, window, softcap = inputs[key + "/opts"]
    off = inputs[key + "/offset"]
    got = plain_attention(
        *(jnp.asarray(a, dtype) for a in (q, k, v)),
        causal=bool(causal), window=int(window), cap=float(softcap),
        q_offset=int(off) if off.ndim == 0 else jnp.asarray(off))
    outputs[key + "/plain"] = np.asarray(got.astype(jnp.float64))
"""


def _inputs(case):
    case_id, (b, sq, skv, h, kvh, d), *_ = case
    rng = np.random.default_rng(sq + 3 * h + d + len(case_id))
    return (rng.normal(size=(b, sq, h, d)), rng.normal(size=(b, skv, kvh, d)),
            rng.normal(size=(b, skv, kvh, d)))


def _offset(off, device="cpu"):
    return off if isinstance(off, int) else torch.tensor(
        off, dtype=torch.int32, device=device)


def _close(got, want, dtype, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=TOL[dtype], rtol=TOL[dtype],
                               err_msg=what)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    inputs = {}
    for case in SPLIT_CASES:
        _, _, causal, window, softcap, off = case
        for dtype in DTYPES:
            key = f"{case[0]}/{dtype}"
            for name, arr in zip("qkv", _inputs(case)):
                inputs[f"{key}/{name}"] = arr
            inputs[key + "/opts"] = np.asarray([causal, window, softcap],
                                               np.float64)
            inputs[key + "/offset"] = np.asarray(off, np.int32)
    return run_reference(_REFERENCE, inputs,
                         tmp_path_factory.mktemp("flash_forward_reference"))


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SPLIT_CASES, ids=SPLIT_IDS)
def test_split_partition_matches_reference_plain_attention(reference, case,
                                                           dtype, splits):
    _, (b, sq, skv, h, kvh, d), causal, window, softcap, off = case
    q, k, v = (torch.from_numpy(a).to(TORCH_DT[dtype])
               for a in _inputs(case))
    opts = dict(causal=causal, window=window, softcap=softcap,
                q_offset=_offset(off))
    n = skv if splits == "skv" else splits
    got, lse = attention_split_ref(q, k, v, splits=n, return_lse=True,
                                   **opts)
    assert got.dtype == TORCH_DT[dtype] and tuple(got.shape) == (b, sq, h, d)
    what = f"{case[0]} {dtype} splits={n}"
    _close(got.double().numpy(), reference[f"{case[0]}/{dtype}/plain"],
           "float32" if dtype == "float64" else dtype, what)
    if dtype == "float64":
        _close(got.numpy(), attention_ref(q, k, v, **opts).numpy(), dtype,
               what)
    # the logsumexp is the one-split (whole-row) softmax's
    _, whole = attention_split_ref(q, k, v, splits=1, return_lse=True,
                                   **opts)
    acc = "float64" if dtype == "float64" else "float32"
    _close(lse.numpy(), whole.numpy(), acc, f"{case[0]} lse")


def test_split_partition_has_splits_without_a_key_and_rows_without_one():
    """The cases hold what the kernel's combine must get right: a row
    with no valid key anywhere, and splits that hold no valid key for
    any row of a batch row."""
    _, (b, sq, skv, h, kvh, d), causal, window, _, off = SPLIT_CASES[0]
    pos = torch.tensor(off)[:, None] + torch.arange(sq)
    keys = torch.arange(skv)
    valid = (keys <= pos[..., None]) & (keys > pos[..., None] - window)
    assert bool((~valid.any(-1)).any())                  # slot 1
    split = -(-skv // 7)
    empty = [not bool(valid[2, :, s:s + split].any())
             for s in range(0, skv, split)]
    assert any(empty) and not all(empty)                 # slot 2


def _pose_card(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda s: True))


def test_gqa_kernel_refuses_cpu_tensors():
    q = torch.ones(1, 4, 2, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.flash_attention_gqa(q, q[:, :, :1], q[:, :, :1])


def test_gqa_kernel_refuses_what_it_does_not_take(monkeypatch):
    """Each refusal comes before the library is touched."""
    _pose_card(monkeypatch)
    q = torch.ones(2, 4, 4, 8, dtype=torch.bfloat16)
    kv = torch.ones(2, 6, 2, 8, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        kernel.flash_attention_gqa(q, kv.float(), kv)
    with pytest.raises(TypeError, match="bfloat16"):
        kernel.flash_attention_gqa(q.float(), kv.float(), kv.float())
    with pytest.raises(ValueError, match="multiple of KVH"):
        kernel.flash_attention_gqa(q[:, :, :3], kv, kv)
    with pytest.raises(ValueError, match="unit stride in D"):
        wide = torch.ones(2, 6, 2, 16, dtype=torch.bfloat16)
        kernel.flash_attention_gqa(q, wide[..., ::2], kv)
    with pytest.raises(ValueError, match="q_offset"):
        kernel.flash_attention_gqa(
            q, kv, kv, q_offset=torch.zeros(2, dtype=torch.int64))


def _dispatch(monkeypatch, dtype, grad):
    """(calls of the grouped-query entry, calls of the bhsd op) of one
    ops.flash_attention call on a posed card."""
    _pose_card(monkeypatch)
    gqa, bhsd = [], []

    def fake_gqa(q, k, v, **opts):
        gqa.append(opts)
        return attention_ref(q, k, v, **opts)

    def fake_bhsd(q, k, v, **opts):
        bhsd.append(opts)
        return flash_attention_bhsd_ref(q, k, v, **opts)

    monkeypatch.setattr(kernel, "flash_attention_gqa", fake_gqa)
    monkeypatch.setattr(ops, "flash_attention_bhsd", fake_bhsd)
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, h, 8))).to(dtype)
               .requires_grad_(grad) for h in (4, 2, 2))
    ops.flash_attention(q, k, v, q_offset=torch.tensor([4, 9]))
    return gqa, bhsd


def test_served_bf16_call_takes_the_grouped_query_entry(monkeypatch):
    gqa, bhsd = _dispatch(monkeypatch, torch.bfloat16, grad=False)
    assert len(gqa) == 1 and not bhsd
    off = gqa[0]["q_offset"]
    assert off.dtype == torch.int32 and off.tolist() == [4, 9]


@pytest.mark.parametrize("dtype,grad", [(torch.bfloat16, True),
                                        (torch.float32, False)])
def test_gradient_or_float32_call_keeps_the_regroup(monkeypatch, dtype,
                                                    grad):
    gqa, bhsd = _dispatch(monkeypatch, dtype, grad)
    assert not gqa and len(bhsd) == 1
    assert bhsd[0]["q_offset"].tolist() == [4, 4, 4, 4, 9, 9, 9, 9]


def test_batch_offset_keeps_an_int32_offset_in_place():
    """A served offset, int32 (B,) on the device, is passed on with no
    copy (no kernel in the served call); the rest are converted."""
    off = torch.tensor([3, 5], dtype=torch.int32)
    assert ops.batch_offset(off, 2, off.device).data_ptr() == off.data_ptr()
    assert ops.batch_offset(0, 2, "cpu") is None
    assert ops.batch_offset(7, 3, "cpu").tolist() == [7, 7, 7]
    assert ops.batch_offset(torch.tensor(2), 2, "cpu").tolist() == [2, 2]


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def _cache_slices(rng, b, sq, skv, h, kvh, d, device):
    """q (B, Sq, H, D), and k, v as non-contiguous slices of one larger
    cache (B, Skv + 13, 2, KVH, D), bf16 on the card."""
    q = torch.from_numpy(rng.normal(size=(b, sq, h, d)) * d ** -0.25)
    cache = torch.from_numpy(rng.normal(size=(b, skv + 13, 2, kvh, d)))
    q, cache = (t.to(device, torch.bfloat16) for t in (q, cache))
    return q, cache[:, :skv, 0], cache[:, :skv, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["decode", "past_threshold", "blocks"])
@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("d", [1, 24, 64, 72, 80, 128, 200, 288])
def test_cuda_gqa_kernels_match_plain_versions(cuda_device, d, g, rows):
    """Sq x G at the decode's limit, one query row past it, and across
    several 64-row blocks; 3 batch rows at their own offsets (one past
    the cache with no key in the window: it averages v), a window, the
    softcap; the logsumexp; the same bits on a second call."""
    sq = {"decode": DEC_ROWS // g, "past_threshold": DEC_ROWS // g + 1,
          "blocks": 150}[rows]
    kvh = 2
    rng = np.random.default_rng(d * 10 + g)
    q, k, v = _cache_slices(rng, 3, sq, 300, kvh * g, kvh, d, cuda_device)
    off = torch.tensor([0, 400, 150], dtype=torch.int32, device=cuda_device)
    for causal, window, cap in ((True, 64, 30.0), (True, 0, 0.0),
                                (False, 40, 0.0)):
        opts = dict(causal=causal, window=window, softcap=cap, q_offset=off)
        before = kernel.launches
        got, lse = kernel.flash_attention_gqa(q, k, v, return_lse=True,
                                              **opts)
        again = kernel.flash_attention_gqa(q, k, v, **opts)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2
        assert torch.equal(got, again)
        want = attention_ref(q, k, v, **opts)
        what = f"d={d} g={g} sq={sq} causal={causal} window={window}"
        _close(got.double().cpu().numpy(), want.double().cpu().numpy(),
               "bfloat16", what)
        _, want_lse = attention_split_ref(q, k, v, splits=1,
                                          return_lse=True, **opts)
        _close(lse.cpu().numpy(), want_lse.cpu().numpy(), "float32", what)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 16, 17, 100])
@pytest.mark.parametrize("d", [24, 80, 288])
def test_cuda_bhsd_entry_takes_both_kernels(cuda_device, d, sq):
    """The bhsd entry, the grouped-query entry's G = 1 case: the decode
    in one split up to 16 rows, the tensor cores past them."""
    rng = np.random.default_rng(d + sq)
    q, k, v = (torch.from_numpy(rng.normal(size=(4, s, d)) * d ** -0.25)
               .to(cuda_device, torch.bfloat16) for s in (sq, 500, 500))
    off = torch.tensor([0, 300, 499, 520], dtype=torch.int32,
                       device=cuda_device)
    opts = dict(causal=True, window=40, softcap=30.0, q_offset=off)
    got, lse = kernel.flash_attention_bhsd(q, k, v, return_lse=True, **opts)
    want, want_lse = flash_attention_bhsd_ref(q, k, v, return_lse=True,
                                              **opts)
    _close(got.double().cpu().numpy(), want.double().cpu().numpy(),
           "bfloat16", f"d={d} sq={sq}")
    _close(lse.cpu().numpy(), want_lse.cpu().numpy(), "float32", "lse")


@pytest.mark.cuda
def test_cuda_served_dispatch_reads_the_cache_in_place(cuda_device):
    """ops.flash_attention under inference mode on a slice of a KV cache:
    the grouped-query entry, the served decode step's result."""
    rng = np.random.default_rng(3)
    q, k, v = _cache_slices(rng, 4, 1, 2048, 16, 2, 128, cuda_device)
    off = torch.tensor([5, 700, 2000, 2047], dtype=torch.int32,
                       device=cuda_device)
    with torch.inference_mode():
        before = kernel.launches
        got = ops.flash_attention(q, k, v, causal=True, q_offset=off)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = attention_ref(q, k, v, causal=True, q_offset=off)
    _close(got.double().cpu().numpy(), want.double().cpu().numpy(),
           "bfloat16", "served decode")
