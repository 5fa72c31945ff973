"""The gradient of the port's flash attention against the reference's.

The op (``repro_torch.kernels.flash_attention.ops``) runs through its
``torch.autograd.Function`` whenever an operand requires grad; on CPU
tensors its backward is the plain ``flash_attention_bhsd_bwd_ref``. Its
gradients through the GQA dispatch are held, on the same inputs made
from a numpy seed, to ``jax.grad`` of the reference's attention: float32
to the model's ``plain_attention`` and ``chunked_attention`` (16-key
chunks), float64 to the kernel's oracle ``attention_ref``
(``plain_attention`` takes its scores in float32 whatever the operands,
``preferred_element_type``, so only the oracle is a float64 reference).
Cases: causal, sliding window, tanh softcap, GQA, Sq != Skv
(non-causal, as cross attention), Sq > Skv (causal), head dims past 128
(144 and gemma2_2b's 288). Tolerances, on the
largest difference relative to the largest reference value: float64
1e-10, float32 1e-5. The plain backward is also held to autograd of the
plain forward ``flash_attention_bhsd_ref`` at float64 (1e-12).

The gradient with a query offset (one for all rows, or one per batch
row) and through rows with no valid key (a window past the last key,
Sq >= Skv + window; the forward gives such a row the mean of V, and its
gradient adds dO / Skv to dV of every key and nothing to dQ or dK) is
held to ``jax.grad`` of the reference's ``plain_attention`` and
``chunked_attention`` with the same ``q_offset`` (float32, 1e-5), and
the plain backward to autograd of the plain forward at float64 (1e-12).
The selective scan's op, asked for a gradient with tensors that claim
to be on the card, reaches the backward kernel's entry and never the
plain backward. The reference side runs once per module in a
subprocess (``tests/torch_reference.py``). The backward kernels run
only on a card: their tests carry the ``cuda`` marker and skip here.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as kernel
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bhsd_bwd_ref, flash_attention_bhsd_ref)
from repro_torch.kernels.mamba_scan import ops as scan_ops
from torch_reference import run_reference

TOL = {"float32": 1e-5, "float64": 1e-10}
TORCH_DT = {"float32": torch.float32, "float64": torch.float64,
            "bfloat16": torch.bfloat16}

# (id, (B, Sq, Skv, H, KVH, D), causal, window, softcap)
CASES = [
    ("causal", (2, 40, 40, 4, 4, 16), True, 0, 0.0),
    ("gqa-window-cap", (1, 48, 48, 4, 2, 16), True, 16, 30.0),
    ("cross", (2, 24, 40, 4, 2, 8), False, 0, 0.0),
    ("cross-cap", (1, 30, 18, 2, 1, 16), False, 0, 20.0),
    ("window-noncausal", (1, 40, 40, 2, 2, 8), False, 8, 0.0),
    ("causal-sq-over-skv", (1, 30, 20, 2, 1, 8), True, 0, 10.0),
    # head dims past 128, as gemma2_2b's 288
    ("d144-gqa-window-cap", (1, 40, 40, 4, 2, 144), True, 12, 30.0),
    ("d288-causal-cap", (1, 24, 24, 2, 1, 288), True, 0, 50.0),
]
CASE_IDS = [c[0] for c in CASES]
# (id, (B, Sq, Skv, H, KVH, D), causal, window, softcap, q_offset: an
# int for every row or one per batch row); the last three have rows with
# no valid key
OFFSET_CASES = [
    ("offset-scalar", (2, 8, 40, 4, 2, 16), True, 0, 0.0, 24),
    ("offset-per-batch", (3, 5, 32, 4, 4, 8), True, 12, 20.0, [3, 17, 27]),
    ("empty-rows", (1, 30, 12, 2, 1, 8), True, 8, 0.0, 0),
    ("empty-rows-noncausal", (2, 24, 10, 2, 2, 8), False, 6, 10.0, 0),
    ("offset-empty-rows", (2, 6, 16, 2, 1, 8), True, 4, 0.0, [14, 19]),
]
OFFSET_IDS = [c[0] for c in OFFSET_CASES]

_REFERENCE = """
import jax.numpy as jnp
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.common import chunked_attention, plain_attention
for key in sorted({k.rsplit("/", 1)[0] for k in inputs}):
    q, k, v, g = (jnp.asarray(inputs[key + "/" + n]) for n in "qkvg")
    causal, window, cap = inputs[key + "/opts"]
    causal, window, cap = bool(causal), int(window), float(cap)
    fns = {"oracle": lambda q, k, v: attention_ref(
        q, k, v, causal=causal, window=window, softcap=cap)}
    if key.endswith("float32"):
        fns["plain"] = lambda q, k, v: plain_attention(
            q, k, v, causal=causal, window=window, cap=cap)
        fns["chunked"] = lambda q, k, v: chunked_attention(
            q, k, v, causal=causal, window=window, cap=cap, chunk=16)
    for name, fn in fns.items():
        grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * g),
                                 argnums=(0, 1, 2)))(q, k, v)
        for n, gr in zip("qkv", grads):
            outputs[f"{key}/{name}/d{n}"] = np.asarray(gr, np.float64)
"""


def _inputs(case):
    case_id, (b, sq, skv, h, kvh, d), *_ = case
    rng = np.random.default_rng(sq * 3 + skv + h + d + len(case_id))
    return (rng.normal(size=(b, sq, h, d)), rng.normal(size=(b, skv, kvh, d)),
            rng.normal(size=(b, skv, kvh, d)), rng.normal(size=(b, sq, h, d)))


_OFFSET_REFERENCE = """
import jax.numpy as jnp
from repro.models.common import chunked_attention, plain_attention
for key in sorted({k.rsplit("/", 1)[0] for k in inputs}):
    q, k, v, g = (jnp.asarray(inputs[key + "/" + n]) for n in "qkvg")
    causal, window, cap = inputs[key + "/opts"]
    causal, window, cap = bool(causal), int(window), float(cap)
    off = jnp.asarray(inputs[key + "/offset"])
    fns = {"plain": lambda q, k, v: plain_attention(
               q, k, v, causal=causal, window=window, cap=cap, q_offset=off),
           "chunked": lambda q, k, v: chunked_attention(
               q, k, v, causal=causal, window=window, cap=cap, chunk=16,
               q_offset=off)}
    for name, fn in fns.items():
        grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * g),
                                 argnums=(0, 1, 2)))(q, k, v)
        for n, gr in zip("qkv", grads):
            outputs[f"{key}/{name}/d{n}"] = np.asarray(gr, np.float64)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference gradients, from one subprocess."""
    inputs = {}
    for case in CASES:
        _, _, causal, window, softcap = case
        for dtype in TOL:
            key = f"{case[0]}/{dtype}"
            for n, a in zip("qkvg", _inputs(case)):
                inputs[f"{key}/{n}"] = a.astype(dtype)
            inputs[f"{key}/opts"] = np.array([causal, window, softcap])
    return run_reference(_REFERENCE, inputs,
                         tmp_path_factory.mktemp("flash_bwd_reference"))


@pytest.fixture(scope="module")
def offset_reference(tmp_path_factory):
    """Every offset case's reference gradients (float32), from one
    subprocess."""
    inputs = {}
    for case in OFFSET_CASES:
        _, _, causal, window, softcap, off = case
        for n, a in zip("qkvg", _inputs(case)):
            inputs[f"{case[0]}/{n}"] = a.astype(np.float32)
        inputs[f"{case[0]}/opts"] = np.array([causal, window, softcap])
        inputs[f"{case[0]}/offset"] = np.asarray(off, np.int32)
    return run_reference(_OFFSET_REFERENCE, inputs,
                         tmp_path_factory.mktemp("flash_offset_reference"))


def _offset(case, device="cpu"):
    off = case[5] if len(case) > 5 else 0
    return torch.tensor(off, dtype=torch.int32, device=device) \
        if isinstance(off, list) else off


def _grads(case, dtype, device="cpu"):
    """(dq, dk, dv) of the op through the GQA dispatch, and its output."""
    causal, window, softcap = case[2:5]
    q, k, v, g = (torch.from_numpy(a).to(device, TORCH_DT[dtype])
                  for a in _inputs(case))
    for t in (q, k, v):
        t.requires_grad_(True)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap,
                              q_offset=_offset(case, device))
    assert out.grad_fn is not None
    return torch.autograd.grad(out, (q, k, v), g), out


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_gradient_matches_reference_autodiff(reference, case, dtype):
    before = ops.plain_calls
    grads, _ = _grads(case, dtype)
    # one plain forward and one plain backward on the CPU
    assert ops.plain_calls == before + 2
    names = ["oracle"] + (["plain", "chunked"] if dtype == "float32" else [])
    for name in names:
        for n, got in zip("qkv", grads):
            want = reference[f"{case[0]}/{dtype}/{name}/d{n}"]
            err = _rel(got.detach().numpy(), want)
            assert err <= TOL[dtype], (name, n, err)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plain_backward_matches_autograd_of_plain_forward(case):
    _, (b, sq, skv, h, kvh, d), causal, window, softcap = case
    rng = np.random.default_rng(len(case[0]))
    q, k, v = (torch.from_numpy(rng.normal(size=(b * h, s, d)))
               .requires_grad_(True) for s in (sq, skv, skv))
    do = torch.from_numpy(rng.normal(size=(b * h, sq, d)))
    opts = dict(causal=causal, window=window, softcap=softcap)
    out, lse = flash_attention_bhsd_ref(q, k, v, return_lse=True, **opts)
    assert torch.equal(out, flash_attention_bhsd_ref(q, k, v, **opts))
    want = torch.autograd.grad(out, (q, k, v), do)
    got = flash_attention_bhsd_bwd_ref(q.detach(), k.detach(), v.detach(),
                                       out.detach(), do, lse.detach(),
                                       **opts)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) <= 1e-12


def test_lse_is_the_log_of_each_rows_softmax_denominator():
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.normal(size=(2, n, 8))) for n in (9, 13))
    _, lse = flash_attention_bhsd_ref(q, k, k, causal=True, window=4,
                                      softcap=5.0, return_lse=True)
    s = torch.tanh(q @ k.transpose(1, 2) / 8 ** 0.5 / 5.0) * 5.0
    i, j = torch.arange(9)[:, None], torch.arange(13)[None]
    s = s.masked_fill(~((j <= i) & (j > i - 4)), -float("inf"))
    assert torch.allclose(lse, torch.logsumexp(s, dim=-1), rtol=0,
                          atol=1e-14)


def test_no_grad_call_is_the_forward_alone():
    t = torch.ones(1, 4, 2, 8, dtype=torch.float64, requires_grad=True)
    with torch.no_grad():
        out = ops.flash_attention(t, t, t)
    assert out.grad_fn is None and not out.requires_grad
    plain = ops.flash_attention(t.detach(), t.detach(), t.detach())
    assert plain.grad_fn is None


def _hold_offset_case(offset_reference, case):
    grads, out = _grads(case, "float32")
    assert bool(torch.isfinite(out).all())
    for name in ("plain", "chunked"):
        for n, got in zip("qkv", grads):
            want = offset_reference[f"{case[0]}/{name}/d{n}"]
            err = _rel(got.detach().numpy(), want)
            assert err <= TOL["float32"], (case[0], name, n, err)


def test_gradient_with_a_query_offset_matches_reference_autodiff(
        offset_reference):
    """The gradient with a query offset, one for every row and one per
    batch row, against jax.grad of the reference's attention at that
    offset."""
    for case in OFFSET_CASES[:2]:
        _hold_offset_case(offset_reference, case)


def test_gradient_through_rows_without_a_key_matches_reference_autodiff(
        offset_reference):
    """Rows with no valid key (window > 0, Sq >= Skv + window; and past
    an offset): against jax.grad of the reference's attention, where such
    a row's softmax is uniform over every key, so dV gains dO / Skv and
    dQ is 0."""
    for case in OFFSET_CASES[2:]:
        _hold_offset_case(offset_reference, case)
        grads, _ = _grads(case, "float32")
        b, sq, skv, h = case[1][:4]
        off = torch.as_tensor(case[5]).reshape(-1, 1) + torch.arange(sq)
        empty = (off - case[3] + 1 >= skv).expand(b, sq)     # no key left
        assert bool(empty.any())
        assert float(grads[0][empty].abs().max()) == 0.0


@pytest.mark.parametrize("case", OFFSET_CASES, ids=OFFSET_IDS)
def test_plain_backward_with_offsets_matches_autograd_of_plain_forward(
        case):
    _, (b, sq, skv, h, kvh, d), causal, window, softcap, off = case
    rng = np.random.default_rng(len(case[0]) + 1)
    q, k, v = (torch.from_numpy(rng.normal(size=(b * h, s, d)))
               .requires_grad_(True) for s in (sq, skv, skv))
    do = torch.from_numpy(rng.normal(size=(b * h, sq, d)))
    offset = torch.tensor(off, dtype=torch.int32).reshape(-1).expand(b) \
        .repeat_interleave(h) if isinstance(off, list) else off
    opts = dict(causal=causal, window=window, softcap=softcap,
                q_offset=offset)
    out, lse = flash_attention_bhsd_ref(q, k, v, return_lse=True, **opts)
    want = torch.autograd.grad(out, (q, k, v), do)
    got = flash_attention_bhsd_bwd_ref(q.detach(), k.detach(), v.detach(),
                                       out.detach(), do, lse.detach(),
                                       **opts)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) <= 1e-12


def test_scan_gradient_on_the_card_reaches_the_backward_kernel(monkeypatch):
    """With grad asked for on the card, the scan op launches the forward
    kernel keeping its states and its backward reaches the backward
    kernel's entry, never the plain backward; without grad, the forward
    alone."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda s: True))
    launched, backward = [], []

    def forward(x, dt, bm, cm, a, d_skip, return_state=False,
                save_states=False):
        launched.append(save_states)
        y = x * 2.0
        h = torch.zeros(x.shape[0], x.shape[2], bm.shape[-1])
        return (y, h, torch.ones(1)) if save_states else y

    def bwd(x, dt, bm, cm, a, d_skip, dy, states, dh_last=None):
        backward.append(states)
        return tuple(torch.full_like(t, 3.0) for t in (x, dt, bm, cm, a,
                                                       d_skip))

    def plain(*args, **kwargs):
        raise AssertionError("the plain backward ran for a card tensor")

    monkeypatch.setattr(scan_ops._kernel, "mamba_scan", forward)
    monkeypatch.setattr(scan_ops._kernel, "mamba_scan_bwd", bwd)
    monkeypatch.setattr(scan_ops, "mamba_scan_bwd_ref", plain)
    x = torch.ones(1, 4, 3, requires_grad=True)
    bm = torch.ones(1, 4, 2)
    args = (x, torch.ones(1, 4, 3), bm, bm, torch.zeros(3, 2),
            torch.zeros(3))
    y = scan_ops.mamba_scan(*args)
    assert y.grad_fn is not None and launched == [True]
    (gx,) = torch.autograd.grad(y.sum(), x)
    assert len(backward) == 1 and torch.equal(backward[0], torch.ones(1))
    assert torch.equal(gx, torch.full_like(x, 3.0))
    with torch.no_grad():          # serving: the forward kernel alone
        scan_ops.mamba_scan(*args)
    assert launched == [True, False] and len(backward) == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written backward "
                    "kernels have no CPU mode")
    return torch.device("cuda")


# the card's cases: (B·H, Sq, Skv, D), causal, window, softcap; ragged
# tiles, every D class, Sq != Skv both ways. Five aim at the bf16
# tensor-core kernels' tiles up to D = 128 (128 keys a dK/dV block, 64
# rows a step or a dQ block): more than one full tile and a ragged edge
# on both Sq and Skv, a window and a softcap at D = 128, D = 72 (padded
# to 80) and D = 20 (rows not in 16-byte chunks). The last seven at
# their tiles past D = 128 (64 keys a dK/dV block, 32 rows a step; 64
# rows a dQ block, 64 keys a step; D padded to a multiple of 32): D = 288
# over several tiles with ragged ends both ways, with and without a
# window, softcapped; the classes' edges (129 and 160 in the class of
# 160, 256) and D = 144; D = 138 (rows not in 16-byte chunks)
CUDA_CASES = [((3, 100, 100, 64), True, 0, 0.0),
              ((2, 77, 130, 40), False, 0, 30.0),
              ((2, 150, 90, 80), True, 0, 0.0),
              ((2, 200, 200, 24), True, 40, 50.0),
              ((1, 120, 120, 128), False, 32, 0.0),
              ((1, 70, 70, 192), True, 0, 20.0),
              ((1, 66, 66, 288), True, 16, 50.0),
              ((2, 200, 137, 80), True, 0, 0.0),
              ((2, 129, 300, 64), False, 0, 0.0),
              ((1, 257, 257, 128), True, 64, 30.0),
              ((2, 190, 210, 72), True, 0, 0.0),
              ((1, 100, 90, 20), False, 0, 0.0),
              ((2, 300, 277, 288), True, 0, 50.0),
              ((2, 300, 277, 288), True, 64, 50.0),
              ((1, 100, 120, 129), False, 0, 0.0),
              ((1, 130, 130, 160), True, 32, 0.0),
              ((1, 200, 230, 144), False, 48, 30.0),
              ((1, 150, 150, 256), True, 0, 0.0),
              ((2, 140, 170, 138), True, 0, 20.0)]
CUDA_TOL = {"float64": 1e-8, "float32": 2e-4, "bfloat16": 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(CUDA_TOL))
@pytest.mark.parametrize("case", CUDA_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3]}"
                              for c in CUDA_CASES])
def test_cuda_backward_matches_plain_backward(cuda_device, case, dtype):
    (bh, sq, skv, d), causal, window, softcap = case
    rng = np.random.default_rng(bh + sq + d)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(bh, n, d)))
                   .to(cuda_device, TORCH_DT[dtype])
                   for n in (sq, skv, skv, sq))
    opts = dict(causal=causal, window=window, softcap=softcap)
    out, lse = kernel.flash_attention_bhsd(q, k, v, return_lse=True, **opts)
    want_out, want_lse = flash_attention_bhsd_ref(q, k, v, return_lse=True,
                                                  **opts)
    tol = CUDA_TOL[dtype]
    assert float((lse - want_lse).abs().max()) <= tol * (
        1 + float(want_lse.abs().max()))
    before = kernel.bwd_launches
    got = kernel.flash_attention_bhsd_bwd(q, k, v, out, do, lse, **opts)
    torch.cuda.synchronize()
    assert kernel.bwd_launches == before + 1
    want = flash_attention_bhsd_bwd_ref(q, k, v, out, do, lse, **opts)
    for g, w in zip(got, want):
        diff = (g.double() - w.double()).abs()
        allowed = tol if dtype == "float64" else tol + tol * w.double().abs()
        assert bool(torch.isfinite(g.double()).all())
        assert not bool((diff > allowed).any()), float(diff.max())
    again = kernel.flash_attention_bhsd_bwd(q, k, v, out, do, lse, **opts)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_gradient_through_the_gqa_dispatch(cuda_device):
    case = CASES[1]
    got, out = _grads(case, "float32", cuda_device)
    want, _ = _grads(case, "float32")
    assert out.is_cuda
    for g, w in zip(got, want):
        assert _rel(g.cpu().numpy(), w.numpy()) <= 2e-4


# the card's cases with query offsets (one per batch-head) and with rows
# that have no valid key: (B·H, Sq, Skv, D), causal, window, softcap,
# offsets (None: every row at its index). A decode-like step of four
# rows at their own positions, a prefill chunk past its slot's start,
# empty rows on the tensor-core tiles up to D = 128 and past them, and
# at D = 288 an offset per batch-head that leaves the first one's last
# rows with no key (positions 231.. past a window of 32 over 200 keys)
OFFSET_CUDA_CASES = [((4, 1, 300, 64), True, 0, 0.0, [10, 100, 200, 299]),
                     ((2, 70, 200, 80), True, 0, 0.0, [130, 0]),
                     ((2, 150, 60, 64), True, 32, 0.0, None),
                     ((2, 130, 40, 128), False, 16, 30.0, [0, 5]),
                     ((1, 90, 40, 288), True, 20, 50.0, None),
                     ((2, 60, 200, 288), True, 32, 50.0, [180, 0])]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(CUDA_TOL))
@pytest.mark.parametrize("case", OFFSET_CUDA_CASES,
                         ids=[f"{c[0]}-{c[4]}" for c in OFFSET_CUDA_CASES])
def test_cuda_backward_with_offsets_and_empty_rows(cuda_device, case,
                                                   dtype):
    (bh, sq, skv, d), causal, window, softcap, off = case
    rng = np.random.default_rng(bh + sq + skv + d)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(bh, n, d)))
                   .to(cuda_device, TORCH_DT[dtype])
                   for n in (sq, skv, skv, sq))
    offset = None if off is None else torch.tensor(
        off, dtype=torch.int32, device=cuda_device)
    opts = dict(causal=causal, window=window, softcap=softcap,
                q_offset=offset)
    out, lse = kernel.flash_attention_bhsd(q, k, v, return_lse=True, **opts)
    got = kernel.flash_attention_bhsd_bwd(q, k, v, out, do, lse, **opts)
    torch.cuda.synchronize()
    want = flash_attention_bhsd_bwd_ref(q, k, v, out, do, lse, **opts)
    tol = CUDA_TOL[dtype]
    for g, w in zip(got, want):
        diff = (g.double() - w.double()).abs()
        allowed = tol if dtype == "float64" else tol + tol * w.double().abs()
        assert bool(torch.isfinite(g.double()).all())
        assert not bool((diff > allowed).any()), float(diff.max())
    again = kernel.flash_attention_bhsd_bwd(q, k, v, out, do, lse, **opts)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_bf16_backward_past_128_runs_the_tensor_core_kernels(
        cuda_device):
    """A bf16 call at D = 288 runs mma_dkdv_kernel and mma_dq_kernel (and
    the preamble), by their names in torch.profiler's trace, and none of
    the FMA kernels dkdv_kernel and dq_kernel."""
    import re

    rng = np.random.default_rng(29)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, n, 288)))
                   .to(cuda_device, torch.bfloat16)
                   for n in (200, 200, 200, 200))
    opts = dict(causal=True, window=64, softcap=50.0)
    out, lse = kernel.flash_attention_bhsd(q, k, v, return_lse=True, **opts)
    kernel.flash_attention_bhsd_bwd(q, k, v, out, do, lse, **opts)
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        kernel.flash_attention_bhsd_bwd(q, k, v, out, do, lse, **opts)
        torch.cuda.synchronize()
    ran = {m.group(1) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           for m in [re.search(r"(\w+_kernel)\b", e.name)] if m}
    assert {"mma_dkdv_kernel", "mma_dq_kernel"} <= ran, ran
    assert not ran & {"dkdv_kernel", "dq_kernel"}, ran
