"""The gradient of the port's selective scan against the reference's.

The plain backward (``repro_torch.kernels.mamba_scan.ref.
mamba_scan_bwd_ref``) is held, on the same inputs made from a numpy
seed, to ``jax.grad`` of the reference's training scan
(``repro.models.ssm._mamba_scan_train``, an associative scan) in float32
and float64, at ragged L and N = 1, 4, 16 and 32; the case with a final
state's gradient dh_L adds the state after the last step, walked by a
``jax.lax.scan`` of the same recurrence, to the reference's loss.
Tolerance: each gradient's error norm within 1e-10 (float64) or 1e-4
(float32) of its norm. The backward kernel's decomposition
(``mamba_scan_bwd_chunked_ref``: each chunk's entry state, each chunk's
adjoint from 0, the adjoint's carry between chunks from the last chunk
back) is held to the plain backward at chunks that do and do not divide
L (1e-12 of each norm, float64), with dB and dC summed over channel
tiles that do and do not divide I, and without its carry must differ.
The op (``ops.mamba_scan``) is a ``torch.autograd.Function``: on CPU
tensors its gradient is held to autograd through the plain forward
(1e-12, float64), and to ``torch.autograd.gradcheck``. The backward
kernel runs only on a card: its tests carry the ``cuda`` marker and
skip here; they hold it to the plain backward, element by element and
in norm, and to its own bits on a second call. The reference side runs
once per module in a subprocess (``tests/torch_reference.py``).
The PTX check of the kernels' shared stores (``ptx_check``) is held to
small hand-written kernel bodies: a store in its own place, and the
same store shifted by a tile (as nvcc 12.9 compiled the one-pass double
kernels at 4-step mini-blocks), which it must report; for the float
kernel's layout, a mini-block state and a dB/dC slot in their places,
and shifted into the staged rows, another warp's slots or past the end.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba_scan import mamba_scan as kernel
from repro_torch.kernels.mamba_scan import ops, ptx_check
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_bwd_chunked_ref,
                                                mamba_scan_bwd_ref,
                                                mamba_scan_promoted_ref)
from torch_reference import run_reference

NORM_TOL = {"float32": 1e-4, "float64": 1e-10}
TORCH_DT = {"float32": torch.float32, "float64": torch.float64,
            "bfloat16": torch.bfloat16}
NAMES = ("dx", "ddt", "dB", "dC", "da", "dd_skip")

# (id, (B, L, I, N), with the final state's gradient)
CASES = [("ragged-n4", (2, 37, 5, 4), False),
         ("n1", (1, 50, 6, 1), False),
         ("n32", (1, 29, 3, 32), False),
         ("n16-long", (1, 130, 4, 16), False),
         ("n4-final-state", (2, 45, 5, 4), True)]
CASE_IDS = [c[0] for c in CASES]

_REFERENCE = """
import jax.numpy as jnp
from repro.models.ssm import _mamba_scan_train


def final_state(x, dt, bm, a):
    def step(h, t):
        xt, dtt, bt = t
        h = jnp.exp(dtt[..., None] * -jnp.exp(a)) * h \\
            + (dtt * xt)[..., None] * bt[:, None, :]
        return h, None
    h0 = jnp.zeros(x.shape[:1] + a.shape, x.dtype)
    h, _ = jax.lax.scan(step, h0, (x.swapaxes(0, 1), dt.swapaxes(0, 1),
                                   bm.swapaxes(0, 1)))
    return h


for key in sorted({k.rsplit("/", 1)[0] for k in inputs}):
    ops = [jnp.asarray(inputs[key + "/" + n])
           for n in ("x", "dt", "B", "C", "a", "d")]
    g = jnp.asarray(inputs[key + "/g"])
    gh = inputs.get(key + "/gh")

    def loss(x, dt, bm, cm, a, d):
        out = jnp.sum(_mamba_scan_train(x, dt, bm, cm, a, d) * g)
        if gh is not None:
            out = out + jnp.sum(final_state(x, dt, bm, a) * gh)
        return out

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*ops)
    for n, gr in zip(("dx", "ddt", "dB", "dC", "da", "dd_skip"), grads):
        outputs[f"{key}/{n}"] = np.asarray(gr, np.float64)
"""


def _inputs(shape, seed, state=False):
    """x, dt, B, C, a, d_skip, dy and (with ``state``) dh_L as float64
    numpy arrays: dt in (0.01, ~0.3), a = log(|N(0, 1)| + 0.5)."""
    b, l, inner, n = shape
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(b, l, inner)),
           0.1 * np.abs(rng.normal(size=(b, l, inner))) + 0.01,
           rng.normal(size=(b, l, n)), rng.normal(size=(b, l, n)),
           np.log(np.abs(rng.normal(size=(inner, n))) + 0.5),
           rng.normal(size=(inner,)), rng.normal(size=(b, l, inner))]
    if state:
        out.append(rng.normal(size=(b, inner, n)))
    return out


def _case_inputs(case):
    case_id, shape, state = case
    return _inputs(shape, sum(shape) + len(case_id), state)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference gradients, from one subprocess."""
    inputs = {}
    for case in CASES:
        arrays = _case_inputs(case)
        for dtype in NORM_TOL:
            key = f"{case[0]}/{dtype}"
            for n, arr in zip(("x", "dt", "B", "C", "a", "d", "g", "gh"),
                              arrays):
                inputs[f"{key}/{n}"] = arr.astype(dtype)
    return run_reference(_REFERENCE, inputs,
                         tmp_path_factory.mktemp("scan_bwd_reference"))


def _norm_err(got, want) -> float:
    got = torch.as_tensor(np.asarray(got, np.float64))
    want = torch.as_tensor(np.asarray(want, np.float64))
    return float((got - want).norm() / want.norm().clamp(min=1e-300))


def _torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device, TORCH_DT[dtype]) for a in arrays]


@pytest.mark.parametrize("dtype", sorted(NORM_TOL))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plain_backward_matches_reference_autodiff(reference, case, dtype):
    arrays = _torch(_case_inputs(case), dtype)
    dh = arrays[7].to(torch.promote_types(TORCH_DT[dtype], torch.float32)) \
        if case[2] else None
    got = mamba_scan_bwd_ref(*arrays[:7], dh_last=dh)
    for name, g, t in zip(NAMES, got, arrays):
        assert g.dtype == t.dtype and g.shape == t.shape
        err = _norm_err(g.numpy(), reference[f"{case[0]}/{dtype}/{name}"])
        assert err <= NORM_TOL[dtype], (name, err)


# (B, L, I, N), chunk, with dh_L
CHUNKED = [((2, 37, 5, 4), 16, False), ((1, 130, 3, 16), 64, True),
           ((2, 64, 4, 1), 16, True), ((1, 100, 2, 32), 7, False)]


@pytest.mark.parametrize("shape,chunk,state", CHUNKED,
                         ids=[f"{s}-{c}-{st}" for s, c, st in CHUNKED])
def test_chunked_decomposition_matches_plain_backward(shape, chunk, state):
    arrays = _torch(_inputs(shape, 7 + chunk, state), "float64")
    dh = arrays[7] if state else None
    want = mamba_scan_bwd_ref(*arrays[:7], dh_last=dh)
    got = mamba_scan_bwd_chunked_ref(*arrays[:7], dh_last=dh, chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert _norm_err(g.numpy(), w.numpy()) <= 1e-12, name


# (B, L, I, N), chunk, channel tile
TILED = [((2, 37, 5, 4), 16, 2), ((1, 70, 8, 16), 64, 4),
         ((2, 50, 6, 1), 7, 4), ((1, 40, 3, 32), 64, 1)]


@pytest.mark.parametrize("shape,chunk,tile", TILED,
                         ids=[f"{s}-{c}-{t}" for s, c, t in TILED])
def test_chunked_decomposition_over_channel_tiles(shape, chunk, tile):
    arrays = _torch(_inputs(shape, 5 + tile, True), "float64")
    want = mamba_scan_bwd_ref(*arrays[:7], dh_last=arrays[7])
    got = mamba_scan_bwd_chunked_ref(*arrays[:7], dh_last=arrays[7],
                                     chunk=chunk, tile=tile)
    for name, g, w in zip(NAMES, got, want):
        assert _norm_err(g.numpy(), w.numpy()) <= 1e-12, name


def test_chunked_decomposition_without_its_carry_differs():
    """The negative control: each chunk's adjoint from 0 misses the later
    chunks' gradient in dx, ddt, dB and da (dC and dd_skip need none)."""
    arrays = _torch(_inputs((2, 90, 4, 4), 11, True), "float64")
    want = mamba_scan_bwd_ref(*arrays[:7], dh_last=arrays[7])
    got = mamba_scan_bwd_chunked_ref(*arrays[:7], dh_last=arrays[7],
                                     chunk=16, carry=False)
    errs = {n: _norm_err(g.numpy(), w.numpy())
            for n, g, w in zip(NAMES, got, want)}
    assert min(errs[n] for n in ("dx", "ddt", "dB", "da")) > 0.05, errs
    assert max(errs["dC"], errs["dd_skip"]) <= 1e-12, errs


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("dtype", sorted(NORM_TOL))
def test_op_gradient_matches_autograd_of_plain_forward(dtype, return_state):
    arrays = _torch(_inputs((2, 33, 5, 4), 3, True), dtype)
    ops_in = [t.requires_grad_(True) for t in arrays[:6]]
    dy, dh = arrays[6], arrays[7].to(
        torch.promote_types(TORCH_DT[dtype], torch.float32))

    def loss(fn):
        out = fn(*ops_in, return_state=return_state)
        if return_state:
            return (out[0] * dy).sum() + (out[1] * dh).sum()
        return (out * dy).sum()

    fwd, bwd = ops.plain_calls, ops.bwd_plain_calls
    got = torch.autograd.grad(loss(ops.mamba_scan), ops_in)
    assert (ops.plain_calls, ops.bwd_plain_calls) == (fwd + 1, bwd + 1)
    want = torch.autograd.grad(loss(mamba_scan_promoted_ref), ops_in)
    tol = 1e-12 if dtype == "float64" else 1e-6
    for name, g, w in zip(NAMES, got, want):
        assert _norm_err(g.numpy(), w.numpy()) <= tol, name


def test_op_passes_gradcheck():
    arrays = _torch(_inputs((1, 9, 3, 2), 5), "float64")
    ops_in = tuple(t.requires_grad_(True) for t in arrays[:6])
    assert torch.autograd.gradcheck(
        lambda *t: ops.mamba_scan(*t, return_state=True), ops_in)


def test_no_grad_call_is_the_forward_alone():
    arrays = _torch(_inputs((1, 12, 3, 4), 9), "float64")
    x = arrays[0].requires_grad_(True)
    with torch.no_grad():
        y = ops.mamba_scan(x, *arrays[1:6])
    assert y.grad_fn is None
    assert ops.mamba_scan(*(t.detach() for t in arrays[:6])).grad_fn is None


def _ptx_body(offset):
    """A kernel body whose one store after the second barrier goes to
    ``offset`` + 8 x lane + 0x100 x (tid // 32 * 3) bytes of shared
    memory, the address built as nvcc builds it."""
    return [
        "\tmov.u32 \t%r1, %tid.x;", "\tbar.sync \t0;", "\tbar.sync \t0;",
        "\tand.b32 \t%r2, %r1, 31;", "\tshl.b32 \t%r3, %r2, 3;",
        "\tshr.s32 \t%r4, %r1, 5;", "\tmul.lo.s32 \t%r5, %r4, 768;",
        "\tmov.u32 \t%r6, _ZN50_GLOBAL__N_4smemE;",
        "\tadd.s32 \t%r7, %r6, %r3;", "\tadd.s32 \t%r8, %r7, %r5;",
        f"\tst.shared.f64 \t[%r8+{offset}], %fd1;"]


@pytest.mark.parametrize("shift,place", [(0, "states"),
                                         (0x4000, "outside"),
                                         (-0x4000, "staged tiles")])
def test_ptx_check_places_a_mini_block_state_store(shift, place):
    source = ptx_check.SOURCE.read_text()
    consts = ptx_check.constants(source, ptx_check.HEADER.read_text())
    assert consts["K_double"] == 2
    consts["K_double"] = 4          # the double, N = 1 kernel at K = 4
    off, ng, kept = ptx_check.layout(consts, 8, 8, 1)
    assert (off["states"], off["end"], ng, kept) == (0xd000, 0xdc00, 1, 3)
    places, wrong = ptx_check.classify(
        _ptx_body(off["states"] + shift), off, ng, kept, 8)
    assert places == {place: len(ptx_check.THREADS)}
    assert len(wrong) == (0 if place == "states" else len(ptx_check.THREADS))


def _ptx_body32(offset, warp_bytes):
    """A kernel body whose one store after the second barrier goes to
    ``offset`` + 4 x lane + ``warp_bytes`` x warp bytes of shared
    memory, the address built as nvcc builds it."""
    return [
        "\tmov.u32 \t%r1, %tid.x;", "\tbar.sync \t0;", "\tbar.sync \t0;",
        "\tand.b32 \t%r2, %r1, 31;", "\tshl.b32 \t%r3, %r2, 2;",
        "\tbfe.u32 \t%r4, %r1, 5, 3;",
        f"\tmul.lo.s32 \t%r5, %r4, {warp_bytes};",
        "\tmov.u32 \t%r6, _ZN50_GLOBAL__N_4smemE;",
        "\tadd.s32 \t%r7, %r6, %r3;", "\tadd.s32 \t%r8, %r7, %r5;",
        f"\tst.shared.f32 \t[%r8+{offset}], %f1;"]


# (part, bytes between warps, shift, place): at N = 16 a warp's area is
# 0x2000 bytes (8 mini-blocks x 8 elements x 32 lanes of states), its
# staging of a segment's dt, x, dy 0xc00 bytes, its slots a segment's 16
# steps x 32 floats (0x800 bytes; warp 6's row at 0x3000, a warp no
# thread checked is in)
PTX32 = [("areas", 0x2000, 0, "states"), ("rows", 0, 0x40, "staged rows"),
         ("staging", 0xc00, 0, "staging"),
         ("slots", 0x800, 0, "slots"),
         ("slots", 0, 0x3000, "slots, another warp or lane"),
         ("areas", 0x2000, 4, "states, another warp or lane"),
         ("slots", 0x800, 0x4000, "outside")]


@pytest.mark.parametrize("part,warp_bytes,shift,place", PTX32,
                         ids=[f"{p}+{s:#x}" for p, _, s, _ in PTX32])
def test_ptx_check_places_the_float_kernels_stores(part, warp_bytes, shift,
                                                   place):
    consts = ptx_check.constants(ptx_check.SOURCE.read_text(),
                                 ptx_check.HEADER.read_text())
    off, s, k = ptx_check.layout32(consts, 16)
    assert (off["areas"], off["staging"], off["slots"], off["end"], s,
            k) == (0x2000, 0x12000, 0x18000, 0x1c000, 4, 2)
    places, wrong = ptx_check.classify32(
        _ptx_body32(off[part] + shift, warp_bytes), off, s, k)
    assert places == {place: len(ptx_check.THREADS32)}
    ok = place in ("states", "staging", "slots")
    assert len(wrong) == (0 if ok else len(ptx_check.THREADS32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written backward "
                    "kernel has no CPU mode")
    return torch.device("cuda")


# the card's cases: (B, L, I, N), with dh_L. Ragged L and I, every
# instantiated N (1, 4, 16, 32) with and without dh_L, one chunk,
# several look-back groups; I on both sides of the float kernel's
# 128-channel tile (127, 128, 129, 300) and B = 3 over several tiles
CUDA_CASES = [((2, 1000, 77, 4), False), ((2, 1000, 77, 32), True),
              ((1, 64, 32, 1), False), ((3, 65, 33, 16), True),
              ((1, 700, 256, 16), False), ((2, 300, 40, 3), True),
              ((1, 300, 127, 16), False), ((1, 300, 128, 16), True),
              ((2, 257, 129, 4), False), ((3, 600, 300, 16), True),
              ((1, 1100, 300, 1), True), ((2, 450, 200, 32), False)]
CUDA_TOL = {"float64": 1e-8, "float32": 2e-4, "bfloat16": 2e-2}
CUDA_NORM_TOL = {"float64": 1e-10, "float32": 1e-4, "bfloat16": 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(CUDA_TOL))
@pytest.mark.parametrize("case", CUDA_CASES,
                         ids=[f"{s}-{st}" for s, st in CUDA_CASES])
def test_cuda_backward_matches_plain_backward(cuda_device, case, dtype):
    shape, state = case
    arrays = _torch(_inputs(shape, sum(shape), state), dtype, cuda_device)
    acc = torch.promote_types(TORCH_DT[dtype], torch.float32)
    dh = arrays[7].to(acc) if state else None
    y, _, states = kernel.mamba_scan(*arrays[:6], save_states=True)
    assert torch.equal(y, kernel.mamba_scan(*arrays[:6]))
    before = kernel.bwd_launches
    got = kernel.mamba_scan_bwd(*arrays[:7], states, dh_last=dh)
    torch.cuda.synchronize()
    assert kernel.bwd_launches == before + 1
    want = mamba_scan_bwd_ref(*arrays[:7], dh_last=dh)
    tol = CUDA_TOL[dtype]
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g.double()).all()), name
        diff = (g.double() - w.double()).abs()
        scale = float(w.double().abs().max())
        assert float(diff.max()) <= tol * (1 + scale), (name, float(
            diff.max()), scale)
        assert _norm_err(g.cpu().double().numpy(),
                         w.cpu().double().numpy()) <= CUDA_NORM_TOL[dtype]
    again = kernel.mamba_scan_bwd(*arrays[:7], states, dh_last=dh)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_gradient_through_the_op(cuda_device):
    arrays = _torch(_inputs((2, 200, 48, 16), 1, True), "float32")
    grads = {}
    for device in ("cpu", cuda_device):
        ops_in = [t.to(device).requires_grad_(True) for t in arrays[:6]]
        y, h = ops.mamba_scan(*ops_in, return_state=True)
        loss = (y * arrays[6].to(device)).sum() \
            + (h * arrays[7].to(device)).sum()
        grads[str(device)] = torch.autograd.grad(loss, ops_in)
    for name, g, w in zip(NAMES, grads[str(cuda_device)], grads["cpu"]):
        assert g.is_cuda
        assert _norm_err(g.cpu().numpy(), w.numpy()) <= 1e-4, name
