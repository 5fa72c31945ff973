"""The port's selective scan against the reference's, at small sizes.

The plain torch versions (``repro_torch.kernels.mamba_scan.ref``: the
oracle's copy and the kernel's own function) and the dispatch (``ops``)
on CPU tensors are held to the reference's Pallas kernel in interpret
mode and to its jnp oracle, on the same inputs made from a numpy seed.
The cases follow the L / I / N / chunk sweep of
``tests/test_kernels.py``, plus a ragged L that no chunk divides (the
reference's dispatch shrinks its chunk to a divisor; the port's kernel
takes any L). The kernel's own decomposition, ``mamba_scan_chunked_ref``
(walks from zero, the carry combined by exp(decay * S), walks again from
the carry), is held to the same references at chunk lengths that do and
do not divide L, and to ``mamba_scan_promoted_ref`` where a strong decay
underflows the chunk's products in float32, where a weak one keeps
nearly all of the state, and at the kernel's own chunk (64 steps) on the
shapes of its ``cuda`` edge tests. The oracles return the promoted dtype
while the kernel and ``ops`` return ``x``'s: results are compared after casting to
float64. Tolerances, applied absolutely and relative to the reference:
float64 1e-8, float32 2e-4, bfloat16 2e-2 (the oracles compute the
decays of bf16 inputs in bf16, the Pallas kernel and the port's kernel
in float32). On the card the kernel is held to the plain version of
what it computes, ``mamba_scan_promoted_ref``.

The runtime surface ``repro_torch.kernels.api.scan_rows`` is held to
``repro.kernels.api.scan_rows`` on numpy and ``ChunkSlice`` blocks, and
refuses a coefficient outside (0, 1) as the reference does, with the
``cuda-lowering-infeasible`` message the cluster steps down on. The
reference side runs once per module in a subprocess
(``tests/torch_reference.py``). The hand-written CUDA kernel runs only
on a card: its tests carry the ``cuda`` marker and skip here.
"""

import numpy as np
import pytest
import torch

from repro_torch.distrib.serial import rebase_chunk
from repro_torch.kernels import api
from repro_torch.kernels.mamba_scan import mamba_scan as kernel
from repro_torch.kernels.mamba_scan import ops
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_chunked_ref,
                                              mamba_scan_promoted_ref,
                                              mamba_scan_ref)
from torch_reference import run_reference

TOL = {"float32": 2e-4, "bfloat16": 2e-2, "float64": 1e-8}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float64": torch.float64}
DTYPES = sorted(TOL)

# (B, L, I, N, chunk): tests/test_kernels.py's smoke, sweep corners and
# chunking-invariance shape, and a ragged L (the reference shrinks its
# chunk of 16 to 1 for L = 37)
CASES = [(2, 32, 8, 4, 8), (2, 64, 16, 8, 16), (2, 32, 16, 8, 8),
         (2, 64, 8, 4, 16), (1, 48, 8, 4, 8), (2, 37, 5, 3, 16)]
CASE_IDS = [f"B{b}-L{l}-I{i}-N{n}-c{c}" for b, l, i, n, c in CASES]

# rows [LO, HI) of the (40, 30) sequence block form a worker's chunk
LO, HI = 16, 29

_REFERENCE = """
import jax.numpy as jnp
from repro.kernels import api as ref_api
from repro.kernels.mamba_scan.ops import mamba_scan as ref_pallas
from repro.kernels.mamba_scan.ref import mamba_scan_ref as ref_oracle
for key in sorted({k.rsplit("/", 1)[0] for k in inputs}):
    if key.startswith("ms/"):
        dtype = key.split("/")[2]
        chunk = int(key.split("-c")[-1].split("/")[0])
        args = [jnp.asarray(inputs[key + "/" + n], dtype)
                for n in ("x", "dt", "bm", "cm", "a", "d")]
        got = ref_pallas(*args, chunk=chunk, force_pallas=True,
                         interpret=True)
        outputs[key + "/pallas"] = np.asarray(got.astype(jnp.float64))
        outputs[key + "/oracle"] = np.asarray(
            ref_oracle(*args).astype(args[0].dtype).astype(jnp.float64))
    else:
        outputs[key + "/api"] = np.asarray(
            ref_api.scan_rows(inputs[key + "/x"], 0.85))
"""


def _key(case_id, dtype):
    return f"ms/{case_id}/{dtype}"


def _inputs(case):
    b, l, inner, n, _ = case
    rng = np.random.default_rng(l + inner + n)
    return (rng.normal(size=(b, l, inner)),
            np.abs(rng.normal(size=(b, l, inner))) * 0.1,
            rng.normal(size=(b, l, n)),
            rng.normal(size=(b, l, n)),
            np.log(np.abs(rng.normal(size=(inner, n))) + 0.5),
            rng.normal(size=(inner,)))


def _api_inputs():
    """name → x rows for the runtime-surface cases (the
    ``tests/test_kernels_equiv.py`` shape); the chunk cases are the
    global rows a ChunkSlice of X[LO:HI] stands for."""
    rng = np.random.default_rng(23)
    out = {dtype: (0.2 * rng.normal(size=(6, 40))).astype(dtype)
           for dtype in ("float32", "float64")}
    X = 0.2 * rng.normal(size=(40, 30))
    out["chunk-view"] = X[LO:HI, 0:30]
    out["chunk"] = X[LO:HI]
    return out, X


def _numpy_scan(x, c):
    y = np.zeros(x.shape)
    h = np.zeros(x.shape[0])
    for t in range(x.shape[1]):
        h = c * h + np.asarray(x[:, t], np.float64)
        y[:, t] = h
    return y


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference results, from one subprocess."""
    inputs = {}
    for case, case_id in zip(CASES, CASE_IDS):
        for dtype in DTYPES:
            key = _key(case_id, dtype)
            for name, arr in zip(("x", "dt", "bm", "cm", "a", "d"),
                                 _inputs(case)):
                inputs[f"{key}/{name}"] = arr
    for name, x in _api_inputs()[0].items():
        inputs[f"api/{name}/x"] = x
    return run_reference(_REFERENCE, inputs,
                         tmp_path_factory.mktemp("scan_reference"))


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
def test_plain_scan_matches_reference_pallas_and_oracle(reference, case,
                                                        dtype):
    args = [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in _inputs(case)]
    got_ops = ops.mamba_scan(*args)
    got_ref = mamba_scan_ref(*args)
    assert got_ops.dtype == TORCH_DT[dtype]
    assert got_ref.dtype == torch.promote_types(TORCH_DT[dtype],
                                                torch.float32)
    assert torch.equal(got_ops, mamba_scan_promoted_ref(*args))
    key = _key(CASE_IDS[CASES.index(case)], dtype)
    for got in (got_ops, got_ref.to(TORCH_DT[dtype])):
        assert tuple(got.shape) == case[:2] + case[2:3]
        g = got.to(torch.float64).numpy()
        _close(g, reference[key + "/pallas"], dtype, key)
        _close(g, reference[key + "/oracle"], dtype, key)


# chunk lengths of the chunked decomposition: one step, lengths that do
# not divide L, L itself and one past it
CHUNKS = ["1", "5", "16", "L", "L+3"]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_chunked_ref_matches_reference_pallas_and_oracle(reference, case,
                                                         dtype, chunk):
    length = case[1]
    lc = {"L": length, "L+3": length + 3}.get(chunk) or int(chunk)
    args = [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in _inputs(case)]
    got = mamba_scan_chunked_ref(*args, chunk=lc)
    assert got.dtype == TORCH_DT[dtype]
    assert tuple(got.shape) == case[:3]
    key = _key(CASE_IDS[CASES.index(case)], dtype)
    g = got.to(torch.float64).numpy()
    _close(g, reference[key + "/pallas"], dtype, f"{key} chunk {lc}")
    _close(g, reference[key + "/oracle"], dtype, f"{key} chunk {lc}")


def _decay_inputs(kind):
    """Strong decay: a = log 60 and dt = 1, so exp(dt * decay) = e^-60 and
    the product of two steps underflows float32. Weak decay: dt = 1e-4
    over L = 300, so the state barely decays."""
    rng = np.random.default_rng(7)
    b, l, inner, n = (1, 64, 8, 4) if kind == "strong" else (1, 300, 8, 4)
    dt = np.ones((b, l, inner)) if kind == "strong" \
        else np.full((b, l, inner), 1e-4)
    a = np.full((inner, n), np.log(60.0)) if kind == "strong" \
        else np.log(np.abs(rng.normal(size=(inner, n))) + 0.5)
    return (rng.normal(size=(b, l, inner)), dt, rng.normal(size=(b, l, n)),
            rng.normal(size=(b, l, n)), a, rng.normal(size=(inner,)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["strong", "weak"])
def test_chunked_ref_holds_under_strong_and_weak_decay(kind, dtype):
    args = [torch.from_numpy(a).to(TORCH_DT[dtype])
            for a in _decay_inputs(kind)]
    got = mamba_scan_chunked_ref(*args, chunk=16)
    assert bool(torch.isfinite(got).all())
    _close(got.double().numpy(),
           mamba_scan_promoted_ref(*args).double().numpy(), dtype, kind)


# the kernel's edges, (B, L, I, N): L around its chunk of LC = 64 steps
# (LC in csrc/mamba_scan.cu) and one long L, I not a multiple of the
# 32-channel tile, B = 3, and N from 1 to 32 (padded to 1, 4, 16, 32)
LC = 64
EDGES = [(1, 1, 40, 4), (1, LC - 1, 40, 4), (1, LC, 40, 4),
         (1, LC + 1, 40, 4), (1, 4097, 40, 4), (2, 300, 77, 4),
         (3, 300, 64, 4), (1, 300, 64, 1), (1, 300, 64, 2),
         (1, 300, 64, 16), (1, 300, 64, 32)]
EDGE_IDS = [f"B{b}-L{l}-I{i}-N{n}" for b, l, i, n in EDGES]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", EDGES, ids=EDGE_IDS)
def test_chunked_ref_at_kernel_chunk_matches_plain_version(shape, dtype):
    """The kernel's decomposition at its own chunk length, on the CPU,
    at the shapes its cuda tests run."""
    args = [torch.from_numpy(a).to(TORCH_DT[dtype])
            for a in _inputs(shape + (0,))]
    _close(mamba_scan_chunked_ref(*args, chunk=LC).double().numpy(),
           mamba_scan_promoted_ref(*args).double().numpy(), dtype,
           str(shape))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_api_scan_rows_matches_reference_api(reference, cpu_api, dtype):
    x = _api_inputs()[0][dtype]
    got = cpu_api.scan_rows(x, 0.85)
    assert got.dtype == np.dtype(dtype) and got.shape == (6, 40)
    _close(got, reference[f"api/{dtype}/api"], dtype, dtype)
    _close(got, _numpy_scan(x, 0.85), dtype, "numpy")
    st = cpu_api.take_stats()
    assert st["cuda_calls"] == 1 and st["cuda_plain_calls"] == 1


def test_api_scan_rows_on_chunk_slices_matches_reference_api(reference,
                                                             cpu_api):
    """Twin bodies hand the api ChunkSlice views of a worker's rows,
    indexed by global rows: the result must equal the reference api on
    the same global rows."""
    _, X = _api_inputs()
    rows = rebase_chunk(X[LO:HI].copy(), LO)
    _close(cpu_api.scan_rows(rows[LO:HI, 0:30], 0.85),
           reference["api/chunk-view/api"], "float64", "chunk-slice view")
    _close(cpu_api.scan_rows(rows, 0.85), reference["api/chunk/api"],
           "float64", "chunk slice")


@pytest.mark.parametrize("c", [0.0, 1.0, 1.5, -0.3])
def test_api_scan_rows_refuses_unstable_coeff(cpu_api, c):
    with pytest.raises(ValueError, match="cuda-lowering-infeasible"):
        cpu_api.scan_rows(np.ones((2, 8)), c)
    # a refused lowering never reached the kernel runtime
    assert "cuda_calls" not in cpu_api.stats()


def test_kernel_wrapper_refuses_cpu_tensors():
    t = torch.ones(1, 4, 3, dtype=torch.float64)
    n = torch.ones(1, 4, 1, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.mamba_scan(t, t, n, n, torch.ones(3, 1, dtype=torch.float64),
                          torch.ones(3, dtype=torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES + [(2, 1000, 77, 4, 0),
                                          (1, 300, 130, 16, 0),
                                          (1, 64, 40, 32, 0),
                                          (1, 500, 1000, 1, 0)])
def test_cuda_kernel_matches_plain_version(cuda_device, case, dtype):
    args = [torch.from_numpy(a).to(cuda_device, TORCH_DT[dtype])
            for a in _inputs(case)]
    before = kernel.launches
    got = ops.mamba_scan(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == TORCH_DT[dtype] and got.is_cuda
    _close(got.double().cpu().numpy(),
           mamba_scan_promoted_ref(*args).double().cpu().numpy(), dtype,
           str(case))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", EDGES, ids=EDGE_IDS)
def test_cuda_kernel_edges_match_plain_version(cuda_device, shape, dtype):
    """Each call must give the same bits as the call before it: a flag or
    counter left from an earlier call would show as a difference."""
    args = [torch.from_numpy(a).to(cuda_device, TORCH_DT[dtype])
            for a in _inputs(shape + (0,))]
    got = ops.mamba_scan(*args)
    again = ops.mamba_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got.double().cpu().numpy(),
           mamba_scan_promoted_ref(*args).double().cpu().numpy(), dtype,
           str(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["strong", "weak"])
def test_cuda_kernel_holds_under_strong_and_weak_decay(cuda_device, kind,
                                                       dtype):
    args = [torch.from_numpy(a).to(cuda_device, TORCH_DT[dtype])
            for a in _decay_inputs(kind)]
    got = ops.mamba_scan(*args)
    assert bool(torch.isfinite(got).all())
    _close(got.double().cpu().numpy(),
           mamba_scan_promoted_ref(*args).double().cpu().numpy(), dtype,
           kind)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", EDGES + [(2, 1000, 77, 32),
                                           (1, 130, 40, 17)],
                         ids=EDGE_IDS + ["B2-L1000-I77-N32",
                                         "B1-L130-I40-N17"])
def test_cuda_kernel_final_state_matches_plain_version(cuda_device, shape,
                                                       dtype):
    """h_L, written by the last chunk's last warp (in float64 at N > 16
    in two passes of 16 states), against the plain version's; y is the
    same bits with and without it."""
    args = [torch.from_numpy(a).to(cuda_device, TORCH_DT[dtype])
            for a in _inputs(shape + (0,))]
    before = kernel.launches
    y, h = ops.mamba_scan(*args, return_state=True)
    plain = ops.mamba_scan(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.equal(y, plain)
    acc = torch.promote_types(TORCH_DT[dtype], torch.float32)
    assert h.dtype == acc and h.shape == (shape[0], shape[2], shape[3])
    _, want = mamba_scan_promoted_ref(*args, return_state=True)
    _close(h.double().cpu().numpy(), want.double().cpu().numpy(),
           "float64" if dtype == "float64" else "float32", str(shape))
