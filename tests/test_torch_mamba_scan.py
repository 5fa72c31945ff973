"""The port's selective scan against the reference's, at small sizes.

The plain torch versions (``repro_torch.kernels.mamba_scan.ref``: the
oracle's copy and the kernel's own function) and the dispatch (``ops``)
on CPU tensors are held to the reference's Pallas kernel in interpret
mode and to its jnp oracle, on the same inputs made from a numpy seed.
The cases follow the L / I / N / chunk sweep of
``tests/test_kernels.py``, plus a ragged L that no chunk divides (the
reference's dispatch shrinks its chunk to a divisor; the port's kernel
takes any L). The oracles return the promoted dtype while the kernel
and ``ops`` return ``x``'s: results are compared after casting to
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
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_promoted_ref,
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
