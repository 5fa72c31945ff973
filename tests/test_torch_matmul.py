"""The port's matmul against the reference's, at small sizes.

The plain torch version (``repro_torch.kernels.matmul.ref``) and the
dispatch (``ops``) on CPU tensors are held to the reference's Pallas
kernel in interpret mode and to its jnp oracle, on the same inputs made
from a numpy seed. Tolerances follow ``tests/test_kernels.py`` (applied
absolutely and relative to the reference): float32 2e-4, bfloat16 2e-2
(both sides round to bf16 at the end), float64 1e-8.

The runtime surface ``repro_torch.kernels.api.matmul`` is held to
``repro.kernels.api.matmul`` on numpy and ``ChunkSlice`` blocks. The
reference side runs once per module in a subprocess
(``tests/torch_reference.py``). The hand-written CUDA kernel itself runs
only on a card: its test carries the ``cuda`` marker and skips here.
"""

import numpy as np
import pytest
import torch

from repro_torch.distrib.serial import rebase_chunk
from repro_torch.kernels import api
from repro_torch.kernels.matmul import matmul as kernel
from repro_torch.kernels.matmul import ops
from repro_torch.kernels.matmul.ref import matmul_ref
from torch_reference import run_reference

TOL = {"float32": 2e-4, "bfloat16": 2e-2, "float64": 1e-8}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float64": torch.float64}

# the (m, k, n) sweep of tests/test_kernels.py plus ragged shapes that
# tile by nothing the kernels use
SHAPES = [(64, 32, 16), (100, 300, 64), (128, 128, 200), (16, 300, 16),
          (33, 20, 15), (130, 77, 101)]
# on the card also: smaller than one tile, an odd K that is no multiple
# of the K step (every odd row of X then starts 8 bytes off 16), exact
# multiples of the float64 tile (128 x 128, K step 16) and the main
# path's chunk
CUDA_SHAPES = SHAPES + [(1000, 777, 1001), (1, 1, 1), (7, 3, 5),
                        (256, 64, 384), (4096, 2048, 2048)]
DTYPES = sorted(TOL)

# rows [LO, HI) of the (40, 12) operand form a worker's chunk
LO, HI = 16, 29

_REFERENCE = """
import jax.numpy as jnp
from repro.kernels import api as ref_api
from repro.kernels.matmul.ops import matmul as ref_pallas
from repro.kernels.matmul.ref import matmul_ref as ref_oracle
for key in sorted({k.rsplit("/", 1)[0] for k in inputs}):
    x, y = inputs[key + "/x"], inputs[key + "/y"]
    if key.startswith("mm/"):
        dtype = key.split("/")[2]
        jx, jy = jnp.asarray(x, dtype), jnp.asarray(y, dtype)
        got = ref_pallas(jx, jy, force_pallas=True, interpret=True)
        outputs[key + "/pallas"] = np.asarray(got.astype(jnp.float64))
        outputs[key + "/oracle"] = np.asarray(
            ref_oracle(jx, jy).astype(jnp.float64))
    else:
        outputs[key + "/api"] = np.asarray(ref_api.matmul(x, y))
"""


def _mm_key(m, k, n, dtype):
    return f"mm/{m}x{k}x{n}/{dtype}"


def _mm_inputs(m, k, n, dtype):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    x = rng.normal(size=(m, k)).astype(np.float32 if dtype != "float64"
                                       else np.float64)
    y = rng.normal(size=(k, n)).astype(x.dtype)
    return x, y


def _api_inputs():
    """name → (a, b) for the runtime-surface cases; the chunk cases are
    the global rows a ChunkSlice of A[LO:HI] stands for."""
    rng = np.random.default_rng(17)
    out = {}
    for dtype in ("float32", "float64"):
        out[dtype] = ((0.1 * rng.normal(size=(33, 20))).astype(dtype),
                      (0.1 * rng.normal(size=(20, 15))).astype(dtype))
    A = rng.normal(size=(40, 12))
    B = rng.normal(size=(12, 9))
    out["chunk-view"] = (2.0 * A[LO:HI, 0:12], B[0:12, 0:9])
    out["chunk"] = (A[LO:HI], B)
    return out, A, B


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference results, from one subprocess."""
    inputs = {}
    for (m, k, n) in SHAPES:
        for dtype in DTYPES:
            key = _mm_key(m, k, n, dtype)
            inputs[key + "/x"], inputs[key + "/y"] = _mm_inputs(m, k, n,
                                                                dtype)
    for name, (a, b) in _api_inputs()[0].items():
        inputs[f"api/{name}/x"], inputs[f"api/{name}/y"] = a, b
    return run_reference(_REFERENCE, inputs,
                         tmp_path_factory.mktemp("matmul_reference"))


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
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matmul_matches_reference_pallas_and_oracle(reference, m, k,
                                                          n, dtype):
    x, y = _mm_inputs(m, k, n, dtype)
    tx = torch.from_numpy(x).to(TORCH_DT[dtype])
    ty = torch.from_numpy(y).to(TORCH_DT[dtype])
    got_ref = matmul_ref(tx, ty)
    got_ops = ops.matmul(tx, ty)
    key = _mm_key(m, k, n, dtype)
    assert got_ref.dtype == got_ops.dtype == TORCH_DT[dtype]
    assert tuple(got_ops.shape) == (m, n)
    for got in (got_ref, got_ops):
        g = got.to(torch.float64).numpy()
        _close(g, reference[key + "/pallas"], dtype, key)
        _close(g, reference[key + "/oracle"], dtype, key)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_api_matmul_matches_reference_api(reference, cpu_api, dtype):
    a, b = _api_inputs()[0][dtype]
    got = cpu_api.matmul(a, b)
    assert got.dtype == np.dtype(dtype) and got.shape == (33, 15)
    _close(got, reference[f"api/{dtype}/api"], dtype, dtype)
    st = cpu_api.take_stats()
    assert st["cuda_calls"] == 1 and st["cuda_plain_calls"] == 1


def test_api_matmul_on_chunk_slices_matches_reference_api(reference,
                                                          cpu_api):
    """Twin bodies hand the api ChunkSlice views of a worker's rows,
    indexed by global rows: the result must equal the reference api on
    the same global rows."""
    _, A, B = _api_inputs()
    rows = rebase_chunk(A[LO:HI].copy(), LO)
    got = cpu_api.matmul(2.0 * rows[LO:HI, 0:12], B[0:12, 0:9])
    _close(got, reference["api/chunk-view/api"], "float64",
           "chunk-slice view")
    # the ChunkSlice itself (not a view taken through its indexer)
    _close(cpu_api.matmul(rows, B), reference["api/chunk/api"], "float64",
           "chunk slice")


def test_api_refuses_integer_operands_and_div_block(cpu_api):
    """Integer operands are a refused lowering; no block is ever sized
    to divide the operands (the kernels mask ragged edges), so the
    runtime has no divisor helper."""
    ints = np.arange(6, dtype=np.int64).reshape(2, 3)
    with pytest.raises(TypeError, match="cuda-lowering-infeasible"):
        cpu_api.matmul(ints, ints.T)
    assert not hasattr(api, "_div_block")


@pytest.mark.parametrize("dtype", DTYPES)
def test_wrapper_row_limit_follows_the_grid(dtype):
    """The FMA kernel's grid (float32, bfloat16) has 65535 block rows of
    64 output rows: the wrapper refuses one row more before it launches,
    and at the limit goes on to the device check. The float64 kernel
    puts its row tiles on grid.x and takes any M: one row past what 65535
    of its 128-row tiles hold also goes on to the device check. Operands
    of width 0 cost no memory."""
    dt = TORCH_DT[dtype]
    y = torch.empty((0, 3), dtype=dt)
    if dt == torch.float64:
        with pytest.raises(ValueError, match="CUDA device"):
            kernel.matmul(torch.empty((65535 * 128 + 1, 0), dtype=dt), y)
        return
    limit = 65535 * 64
    with pytest.raises(ValueError, match=f"at most {limit} rows"):
        kernel.matmul(torch.empty((limit + 1, 0), dtype=dt), y)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.matmul(torch.empty((limit, 0), dtype=dt), y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", CUDA_SHAPES)
def test_cuda_kernel_matches_plain_version(cuda_device, m, k, n, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = _mm_inputs(m, k, n, dtype)
    tx = torch.from_numpy(x).to(cuda_device, TORCH_DT[dtype])
    ty = torch.from_numpy(y).to(cuda_device, TORCH_DT[dtype])
    before = kernel.launches
    got = ops.matmul(tx, ty)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == TORCH_DT[dtype] and got.is_cuda
    _close(got.double().cpu().numpy(),
           matmul_ref(tx, ty).double().cpu().numpy(), dtype,
           _mm_key(m, k, n, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(130, 64, 96), (129, 33, 130)])
def test_cuda_f64_kernel_on_operands_8_bytes_off_16(cuda_device, m, k, n):
    """Operands whose storage starts 8 bytes past a 16-byte boundary take
    the kernel's 8-byte copies, even where K and N are even."""
    x, y = _mm_inputs(m, k, n, "float64")
    bx = torch.empty(m * k + 1, dtype=torch.float64, device=cuda_device)
    by = torch.empty(k * n + 1, dtype=torch.float64, device=cuda_device)
    tx = bx[1:].view(m, k).copy_(torch.from_numpy(x))
    ty = by[1:].view(k, n).copy_(torch.from_numpy(y))
    assert tx.data_ptr() % 16 == 8 and ty.data_ptr() % 16 == 8
    got = kernel.matmul(tx, ty)
    torch.cuda.synchronize()
    _close(got.cpu().numpy(), matmul_ref(tx, ty).cpu().numpy(), "float64",
           f"{m}x{k}x{n} offset")


@pytest.mark.cuda
def test_cuda_f64_kernel_grid_takes_any_rows_and_refuses_wide_n(cuda_device):
    """The float64 kernel's row tiles run along grid.x: one row past what
    65535 tiles of 128 rows hold is computed. Its column tiles run along
    grid.y: one column past 65535 tiles is refused before the launch."""
    m, k, n = 65535 * 128 + 1, 3, 5
    x, y = _mm_inputs(m, k, n, "float64")
    tx = torch.from_numpy(x).to(cuda_device)
    ty = torch.from_numpy(y).to(cuda_device)
    got = kernel.matmul(tx, ty)
    torch.cuda.synchronize()
    _close(got.cpu().numpy(), matmul_ref(tx, ty).cpu().numpy(), "float64",
           f"{m}x{k}x{n}")
    before = kernel.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        kernel.matmul(
            torch.zeros((1, 0), dtype=torch.float64, device=cuda_device),
            torch.zeros((0, 65535 * 128 + 1), dtype=torch.float64,
                        device=cuda_device))
    assert kernel.launches == before
