"""The port's torch twin against the reference's jnp twin, unit by unit.

Every accelerator-feasible pfor body gets a ``torch`` twin exactly where
the reference emits a ``jnp`` twin, and the batched fast path exactly
where the reference emits its ``pfor_jit`` path — on quickstart, every
PolyBench kernel in both styles, every fusion chain and the pfor-shaped
kernels of the reference's tests.

On the same inputs made from a numpy seed, the torch twin on the CPU
(``repro_torch.core.txp`` bound to ``"cpu"``) writes what the
reference's jnp twin writes: max |Δ| ≤ 1e-10·max(1, |ref|) in float64
(complex128 included, with ``benchmarks/stap.py::stap_kernel``: beamform
→ FFT → match filter) and 1e-5·max(1, |ref|) in float32. Both take their
batched path where it exists (``pfor_batch`` against ``pfor_jit``). The
reference's twins run in a subprocess (``tests/torch_reference.py``).

``pfor_batch`` itself: the batched path and the eager twin loop write the
same bits; chunks of jittering size share one entry per pow2 bucket; a
body that cannot be batched is marked once and every run of it counts
one fallback. The ``cuda``-marked cases run the twins on the card against
the CPU twin and skip here.
"""

import numpy as np
import pytest
import torch

from benchmarks.fusion_chains import CHAINS
from benchmarks.polybench_kernels import KERNELS
from benchmarks.stap import gemm_rowscale, stap_kernel
from examples.quickstart import correlation_loops
from examples.torch_stap import stap_adaptive
from repro.core.compiler import compile_kernel as ref_compile
from repro_torch.core import backends, txp
from repro_torch.core.compiler import compile_kernel
from repro_torch.distrib import accel
from repro_torch.distrib.serial import rebase_chunk
from torch_kernels import (attn_kernel, hetero_kernel, mm_kernel,
                           numpy_local_kernel, scan_kernel, soak_kernel)
from torch_reference import CASE_CODE, encode_case, run_reference

TOL = {"float64": 1e-10, "complex128": 1e-10, "float32": 1e-5}
F32_MM = {"A": "ndarray[f32,2]", "B": "ndarray[f32,2]",
          "C": "ndarray[f32,2]"}


def _unit_cases():
    """(id, kernel) of every kernel whose twin units are compared."""
    yield "quickstart", correlation_loops.original
    for name in sorted(KERNELS):
        for style in ("np", "list"):
            yield f"polybench-{name}-{style}", KERNELS[name][style]
    for name in sorted(CHAINS):
        yield f"chain-{name}", CHAINS[name]["np"]
    for fn in (gemm_rowscale, stap_kernel, stap_adaptive, mm_kernel,
               attn_kernel, scan_kernel, hetero_kernel,
               numpy_local_kernel, soak_kernel):
        yield fn.__name__, fn


UNIT_CASES = list(_unit_cases())


@pytest.mark.parametrize("fn", [f for _, f in UNIT_CASES],
                         ids=[i for i, _ in UNIT_CASES])
def test_torch_twin_units_equal_reference_jnp_units(fn):
    ref, port = ref_compile(fn), compile_kernel(fn)
    assert port.pfor_torch_units() == ref.pfor_jnp_units()
    assert port.pfor_batch_units() == ref.pfor_jit_units()
    src = port.source("np")
    for u in port.pfor_torch_units():
        assert f"def __pfor_body_{u}__torch(" in src
    for u in port.pfor_batch_units():
        assert f"__pfor_batch(__pfor_iter_{u}, " in src
    assert "jax" not in src and "__jxp" not in src


def _parity_cases():
    """(id, kernel, args, output indices, hints, dtype): kernels with a
    torch twin, at small sizes, inputs from a numpy seed."""
    rng = np.random.default_rng(15)
    n, k, m = 24, 8, 6
    A, B = rng.normal(size=(n, k)), rng.normal(size=(k, m))
    yield ("gemm_rowscale", gemm_rowscale,
           [A, B, np.zeros((n, m)), n, k, m], [2], None, "float64")
    yield ("mm_f32", mm_kernel,
           [A.astype(np.float32), B.astype(np.float32),
            np.zeros((n, m), np.float32), n, k, m], [2], F32_MM, "float32")
    q, t, d = 16, 12, 4
    Q, K, V = (0.4 * rng.normal(size=(r, d)) for r in (q, t, t))
    yield ("attention", attn_kernel, [Q, K, V, np.zeros((q, d)), q, t, d],
           [3], None, "float64")
    X = rng.normal(size=(6, 8))
    yield ("scan", scan_kernel, [X, np.zeros((6, 8)), 6, 8], [1], None,
           "float64")
    x, y = rng.normal(size=(12, 6)), rng.normal(size=(12, 6))
    yield ("hetero", hetero_kernel, [x, y, np.zeros(12), 12, 6, 20], [2],
           None, "float64")
    yield ("numpy_local", numpy_local_kernel,
           [rng.normal(size=(10, 5)), np.zeros(10), 10, 5], [1], None,
           "float64")
    yield ("soak", soak_kernel,
           [0.5 * rng.normal(size=(10, 6)), rng.normal(size=6),
            np.zeros(10), 10, 6, 15], [2], None, "float64")
    gates, kt, dof = 6, 8, 6
    yield ("stap_adaptive", stap_adaptive,
           [rng.normal(size=(gates, dof)), rng.normal(size=(gates, kt, dof)),
            rng.normal(size=dof), np.zeros(gates), gates, kt, dof, 30,
            0.05, 2.0], [3], None, "float64")
    cubes, ch, smp, fft = 4, 5, 16, 32

    def cplx(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)
    yield ("stap_kernel", stap_kernel,
           [cplx(cubes, ch, smp), cplx(ch), cplx(cubes, fft),
            np.zeros((cubes, fft), complex), cubes, fft], [3], None,
           "complex128")
    chain = CHAINS["doitgen_local"]
    args, meta = chain["make_args"](8, np.random.default_rng(7))
    yield ("doitgen_local", chain["np"], list(args), list(meta["out"]),
           None, "float64")


PARITY = list(_parity_cases())

_REFERENCE = CASE_CODE + """
from repro.core.compiler import compile_kernel
from repro.distrib import accel
for name in str(inputs["names"]).split(","):
    ck = compile_kernel(case_fn(name), hints=case_hints(name))
    args = case_args(name)
    accel.reset()
    run_twin(ck, args, "__jnp__")
    st = accel.stats()
    outputs[name + "/batched"] = np.asarray(
        st.get("jit_recompiles", 0) + st.get("jit_hits", 0))
    for i, a in enumerate(args):
        outputs[f"{name}/{i}"] = np.asarray(a)
"""


def _run_port_twin(ck, args, eager=False):
    """Run ``ck``'s np variant with every pfor body routed to its torch
    twin (``eager``: with the batched path refused, so the eager loop
    runs); returns the batch counters of the run."""
    gen = ck.variants["np"].generated
    ns = {"xp": np}
    for b in gen.meta.pfor_twin_units:
        ns.update(backends.get(b).namespace(gen.meta))
    if eager:
        ns["__pfor_batch"] = lambda *a: False
    ns["__pfor_run"] = lambda body, lo, hi, tile: \
        getattr(body, "__torch__", body)(lo, hi)
    exec(compile(gen.source, "<port>", "exec"), ns)
    accel.reset()
    ns[gen.fn_name](*args)
    return accel.take_stats()


def _clone(args):
    return [a.copy() if isinstance(a, np.ndarray) else a for a in args]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    inputs = {"names": np.asarray(",".join(c[0] for c in PARITY))}
    for name, fn, args, _, hints, _ in PARITY:
        inputs.update(encode_case(name, fn, args, hints))
    return run_reference(_REFERENCE, inputs,
                         tmp_path_factory.mktemp("twin"))


@pytest.fixture
def cpu_txp(monkeypatch):
    monkeypatch.setattr(txp, "_DEVICE", "cpu")


def _close(got, want, dtype, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, what
    err = np.abs(got - want)
    allowed = TOL[dtype] * np.maximum(1.0, np.abs(want))
    assert np.all(err <= allowed), \
        f"{what}: max err {err.max():.3e} over {TOL[dtype]:g}"


@pytest.mark.parametrize("case", PARITY, ids=[c[0] for c in PARITY])
def test_torch_twin_matches_reference_jnp_twin(reference, cpu_txp, case):
    name, fn, args, outs, hints, dtype = case
    ck = compile_kernel(fn, hints=hints)
    assert ck.pfor_torch_units()
    got = _clone(args)
    st = _run_port_twin(ck, got)
    for i in outs:
        _close(got[i], reference[f"{name}/{i}"], dtype, f"{name} arg {i}")
    # the batched path ran on both sides exactly where both emit it
    batched = st.get("batch_builds", 0) + st.get("batch_hits", 0)
    assert bool(batched) == bool(reference[f"{name}/batched"]) \
        == bool(ck.pfor_batch_units())
    assert st.get("batch_fallbacks", 0) == 0


BATCHED = [c for c in PARITY if compile_kernel(c[1], hints=c[4])
           .pfor_batch_units()]


@pytest.mark.parametrize("case", BATCHED, ids=[c[0] for c in BATCHED])
def test_batched_path_and_eager_twin_write_the_same_bits(cpu_txp, case):
    name, fn, args, outs, hints, _ = case
    ck = compile_kernel(fn, hints=hints)
    batched, eager = _clone(args), _clone(args)
    st = _run_port_twin(ck, batched)
    assert st.get("batch_builds", 0) == len(ck.pfor_batch_units())
    st_eager = _run_port_twin(ck, eager, eager=True)
    assert not st_eager.get("batch_builds")
    for i in outs:
        assert np.array_equal(batched[i], eager[i]), f"{name} arg {i}"


def _row_iter(g, offs, x, w, y):
    """One iteration of a row-parallel body: y[g] = x[g] · w."""
    return ((x[g - offs[0]] * w).sum(-1),)


def test_jittering_chunks_share_one_batched_entry_per_bucket(cpu_txp):
    rng = np.random.default_rng(4)
    x, w = rng.normal(size=(40, 5)), rng.normal(size=5)
    accel.reset()
    # chunks of 9, 12 and 16 rows, one pow2 bucket (8, 16]; each holds
    # only its own rows, re-based as a worker's sliced cells are
    for lo, hi in ((0, 9), (9, 21), (21, 37), (37, 40)):
        xs = rebase_chunk(x[lo:hi].copy(), lo)
        ys = rebase_chunk(np.zeros(hi - lo), lo)
        assert accel.pfor_batch(_row_iter, lo, hi, (xs, w, ys), (2,))
        np.testing.assert_allclose(np.asarray(ys), (x[lo:hi] * w).sum(-1),
                                   rtol=0, atol=1e-12)
        if hi == 37:
            # the chunks' row counts are not part of the key
            st = accel.take_stats()
            assert st["batch_builds"] == 1 and st["batch_hits"] == 2
    # a chunk of 3 rows is another bucket: an entry of its own
    st = accel.take_stats()
    assert st["batch_builds"] == 1 and not st.get("batch_hits")


_CALLS = []


def _data_dependent_iter(g, offs, x):
    """Branches on a value: vmap cannot batch it."""
    _CALLS.append(g)
    row = x[g - offs[0]]
    if float(row.sum()) > 0:
        return (row * 2.0,)
    return (row,)


def test_unbatchable_body_is_marked_once_and_each_run_counted(cpu_txp):
    x = np.ones((6, 3))
    accel.reset()
    _CALLS.clear()
    for _ in range(2):
        assert not accel.pfor_batch(_data_dependent_iter, 0, 6, (x,), (0,))
    st = accel.take_stats()
    assert st["batch_fallbacks"] == 2
    assert not st.get("batch_builds") and not st.get("batch_hits")
    assert len(_CALLS) == 1            # probed once, then marked
    np.testing.assert_array_equal(x, np.ones((6, 3)))   # nothing written


def test_unbakeable_closure_runs_eager_counted(cpu_txp):
    table = np.arange(3.0)             # an array cell cannot join the key

    def it(g, offs, x):
        return (x[g - offs[0]] + table.sum(),)
    accel.reset()
    assert not accel.pfor_batch(it, 0, 2, (np.zeros((2, 3)),), (0,))
    assert accel.take_stats() == {"batch_fallbacks": 1}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the twin's card run has no CPU "
                    "stand-in")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("case", PARITY, ids=[c[0] for c in PARITY])
def test_cuda_twin_matches_cpu_twin(cuda_device, case):
    name, fn, args, outs, hints, dtype = case
    ck = compile_kernel(fn, hints=hints)
    got = {}
    for dev in ("cpu", cuda_device):
        txp.set_device(dev)
        got[dev] = _clone(args)
        st = _run_port_twin(ck, got[dev])
        assert st.get("batch_fallbacks", 0) == 0
    txp.set_device(cuda_device)
    for i in outs:
        _close(got[cuda_device][i], got["cpu"][i], dtype,
               f"{name} arg {i}")
