"""The torch backend's result dtypes against numpy's and the reference's.

Three faults of the torch backend (``repro_torch.core.txp`` and the code
that computes through it), each pinned here on the CPU:

1. Integer operands follow numpy's result dtype. ``/ 3`` and ``np.sqrt``
   of int64 rows give float64 in the torch twin (batched and eager) and
   in the whole-kernel torch variant, within 1e-15 relative of numpy and
   of the reference's jnp twin and variant (X int64 in [0, 1e6), 40×6,
   seed 0; the variant at 64×64); ``sqrt``/``exp``/``log``/``sin``/
   ``cos``/``mean`` of integers take numpy's dtype.
2. Python scalars are weak (NEP 50). A float32 body iterating
   ``w = np.maximum(w * 1.1 + 0.1 * x[i, 0:m], 0.0)`` (40×6, 30 steps,
   seed 0) keeps every intermediate float32 and writes numpy's rows
   bit for bit, batched and eager, as the reference's eager jnp twin
   does (the reference's jitted batch, through XLA, differs from numpy
   by up to 8 ulp on these inputs); a numpy scalar (``np.float64``) is strong and
   widens the body to float64, as in numpy.
3. With ``txp`` left unbound (``"cuda"``) on a host without a CUDA
   device, a call the dispatcher sends to the whole-kernel torch
   variant raises an error that says how to bind the CPU, and the np
   variant is not run in its place.

The reference's twins run in a subprocess (``tests/torch_reference.py``).
"""

import numpy as np
import pytest
import torch

from benchmarks.polybench_kernels import KERNELS, clone_args
from repro_torch.core import backends, txp
from repro_torch.core.compiler import compile_kernel
from repro_torch.distrib import accel
from torch_kernels import (int_div_kernel, int_sqrt_kernel, int_sqrt_whole,
                           relu_iter_kernel, relu_scaled_kernel,
                           shift_scale_kernel)
from torch_reference import CASE_CODE, encode_case, run_reference

REL = 1e-15


def _int_case(fn):
    rng = np.random.default_rng(0)
    X = rng.integers(0, 1_000_000, size=(40, 6), dtype=np.int64)
    Y = rng.normal(size=(40, 6))
    return [X, Y, np.zeros((40, 6)), 40, 6, 5]


def _whole_case():
    rng = np.random.default_rng(0)
    X = rng.integers(0, 1_000_000, size=(64, 64), dtype=np.int64)
    return [X, rng.normal(size=(64, 64)), 64]


def _relu_case():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(40, 6)).astype(np.float32),
            np.zeros((40, 6), np.float32), 40, 6, 30]


INT_CASES = {"int_div": int_div_kernel, "int_sqrt": int_sqrt_kernel}

_REFERENCE = CASE_CODE + """
from repro.core.compiler import compile_kernel
for name in ("int_div", "int_sqrt"):
    args = case_args(name)
    run_twin(compile_kernel(case_fn(name)), args, "__jnp__")
    outputs[name] = np.asarray(args[2])
# the relu twin once more with its jitted batch refused: the eager jnp
# twin, which writes numpy's rows
ck = compile_kernel(case_fn("relu"))
gen = ck.variants["np"].generated
ns = {"xp": np}
for b in gen.meta.pfor_twin_units:
    ns.update(_B.get(b).namespace(gen.meta))
ns["__pfor_jit"] = lambda *a: False
ns["__pfor_run"] = lambda body, lo, hi, tile: body.__jnp__(lo, hi)
exec(compile(gen.source, "<reference>", "exec"), ns)
args = case_args("relu")
ns[gen.fn_name](*args)
outputs["relu/eager"] = np.asarray(args[1])
args = case_args("whole")
compile_kernel(case_fn("whole")).call_variant("jnp", *args)
outputs["whole"] = np.asarray(args[1])
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    inputs = {}
    for name, fn in INT_CASES.items():
        inputs.update(encode_case(name, fn, _int_case(fn)))
    inputs.update(encode_case("relu", relu_iter_kernel, _relu_case()))
    inputs.update(encode_case("whole", int_sqrt_whole, _whole_case()))
    return run_reference(_REFERENCE, inputs,
                         tmp_path_factory.mktemp("dtypes"))


@pytest.fixture
def cpu_txp(monkeypatch):
    monkeypatch.setattr(txp, "_DEVICE", "cpu")


@pytest.fixture
def dtypes_seen(monkeypatch):
    """Every tensor a txp function returns, by dtype (the generated code
    looks its functions up on the module at call time)."""
    seen = []
    for name in txp.__all__:
        fn = getattr(txp, name)
        if not callable(fn) or isinstance(fn, type) or name in (
                "set_device", "device", "result_type", "host"):
            continue

        def wrapped(*a, __fn=fn, **k):
            out = __fn(*a, **k)
            if isinstance(out, torch.Tensor):
                seen.append(out.dtype)
            return out
        monkeypatch.setattr(txp, name, wrapped)
    return seen


def _run_twin(ck, args, eager):
    """``ck``'s np variant with every pfor body routed to its torch twin
    (``eager``: the batched path refused); returns the batch counters."""
    gen = ck.variants["np"].generated
    ns = {"xp": np}
    for b in gen.meta.pfor_twin_units:
        ns.update(backends.get(b).namespace(gen.meta))
    if eager:
        ns["__pfor_batch"] = lambda *a: False
    ns["__pfor_run"] = lambda body, lo, hi, tile: \
        getattr(body, "__torch__", body)(lo, hi)
    exec(compile(gen.source, "<port>", "exec"), ns)
    ns[gen.fn_name](*args)
    return accel.take_stats()


def _rel_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float64, what
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    assert err.max() <= REL, f"{what}: max rel err {err.max():.3e}"


# -- entry 1: integer operands -------------------------------------------------

@pytest.mark.parametrize("eager", [False, True], ids=["batched", "eager"])
@pytest.mark.parametrize("name", sorted(INT_CASES))
def test_int_operands_give_float64_as_numpy_and_the_jnp_twin(
        reference, cpu_txp, dtypes_seen, name, eager):
    fn = INT_CASES[name]
    want = _int_case(fn)
    fn(*want)                                   # numpy, the plain loop
    got = _int_case(fn)
    accel.reset()
    st = _run_twin(compile_kernel(fn), got, eager)
    assert bool(st.get("batch_builds")) == (not eager)
    assert not st.get("batch_fallbacks")
    assert torch.float32 not in dtypes_seen
    _rel_close(got[2], want[2], f"{name} vs numpy")
    _rel_close(got[2], reference[name], f"{name} vs the jnp twin")


def test_whole_kernel_variant_of_int_sqrt_matches_numpy_and_jnp(
        reference, cpu_txp, dtypes_seen):
    want, got = _whole_case(), _whole_case()
    int_sqrt_whole(*want)
    ck = compile_kernel(int_sqrt_whole)
    assert "torch" in ck.variants
    ck.call_variant("torch", *got)
    assert torch.float32 not in dtypes_seen
    _rel_close(got[1], want[1], "whole-kernel vs numpy")
    _rel_close(got[1], reference["whole"], "whole-kernel vs jnp")


@pytest.mark.parametrize("fn", ["sqrt", "exp", "log", "sin", "cos", "mean"])
@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.int8, np.bool_])
def test_float_functions_of_integers_take_numpy_dtype(cpu_txp, fn, dtype):
    a = np.arange(1, 13).reshape(3, 4).astype(dtype)
    with np.errstate(over="ignore"):     # exp(12) overflows float16
        want = getattr(np, fn)(a)
    got = getattr(txp, fn)(torch.from_numpy(a))
    assert got.dtype == txp._NP_TO_TORCH[np.asarray(want).dtype]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15 if
                               want.dtype == np.float64 else 1e-3)


def test_mean_of_int64_along_an_axis_is_float64(cpu_txp):
    X = np.random.default_rng(0).integers(0, 1_000_000, size=(40, 6))
    for axis in (None, 0, 1):
        got = txp.mean(torch.from_numpy(X), axis=axis)
        assert got.dtype == torch.float64
        _rel_close(got.numpy(), np.mean(X, axis=axis), f"axis {axis}")


@pytest.mark.parametrize("a, b, want", [
    (np.arange(4), 3, np.float64),
    (np.arange(4, dtype=np.int32), 2, np.float64),
    (np.arange(4), np.arange(1, 5), np.float64),
    (np.ones(4, np.float32), 3, np.float32),
    (np.ones(4, np.float32), np.arange(1, 5), np.float64),
])
def test_true_divide_follows_numpy(cpu_txp, a, b, want):
    tb = torch.from_numpy(b) if isinstance(b, np.ndarray) else b
    got = txp.true_divide(torch.from_numpy(a), tb)
    assert np.true_divide(a, b).dtype == want
    assert got.dtype == txp._NP_TO_TORCH[np.dtype(want)]
    np.testing.assert_array_equal(got.numpy(), np.true_divide(a, b))


# -- entry 2: python scalars are weak ------------------------------------------

@pytest.mark.parametrize("eager", [False, True], ids=["batched", "eager"])
def test_float32_body_stays_float32_and_writes_numpy_rows(
        reference, cpu_txp, dtypes_seen, eager):
    want, got = _relu_case(), _relu_case()
    relu_iter_kernel(*want)
    accel.reset()
    st = _run_twin(compile_kernel(relu_iter_kernel), got, eager)
    assert bool(st.get("batch_builds")) == (not eager)
    assert dtypes_seen and set(dtypes_seen) == {torch.float32}
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[1], reference["relu/eager"])


@pytest.mark.parametrize("eager", [False, True], ids=["batched", "eager"])
def test_numpy_scalar_is_strong_and_widens_as_numpy(cpu_txp, dtypes_seen,
                                                    eager):
    ck = compile_kernel(relu_scaled_kernel)
    accel.reset()
    for a, wide in ((1.1, torch.float32), (np.float64(1.1), torch.float64),
                    (np.float32(1.1), torch.float32)):
        want, got = _relu_case() + [a], _relu_case() + [a]
        relu_scaled_kernel(*want)
        dtypes_seen.clear()
        _run_twin(ck, got, eager)
        assert wide in dtypes_seen and (
            wide == torch.float32) == (torch.float64 not in dtypes_seen), a
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("op", ["maximum", "minimum", "add", "multiply",
                                "true_divide", "subtract"])
def test_python_scalars_are_weak_numpy_scalars_strong(cpu_txp, op):
    x = np.linspace(-1, 1, 7, dtype=np.float32)
    for s in (0.5, 2, np.float64(0.5), np.float32(0.5), np.asarray(0.5)):
        want = getattr(np, op)(x, s)
        got = getattr(txp, op)(torch.from_numpy(x), s)
        assert got.dtype == txp._NP_TO_TORCH[want.dtype], (op, type(s))
        np.testing.assert_array_equal(got.numpy(), want)


def test_where_with_a_python_scalar_keeps_float32(cpu_txp):
    x = torch.linspace(-1, 1, 7, dtype=torch.float32)
    got = txp.where(x > 0, x, 0.0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.where(x.numpy() > 0, x.numpy(), 0.0))


@pytest.mark.parametrize("eager", [False, True], ids=["batched", "eager"])
def test_arithmetic_on_python_numbers_keeps_python_operators(cpu_txp,
                                                            eager):
    """Only an operator with a tensor operand goes through txp: the
    factor ``a * 2.0 + 1.0`` of a scalar parameter and constants is
    written with python's operators, and the rows stay numpy's."""
    ck = compile_kernel(shift_scale_kernel)
    twin = ck.source("np").split("__torch(__lo, __hi):", 1)[1]
    assert "((a * 2.0) + 1.0)" in twin
    assert "__txp.multiply(a, 2.0)" not in twin
    assert "__txp.multiply(w[0:w__d0], 0.5)" in twin
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 6))
    want, got = np.zeros((40, 6)), np.zeros((40, 6))
    shift_scale_kernel(x, want, 40, 6, 12, 0.3)
    accel.reset()
    st = _run_twin(ck, [x, got, 40, 6, 12, 0.3], eager)
    assert bool(st.get("batch_builds")) == (not eager)
    np.testing.assert_array_equal(got, want)


# -- entry 3: no card, txp unbound ---------------------------------------------

def test_unbound_call_without_a_card_raises_naming_set_device_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert txp._DEVICE == "cuda"                 # unbound: the default
    args, _ = KERNELS["gemm"]["make_args"](256, np.random.default_rng(0))
    ck = compile_kernel(KERNELS["gemm"]["np"])
    assert "torch" in ck.variants
    before = clone_args(args)
    with pytest.raises(txp.DeviceUnavailable) as ei:
        ck(*args)
    assert 'set_device("cpu")' in str(ei.value)
    assert "'cuda'" in str(ei.value)
    assert ck.stats()["variants"]["np"]["calls"] == 0
    assert ck.stats()["variants"]["torch"]["calls"] == 0
    for a, b in zip(args, before):               # nothing was computed
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
