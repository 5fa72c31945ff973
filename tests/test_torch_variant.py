"""The port's whole-kernel torch variant against the reference's jnp
variant.

A pfor-free, black-box-free kernel gets a ``torch`` variant exactly where
the reference builds a ``jnp`` one (quickstart, every PolyBench kernel in
both styles, every fusion chain). The dispatcher picks it above its
accelerator threshold and the np variant below it, as
``tests/test_compiler_polybench.py`` checks for the reference. On the
same seeded inputs its outputs match the reference's jnp variant within
1e-10·max(1, |ref|) in float64; the reference side runs in a subprocess
(``tests/torch_reference.py``). Here the variant computes on the CPU
(``txp`` bound to ``"cpu"``); the ``cuda``-marked case runs it on the
card against the CPU and skips here.
"""

import numpy as np
import pytest
import torch

from benchmarks.fusion_chains import CHAINS
from benchmarks.polybench_kernels import KERNELS, clone_args, to_lists
from examples.quickstart import correlation_loops
from repro.core.compiler import compile_kernel as ref_compile
from repro_torch.core import txp
from repro_torch.core.compiler import compile_kernel
from torch_reference import CASE_CODE, encode_case, run_reference

N_SMALL = 12
TOL = 1e-10


def _cases():
    """(id, kernel, args, output indices) as in
    tests/test_torch_compiler.py."""
    rng = np.random.default_rng(0)
    m, n = 10, 16
    data = rng.normal(size=(n, m))
    corr = [[0.0] * m for _ in range(m)]
    yield ("quickstart", correlation_loops.original,
           [float(n), data.tolist(), corr, m, n], [2])
    for name in sorted(KERNELS):
        k = KERNELS[name]
        args, meta = k["make_args"](N_SMALL, np.random.default_rng(42))
        for style in ("np", "list"):
            a = to_lists(args) if style == "list" else args
            yield (f"polybench-{name}-{style}", k[style], a, meta["out"])
    for name in sorted(CHAINS):
        c = CHAINS[name]
        args, meta = c["make_args"](N_SMALL, np.random.default_rng(7))
        yield (f"chain-{name}", c["np"], args, meta["out"])


CASES = list(_cases())
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("fn", [c[1] for c in CASES], ids=IDS)
def test_torch_variant_exactly_where_reference_builds_jnp(fn):
    ref, port = ref_compile(fn), compile_kernel(fn)
    assert ("torch" in port.variants) == ("jnp" in ref.variants)
    assert "jnp" not in port.variants
    if "torch" in port.variants:
        src = port.source("torch")
        assert "jax" not in src and ".at[" not in src


def test_select_picks_torch_above_threshold_np_below(monkeypatch):
    """Small problems stay on the optimized-NumPy variant; the torch
    variant only above the FLOP threshold (paper §4.1 decision tree)."""
    monkeypatch.setattr(txp, "_DEVICE", "cpu")
    args, _ = KERNELS["gemm"]["make_args"](16, np.random.default_rng(0))
    ck = compile_kernel(KERNELS["gemm"]["np"], accel_threshold=1e9)
    variant, rec = ck.select(ck._bind(clone_args(args), {}))
    assert rec.legality_ok and variant.name == "np"   # 2*16^3 << 1e9
    ck2 = compile_kernel(KERNELS["gemm"]["np"], accel_threshold=1.0)
    variant2, rec2 = ck2.select(ck2._bind(clone_args(args), {}))
    assert variant2.name == "torch" and rec2.profitable
    # through the dispatcher: the device result comes home into the
    # caller's array, as the np variant computes it
    got, want = clone_args(args), clone_args(args)
    ck2(*got)
    ck.call_variant("np", *want)
    assert ck2.history[-1].variant == "torch"
    assert ck2.stats()["variants"]["torch"]["calls"] == 1
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-10)


# the cases with a torch variant (the same as those with a jnp variant,
# test_torch_variant_exactly_where_reference_builds_jnp)
VARIANT_CASES = [c for c in CASES if "torch" in compile_kernel(c[1]).variants]

_REFERENCE = CASE_CODE + """
from repro.core.compiler import compile_kernel
for name in str(inputs["names"]).split(","):
    args = case_args(name)
    compile_kernel(case_fn(name)).call_variant("jnp", *args)
    for i, a in enumerate(args):
        outputs[f"{name}/{i}"] = np.asarray(a, dtype=float)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    inputs = {"names": np.asarray(",".join(c[0] for c in VARIANT_CASES))}
    for name, fn, args, _ in VARIANT_CASES:
        inputs.update(encode_case(name, fn, clone_args(args)))
    return run_reference(_REFERENCE, inputs,
                         tmp_path_factory.mktemp("variant"))


def _close(got, want, what):
    got = np.asarray(got, dtype=float)
    err = np.abs(got - want)
    allowed = TOL * np.maximum(1.0, np.abs(want))
    assert got.shape == want.shape and np.all(err <= allowed), \
        f"{what}: max err {err.max():.3e}"


@pytest.mark.parametrize("case", VARIANT_CASES,
                         ids=[c[0] for c in VARIANT_CASES])
def test_torch_variant_matches_reference_jnp_variant(reference, monkeypatch,
                                                     case):
    monkeypatch.setattr(txp, "_DEVICE", "cpu")
    name, fn, args, outs = case
    got = clone_args(args)
    compile_kernel(fn).call_variant("torch", *got)
    for i in outs:
        _close(got[i], reference[f"{name}/{i}"], f"{name} arg {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", VARIANT_CASES,
                         ids=[c[0] for c in VARIANT_CASES])
def test_cuda_torch_variant_matches_cpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the variant's card run has no "
                    "CPU stand-in")
    name, fn, args, outs = case
    ck = compile_kernel(fn)
    got = {}
    for dev in ("cpu", "cuda"):
        txp.set_device(dev)
        got[dev] = clone_args(args)
        ck.call_variant("torch", *got[dev])
    txp.set_device("cuda")
    for i in outs:
        _close(got["cuda"][i], np.asarray(got["cpu"][i], dtype=float),
               f"{name} arg {i}")
