"""The port's compiler against the reference's, variant by variant.

``repro_torch.core.compiler.compile_kernel(...).call_variant("np", ...)``
must compute what the reference's np variant computes, at float64 atol
1e-8, for the quickstart kernel, the PolyBench kernels and the fusion
chains. The port emits a ``cuda`` twin for exactly the pfor units the
reference's matcher recognizes (matmul-, attention- and scan-shaped),
each calling the ``__cuk`` entry point of its shape where the reference
calls ``__plk``'s, and its variant-cache token differs from the
reference's, so one cache directory never serves one package's source
to the other.

The reference's compile and its np variant initialise no JAX backend,
so both packages run in the test process.
"""

import numpy as np
import pytest

from benchmarks.fusion_chains import CHAINS
from benchmarks.polybench_kernels import KERNELS, clone_args, to_lists
from benchmarks.stap import gemm_rowscale
from examples.quickstart import correlation_loops
from repro.core import backends as ref_backends
from repro.core import patterns as ref_patterns
from repro.core.compiler import compile_kernel as ref_compile
from repro.core.schedule import PforUnit, SeqLoopUnit
from repro_torch.core import backends
from repro_torch.core.compiler import compile_kernel

N_SMALL = 12


def attn_kernel(Q: "ndarray[f64,2]", K: "ndarray[f64,2]",
                V: "ndarray[f64,2]", O: "ndarray[f64,2]",
                n: int, t: int, d: int):
    for i in range(0, n):
        s = np.dot(K[0:t, 0:d], Q[i, 0:d])
        p = np.exp(s)
        o = np.dot(p, V[0:t, 0:d])
        O[i, 0:d] = o / np.sum(p)


def scan_kernel(X: "ndarray[f64,2]", Y: "ndarray[f64,2]",
                n: int, L: int):
    for i in range(0, n):
        h = 0.0
        for t in range(0, L):
            h = 0.9 * h + X[i, t]
            Y[i, t] = h


def _both(fn, args, outs):
    """Run the np variant of the reference's and the port's compile on
    copies of ``args``; return each one's output arrays."""
    got = []
    for compile_ in (ref_compile, compile_kernel):
        ck = compile_(fn)
        a = clone_args(args)
        ck.call_variant("np", *a)
        got.append([np.asarray(a[i], dtype=float) for i in outs])
    return got


def _assert_same(fn, args, outs):
    ref, port = _both(fn, args, outs)
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p, r, atol=1e-8, rtol=0,
                                   err_msg=fn.__name__)


def _np_parity_cases():
    """(id, fn, args, outs): quickstart's ``correlation_loops``, every
    PolyBench kernel in both styles, every fusion chain."""
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


NP_CASES = list(_np_parity_cases())


@pytest.mark.parametrize("fn,args,outs", [c[1:] for c in NP_CASES],
                         ids=[c[0] for c in NP_CASES])
def test_np_variant_matches_reference(fn, args, outs):
    _assert_same(fn, args, outs)


def _pfor_units(units):
    """pfor units in codegen's emission order (the unit indices)."""
    for u in units:
        if isinstance(u, PforUnit):
            yield u
            yield from _pfor_units(u.body)
        elif isinstance(u, SeqLoopUnit):
            yield from _pfor_units(u.body)


def _ref_matched_units(ck) -> dict:
    """unit index → the kind the reference's matcher recognizes."""
    out = {}
    for idx, u in enumerate(_pfor_units(ck.sched.units)):
        m = ref_patterns.match_pfor_unit(u)
        if getattr(u, "jnp_feasible", True) and m is not None:
            out[idx] = m.kind
    return out


# the api entry point each matched kind calls
ENTRY = {"matmul": "matmul", "attention": "attention_rows",
         "scan": "scan_rows"}


SHAPED = [("gemm_rowscale", gemm_rowscale), ("attention", attn_kernel),
          ("scan", scan_kernel)] + \
    [(f"polybench-{n}", KERNELS[n]["np"]) for n in sorted(KERNELS)] + \
    [(f"chain-{n}", CHAINS[n]["np"]) for n in sorted(CHAINS)]


@pytest.mark.parametrize("fn", [f for _, f in SHAPED],
                         ids=[i for i, _ in SHAPED])
def test_cuda_twin_exactly_where_reference_matches_matmul(fn):
    """Every shape the reference lowers onto a kernel, matmul and the
    attention and scan shapes alike, gets a cuda twin, and only those."""
    ref_ck = ref_compile(fn)
    port_ck = compile_kernel(fn)
    want = _ref_matched_units(ref_ck)
    got = port_ck.pfor_twin_units().get("cuda", [])
    assert got == sorted(want)
    assert set(port_ck.pfor_twin_units()) <= {"cuda"}
    src = port_ck.source("np")
    ref_src = ref_ck.source("np")
    for kind, entry in ENTRY.items():
        n = sum(1 for k in want.values() if k == kind)
        assert src.count(f"__cuk.{entry}(") == n
        assert ref_src.count(f"__plk.{entry}(") == n
    assert "__plk" not in src and "__jxp" not in src


def test_attention_and_scan_lower_onto_their_cuda_kernels():
    attn = compile_kernel(attn_kernel)
    assert attn.pfor_twin_units() == {"cuda": [0]}
    assert ("O[__lo:__hi, 0:d] = __cuk.attention_rows(Q[__lo:__hi, 0:d], "
            "K[0:t, 0:d], V[0:t, 0:d])") in attn.source("np")
    scan = compile_kernel(scan_kernel)
    assert scan.pfor_twin_units() == {"cuda": [0]}
    # the statically known coefficient is baked into the call
    assert "Y[__lo:__hi, 0:L] = __cuk.scan_rows(X[__lo:__hi, 0:L], 0.9)" \
        in scan.source("np")


def test_gemm_rowscale_lowers_onto_the_cuda_kernel():
    ck = compile_kernel(gemm_rowscale)
    assert ck.pfor_twin_units() == {"cuda": [0]}
    assert "__cuk.matmul(2.0 * A[__lo:__hi, 0:k], B[0:k, 0:m])" \
        in ck.source("np")


def test_registry_tokens_and_shared_cache_dir(tmp_path):
    assert backends.names() == ["np", "cuda"]
    assert backends.degradation_chain("cuda") == ["np"]
    assert backends.cache_token(True) == "cuda2+np1"
    assert backends.cache_token(False) == "np1"
    assert backends.cache_token(True) != ref_backends.cache_token(True)

    # one cache directory never serves one package's source to the other
    rng = np.random.default_rng(3)
    n, k, m = 8, 5, 4
    A, B = rng.normal(size=(n, k)), rng.normal(size=(k, m))
    ref_ck = ref_compile(gemm_rowscale, cache=str(tmp_path))
    port_ck = compile_kernel(gemm_rowscale, cache=str(tmp_path))
    assert not port_ck.from_cache
    assert "__cuk" in port_ck.source("np")
    # a second port compile does warm-start from its own entry
    warm = compile_kernel(gemm_rowscale, cache=str(tmp_path))
    assert warm.from_cache
    assert "__cuk" in warm.source("np") and "__plk" in ref_ck.source("np")
    C1, C2 = np.zeros((n, m)), np.zeros((n, m))
    ref_ck.call_variant("np", A, B, C1, n, k, m)
    warm.call_variant("np", A, B, C2, n, k, m)
    np.testing.assert_allclose(C2, C1, atol=1e-8, rtol=0)
