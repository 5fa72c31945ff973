"""The device trace's reduction, on rows made by hand."""

import pytest

from perfbench.harness import trace


def test_kernel_names_lose_their_argument_list_only():
    name = ("void (anonymous namespace)::bf16::mma_fwd_kernel<128, 1, 32, 3,"
            " false>(__nv_bfloat16 const*, (anonymous namespace)::bf16::"
            "Layout, int)")
    assert trace.short(name) == ("(anonymous namespace)::bf16::"
                                 "mma_fwd_kernel<128, 1, 32, 3, false>")
    assert trace.short("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT") == \
        "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT"
    assert trace.short("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"


def test_busy_union_gaps_and_labels():
    ms = 1_000_000
    rows = [("k1(int)", True, 0, 4 * ms), ("k2(int)", True, 2 * ms, 5 * ms),
            ("k1(int)", True, 8 * ms, 9 * ms),
            ("cudaMemcpyAsync", False, 5 * ms, 7 * ms)]
    spans = [("engine.step", 0, 8 * ms + ms // 2)]
    out = trace.reduce_rows(rows, spans, (0, 10 * ms))
    assert out["window_s"] == pytest.approx(0.010)
    assert out["busy_s"] == pytest.approx(0.006)
    assert out["kernels"]["k1"] == [2, pytest.approx(0.005)]
    gaps = dict(out["idle_gaps"])
    assert gaps["engine.step/cudaMemcpyAsync"] == pytest.approx(0.003)
    assert gaps["outside spans/host code"] == pytest.approx(0.001)
    n, secs = trace.kernel_time(out, ("k2",))
    assert (n, secs) == (1, pytest.approx(0.003))
