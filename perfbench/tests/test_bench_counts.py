"""The copied arithmetic: model FLOPs and the flash kernels' operations
and bytes, against counts by hand."""

import pytest

from perfbench.harness.bench import Catalog
from perfbench.harness.peaks import bound_s


def model(name):
    return Catalog().config(name)["model"]


def count(name):
    return Catalog().module("counts", name)


def test_stablelm_train_step():
    # matmul parameters: 32 x (4 x 2560^2 + 3 x 2560 x 6912) + 50304 x 2560
    n = 32 * (4 * 2560**2 + 3 * 2560 * 6912) + 50304 * 2560
    assert n == 2_666_332_160
    attn = 3 * 32 * 4 * 80 * 32 * (4096 * 4097 // 2) * 2
    want = 6 * n * 2 * 4096 + attn
    got = count("dense").train_step_flops(model("stablelm_3b"), 2, 4096)
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(1.475e14, rel=2e-3)


def test_olmoe_prefill_of_2130_tokens():
    m = model("olmoe_1b_7b")
    layer = 4 * 2048**2 + 2048 * 64 + 8 * 3 * 2048 * 1024
    attn = 16 * 4 * 128 * 16 * (2130 * 2131 // 2)
    want = 2 * 16 * layer * 2130 + 2 * 50304 * 2048 + attn
    got = count("moe").prefill_flops(m, 2130)
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(4.881e12, rel=1e-3)
    # with logits at every prompt position (which the program does not
    # compute) the count would be the 5.32e12 of a whole forward
    whole = got + 2 * 50304 * 2048 * 2129
    assert whole == pytest.approx(5.32e12, rel=2e-3)


def test_decode_token_counts_its_keys():
    m = model("stablelm_3b")
    c = count("dense")
    assert c.decode_flops(m, 101) - c.decode_flops(m, 100) == \
        32 * 4 * 80 * 32


def test_flash_forward_counts():
    ff = count("flash_fwd")
    assert ff.valid_pairs(4, 4) == 10
    assert ff.valid_pairs(2, 10, offset=3) == 4 + 5
    assert ff.valid_pairs(3, 4, offset=2) == 3 + 4 + 4
    assert ff.valid_pairs(3, 5, causal=False) == 15
    # a prefill of 2048 tokens, 16 heads of 128, into a 4096-key cache:
    # the keys it reaches, not the cache's length
    assert ff.nbytes(1, 2048, 4096, 16, 16, 128) == 2 * 128 * (
        2 * 2048 * 16 + 2 * 2048 * 16)
    assert ff.flops(1, 2048, 2048, 16, 128) == 4 * 128 * 16 * (
        2048 * 2049 // 2)


def test_flash_backward_bound_at_stablelm_training():
    fb = count("flash_bwd")
    # one microbatch row x 32 heads, S = 4096, D = 80
    ops = fb.flops(32, 4096, 80)
    assert ops == 10 * 80 * 32 * (4096 * 4097 // 2)
    assert fb.nbytes(32, 4096, 80) == 2 * 32 * 4096 * 80 * 8
    # the kernel table's stablelm case (64 rows-heads): bound 0.434 ms
    assert bound_s(fb.flops(64, 4096, 80), fb.nbytes(64, 4096, 80)) \
        == pytest.approx(0.434e-3, rel=2e-3)
