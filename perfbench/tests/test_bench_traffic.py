"""The traffic generator, the closed loop and the window's arithmetic."""

import numpy as np
import pytest
import torch

from perfbench.harness import stats, traffic
from perfbench.harness.bench import Catalog

SEED = 2**31 + 12345


def docqa():
    return Catalog().traffic("serve_docqa")


def test_requests_are_deterministic_for_a_seed():
    a = traffic.Requests(docqa(), SEED, 50304)
    b = traffic.Requests(docqa(), SEED, 50304)
    for i in (0, 1, 31, 32, 100):
        assert a.sizes(i) == b.sizes(i)
        np.testing.assert_array_equal(a.prompt(i), b.prompt(i))


def test_every_seed_offers_the_same_sizes_in_another_order():
    t = docqa()
    a = traffic.Requests(t, SEED, 50304)
    b = traffic.Requests(t, SEED + 1, 50304)
    block = t["block"]
    for k in range(3):
        ours = [a.sizes(k * block + j) for j in range(block)]
        theirs = [b.sizes(k * block + j) for j in range(block)]
        assert sorted(ours) == sorted(theirs) == sorted(a.block)
    assert [a.sizes(j) for j in range(block)] != \
        [b.sizes(j) for j in range(block)]


def test_block_sizes_follow_the_mix():
    t = docqa()
    sizes = traffic.block_sizes(t)
    prompts = [p for p, _ in sizes]
    answers = [a for _, a in sizes]
    (plo, phi), (alo, ahi) = t["prompt_tokens"], t["answer_tokens"]
    assert min(prompts) >= plo and max(prompts) <= phi
    assert min(answers) >= alo and max(answers) <= ahi
    assert phi + ahi <= t["max_seq"]
    # the source's medians: 1500 prompt and 13 output tokens
    assert abs(np.median(prompts) - 1500) <= 2
    assert np.median(answers) == 13
    # log-uniform means: (hi - lo) / ln(hi / lo)
    assert abs(np.mean(prompts) - (phi - plo) / np.log(phi / plo)) < 40
    assert abs(np.mean(answers) - (ahi - alo) / np.log(ahi / alo)) < 1.5
    assert len(set(answers)) > 10


def test_batches_are_deterministic_and_differ_by_step():
    t = Catalog().traffic("train_4k")
    t = dict(t, seq_len=16)
    a = traffic.Batches(t, SEED, 500, "cpu", torch)
    b = traffic.Batches(t, SEED, 500, "cpu", torch)
    x, y = a.next(), b.next()
    assert torch.equal(x["tokens"], y["tokens"])
    assert torch.equal(x["labels"][:, :-1], x["tokens"][:, 1:])
    assert not torch.equal(a.next()["tokens"], x["tokens"])


def test_percentile_is_numpys_linear_over_every_sample():
    rng = np.random.default_rng(0)
    xs = rng.exponential(50.0, 517).tolist()
    for q in (50, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)))


def test_a_stall_shows_in_the_tail_and_the_rate():
    # 600 requests of 40 ms; a stall of 1.5 s holds the 40 submitted
    # during it: each waits for the stall's end
    lat = [40.0] * 560 + [40.0 + 1500.0 * (1 - i / 40) for i in range(40)]
    p95 = stats.percentile(lat, 95)
    assert p95 > 300.0
    # medians of chunks of 100 would read 40 ms throughout
    chunks = [float(np.median(lat[i:i + 100])) for i in range(0, 600, 100)]
    assert max(chunks) == 40.0
    # a rate over the window counts the stall's time
    assert stats.rate(600, 30.0 + 1.5) == pytest.approx(600 / 31.5)
    assert np.isnan(stats.rate(0, 0.0))


def tick_batches(seed, ticks=12):
    """Each tick's prefill lengths and decode contexts of the tiny dense
    model's closed loop, on the CPU."""
    from perfbench.harness import program, weights
    from perfbench.harness.trace import DeviceTrace
    from perfbench.kinds.serve import ClosedLoop
    from repro_torch.serve.engine import ServeEngine
    from tiny import MODELS, TRAFFIC

    m, t = MODELS["tiny_dense"], TRAFFIC["tiny_serve"]
    params = weights.as_tree(weights.make({"model": m, "init_std": 0.1},
                                          seed, "cpu"))
    engine = ServeEngine(params, program.arch_config(m),
                         n_slots=t["n_slots"], max_seq=t["max_seq"],
                         device="cpu")
    loop = ClosedLoop(engine, traffic.Requests(t, seed, m["vocab"]),
                      t["clients"], DeviceTrace(torch))
    for _ in range(ticks):
        loop.tick()
    return [(k["prefills"], k["contexts"]) for k in loop.ticks]


def test_closed_loop_tick_batches_are_a_function_of_the_seed():
    a, b = tick_batches(SEED), tick_batches(SEED)
    assert a == b
    assert sum(len(p) for p, _ in a) > 4        # clients came back
    assert tick_batches(SEED + 1) != a
