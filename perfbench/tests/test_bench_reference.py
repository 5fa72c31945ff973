"""The weights' layout is the port's, and the plain reference follows
the port's equations: at a tiny size in float32 on the CPU, the port's
logits and loss equal the reference's."""

import dataclasses

import pytest
import torch

from perfbench.harness import program, weights
from perfbench.reference import dense, layers, moe
from tiny import MODELS

FAMILIES = {"dense": dense, "moe": moe}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_layout_is_the_ports(name):
    from repro_torch.models import transformer as T
    from repro_torch.train.tree import leaves_with_paths

    m = MODELS[name]
    cfg = program.arch_config(m)
    port, _ = T.init_params(cfg, torch.Generator().manual_seed(0))
    ours = weights.make({"model": m, "init_std": 0.02}, 5, "cpu")
    want = {tuple(p): (tuple(t.shape), t.dtype)
            for p, t in leaves_with_paths(port)}
    got = {p: (tuple(t.shape), t.dtype) for p, t in ours.items()}
    assert got == want


@pytest.mark.parametrize("name", sorted(MODELS))
def test_same_seed_same_weights(name):
    cfg = {"model": MODELS[name], "init_std": 0.02}
    a = weights.make(cfg, 2**31 + 9, "cpu")
    b = weights.make(cfg, 2**31 + 9, "cpu")
    c = weights.make(cfg, 2**31 + 10, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[("embed",)], c[("embed",)])
    assert float(a[("embed",)].float().std()) == pytest.approx(0.02, rel=0.05)


def f32(m):
    return dict(m, dtype="float32")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_reference_equals_the_port_in_float32(name):
    from repro_torch.models import transformer as T

    m = f32(MODELS[name])
    cfg = program.arch_config(m)
    w = weights.make({"model": m, "init_std": 0.05}, 3, "cpu")
    params = weights.as_tree(dict(w))
    tokens = torch.randint(0, m["vocab"], (1, 40),
                           generator=torch.Generator().manual_seed(1))
    _, port = T.prefill(params, {"tokens": tokens}, cfg, 64)
    ref = FAMILIES[m["family"]].logits_at(
        layers.named(dict(w)), m, tokens[0], [39])["float32"]
    torch.testing.assert_close(port[:, :m["vocab"]], ref, rtol=1e-4,
                               atol=1e-4)


def test_reference_training_equals_the_port_in_float32():
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_loop

    m = f32(MODELS["tiny_dense"])
    cfg = program.arch_config(m)
    w = weights.make({"model": m, "init_std": 0.05}, 4, "cpu")
    params = weights.as_tree({k: v.clone() for k, v in w.items()})
    opt = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "grad_clip": 1.0}
    gen = torch.Generator().manual_seed(2)
    batches = []
    for _ in range(2):
        ids = torch.randint(0, m["vocab"], (2, 17), generator=gen)
        batches.append({"tokens": ids[:, :-1], "labels": ids[:, 1:]})
    ocfg = opt_mod.AdamWConfig(**opt)
    state = opt_mod.init_opt_state(params, ocfg)
    step = train_loop.make_train_step(cfg, ocfg)
    losses = []
    for b in batches:
        params, state, met = step(params, state, b)
        losses.append(float(met["loss"]))
    ref = dense.train(w, m, batches, opt, m["microbatch"])
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    end = {layers.key(k): v for k, v in weights.make(
        {"model": m, "init_std": 0.05}, 4, "cpu").items()}
    from perfbench.kinds.train import leaf_at
    for path in w:
        moved = float((leaf_at(params, path) - end[layers.key(path)]).norm())
        assert moved == pytest.approx(ref["change"][layers.key(path)],
                                      rel=1e-3, abs=1e-7)


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.125, -448.0, 0.3])
    q = layers.fp8(x)
    assert q[0] == 1.0 and q[2] == 1.125 and q[3] == -448.0
    assert abs(float(q[4]) - 0.3) < 0.3 / 8
