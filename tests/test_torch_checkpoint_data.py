"""The port's data pipeline, checkpoints and training launcher on the CPU.

* ``repro_torch.data.pipeline`` gives the reference's batches bit for
  bit (tokens, embeddings and the enc-dec source frames, several steps
  and hosts, and through the prefetcher); both are numpy only, so the
  reference's module is imported here directly.
* ``repro_torch.checkpoint.ckpt`` round-trips bfloat16, float32, int8
  and int32 leaves and an ``OptState`` bit for bit, publishes atomically
  (a half-written ``step_N.tmp`` is never listed or restored), keeps the
  last ``keep`` steps, and restores a checkpoint the reference wrote
  (float32 and bfloat16 leaves, its ``{"params", "opt"}`` tree of a smoke
  model): the same leaf keys, the same values.
* ``repro_torch.launch.train.main([... "--smoke", "--device", "cpu"])``
  crashes and resumes: the resumed run's losses are the same bits as an
  uninterrupted run's.
"""

import os

import numpy as np
import pytest
import torch

from repro.data import pipeline as ref_pipeline
from repro_torch.checkpoint import ckpt as C
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer as T
from repro_torch.train import AdamWConfig, init_opt_state
from repro_torch.train.tree import leaves, leaves_with_paths
from torch_reference import run_reference


@pytest.mark.parametrize("kind", ["tokens", "embeds", "encdec"])
def test_pipeline_batches_are_the_references_bit_for_bit(kind):
    kw = {"tokens": {}, "embeds": {"embeds_dim": 16},
          "encdec": {"src_len": 12, "d_model": 16}}[kind]
    for hosts, host in ((1, 0), (2, 1)):
        cfgs = [mod.DataConfig(vocab=503, seq_len=24, global_batch=4,
                               num_hosts=hosts, host_id=host, **kw)
                for mod in (pipeline, ref_pipeline)]
        mine, ref = pipeline.SyntheticTokens(cfgs[0]), \
            ref_pipeline.SyntheticTokens(cfgs[1])
        for step in (0, 1, 7):
            a, b = mine.batch_at(step), ref.batch_at(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k]), (kind, step, k)
    pre = pipeline.make_pipeline(cfgs[0], start_step=3)
    try:
        got = pre.next()
    finally:
        pre.stop()
    for k, v in ref_pipeline.SyntheticTokens(cfgs[1]).batch_at(3).items():
        assert np.array_equal(got[k], v)


def _tree():
    gen = torch.Generator().manual_seed(0)
    return {"w": torch.randn(5, 3, generator=gen).to(torch.bfloat16),
            "b": torch.randn(3, generator=gen),
            "q": torch.randint(-127, 128, (4, 4), generator=gen,
                               dtype=torch.int32).to(torch.int8),
            "n": [torch.arange(6, dtype=torch.int32).reshape(2, 3)]}


def _fresh(tree):
    return {k: [torch.zeros_like(t) for t in v] if isinstance(v, list)
            else torch.zeros_like(v) for k, v in tree.items()}


def test_checkpoint_round_trips_every_dtype_bit_for_bit(tmp_path):
    tree = _tree()
    path = C.save(str(tmp_path), 4, tree, extra={"data_step": 4})
    assert os.path.basename(path) == "step_4"
    got, extra = C.restore(str(tmp_path), 4, _fresh(tree))
    assert extra == {"data_step": 4}
    for a, b in zip(leaves(tree), leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # bfloat16 is stored as its bits, the dtype named in the manifest
    stored = np.load(tmp_path / "step_4" / "w.npy")
    assert stored.dtype == np.uint16


def test_checkpoint_round_trips_an_opt_state(tmp_path):
    cfg = get_smoke_config("stablelm_3b")
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(1))
    for quantize in (False, True):
        opt = init_opt_state(params, AdamWConfig(quantize_moments=quantize))
        opt.step.fill_(7)
        for p in leaves(opt.m)[::2]:
            p.copy_(torch.full_like(p, 3))
        tree = {"params": params, "opt": opt}
        C.save(str(tmp_path), int(quantize), tree)
        like = {"params": _zeros(params),
                "opt": init_opt_state(params, AdamWConfig(
                    quantize_moments=quantize))}
        got, _ = C.restore(str(tmp_path), int(quantize), like)
        assert type(got["opt"]).__name__ == "OptState"
        assert int(got["opt"].step) == 7
        for (pa, a), (pb, b) in zip(leaves_with_paths(tree),
                                    leaves_with_paths(got)):
            assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict) else
            [_zeros(x) for x in v] if isinstance(v, list) else
            torch.zeros_like(v) for k, v in tree.items()}


def test_async_checkpointer_publishes_atomically_and_keeps_the_last(
        tmp_path):
    tree = _tree()
    ck = C.AsyncCheckpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        ck.save_async(step, tree, extra={"data_step": step})
        # the snapshot is taken at the call: later writes do not reach it
        tree["b"].add_(1.0)
    ck.wait()
    assert C.available_steps(str(tmp_path)) == [2, 3]
    # a save cut mid-write leaves step_N.tmp, which is never listed
    os.makedirs(tmp_path / "step_9.tmp")
    assert C.latest_step(str(tmp_path)) == 3
    got, _ = C.restore(str(tmp_path), 3, _fresh(tree))
    assert torch.equal(got["b"], tree["b"] - 1.0)


_REFERENCE_CKPT = """
import dataclasses
import jax
import jax.numpy as jnp
from repro.checkpoint import ckpt as RC
from repro.configs import get_smoke_config
from repro.models import transformer as RT
from repro.train import AdamWConfig, init_opt_state
for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
    cfg = dataclasses.replace(get_smoke_config("stablelm_3b"), dtype=dtype)
    params = RT.init_params(cfg, jax.random.key(0))[0]
    opt = init_opt_state(params, AdamWConfig())
    RC.save(str(inputs["dir"]) + "/" + name, 5, {"params": params,
                                                 "opt": opt},
            extra={"data_step": 5})
    outputs[name + "/embed"] = np.asarray(
        jnp.asarray(params["embed"], jnp.float32))
    outputs[name + "/wq"] = np.asarray(
        jnp.asarray(params["blocks"][0]["attn"]["wq"], jnp.float32))
"""


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_a_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    out = run_reference(_REFERENCE_CKPT,
                        {"dir": np.asarray(str(tmp_path))}, tmp_path)
    cfg = get_smoke_config("stablelm_3b")
    cfg.dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    params, _ = T.init_params(cfg, torch.Generator().manual_seed(0))
    like = {"params": params, "opt": init_opt_state(params, AdamWConfig())}
    got, extra = C.restore(str(tmp_path / dtype), 5, like)
    assert extra == {"data_step": 5}
    assert got["params"]["embed"].dtype == cfg.dtype
    assert np.array_equal(got["params"]["embed"].float().numpy(),
                          out[dtype + "/embed"])
    assert np.array_equal(
        got["params"]["blocks"][0]["attn"]["wq"].float().numpy(),
        out[dtype + "/wq"])
    assert int(got["opt"].step) == 0
    # the leaf keys are the reference's, both ways
    C.save(str(tmp_path / "port"), 5, got)
    ref_keys = set(_manifest(tmp_path / dtype / "step_5"))
    assert set(_manifest(tmp_path / "port" / "step_5")) == ref_keys


def _manifest(path):
    import json
    with open(path / "manifest.json") as f:
        return json.load(f)["leaves"]


def test_train_launcher_crash_and_resume_gives_the_same_bits(tmp_path):
    common = ["--arch", "stablelm_3b", "--smoke", "--batch", "4", "--seq",
              "16", "--device", "cpu", "--log-every", "100"]
    straight = train_mod.main(common + ["--steps", "6"])["losses"]
    ck = str(tmp_path / "ck")
    first = train_mod.main(common + ["--steps", "4", "--ckpt-dir", ck,
                                     "--ckpt-every", "2"])["losses"]
    assert C.available_steps(ck) == [2, 4]
    # 'crash' after step 4: the resume starts at the checkpoint's step
    rest = train_mod.main(common + ["--steps", "2", "--ckpt-dir", ck,
                                    "--ckpt-every", "2"])["losses"]
    assert first == straight[:4]
    assert rest == straight[4:]


def test_train_launcher_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from repro_torch.core.txp import DeviceUnavailable
    with pytest.raises(DeviceUnavailable):
        train_mod.main(["--smoke", "--steps", "1"])
